"""Batched small-matrix linear algebra for the engine.

The port of `dm_control_tpu/_src/linalg.py`.  The JAX package reaches its
Pallas kernels through `custom_vmap` dispatch; here the batch axis is
explicit, so each entry point is the kernel wrapper itself: CPU tensors
take the plain column-loop version, CUDA tensors the Hopper kernel
(float32, n <= linalg_kernel.MAX_N).
"""

from __future__ import annotations

import torch

from dm_control_tpu_torch.ops import linalg_kernel


def cholesky(a: torch.Tensor) -> torch.Tensor:
  """Lower Cholesky factor of (B, n, n) SPD matrices."""
  return linalg_kernel.cholesky_batched(a)


def cho_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve A x = b given the lower Cholesky factor of A; b is (B, n)."""
  return linalg_kernel.cho_solve_batched(l, b)


def solve_psd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """x = a^-1 b for SPD a, (B, n, n) @ (B, n)."""
  return linalg_kernel.chol_solve_batched(a, b)
