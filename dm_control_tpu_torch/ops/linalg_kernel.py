"""Batched small-SPD Cholesky factor / solve: CUDA kernels and plain twins.

The port of `dm_control_tpu/ops/linalg_kernel.py` (K1).  Three entry
points, each with a plain PyTorch version beside it:

  cholesky_batched    (B, n, n) SPD -> lower L          (K1a, factor_m)
  chol_solve_batched  (B, n, n), (B, n) -> A^-1 b       (K1b, euler)
  cho_solve_batched   L (B, n, n), (B, n) -> A^-1 b     (K1c, solve_m)

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel
in `csrc/linalg_kernel.cu` (float32, n <= MAX_N) or raises.  The wrapper
transposes to the batch-last (n, n, B) layout the kernel reads, exactly
as the TPU wrapper did, and returns a batch-first view.

The plain versions follow the kernels' algorithm: a right-looking column
loop with pivot sqrt(max(a_jj, 1e-30)), then forward and back
substitution.
"""

from __future__ import annotations

import torch

from dm_control_tpu_torch.ops import build

MAX_N = 96
_TINY = 1e-30

# launches of each kernel since the last reset_launches() (plain-version
# calls do not count)
LAUNCHES = {'cholesky_batched': 0, 'chol_solve_batched': 0,
            'cho_solve_batched': 0}


def reset_launches() -> None:
  for k in LAUNCHES:
    LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions (batch-first, any float dtype).
# ---------------------------------------------------------------------------


def cholesky_plain(a: torch.Tensor) -> torch.Tensor:
  """Column-loop lower Cholesky of (B, n, n)."""
  n = a.shape[-1]
  A = a.clone()
  L = torch.zeros_like(a)
  for j in range(n):
    pivot = torch.sqrt(torch.clamp(A[:, j, j], min=_TINY))
    col = A[:, j + 1:, j] / pivot[:, None]
    L[:, j, j] = pivot
    L[:, j + 1:, j] = col
    A[:, j + 1:, j + 1:] -= col[:, :, None] * col[:, None, :]
  return L


def cho_solve_plain(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """L L^T x = b for lower L (B, n, n), b (B, n)."""
  n = l.shape[-1]
  y = b.clone()
  for j in range(n):
    yj = y[:, j] / l[:, j, j]
    y[:, j + 1:] -= l[:, j + 1:, j] * yj[:, None]
    y[:, j] = yj
  for j in reversed(range(n)):
    xj = y[:, j] / l[:, j, j]
    y[:, :j] -= l[:, j, :j] * xj[:, None]
    y[:, j] = xj
  return y


def chol_solve_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """a x = b for SPD a (B, n, n), b (B, n): factor then substitute."""
  return cho_solve_plain(cholesky_plain(a), b)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _check(name: str, mat: torch.Tensor, vec: torch.Tensor | None = None):
  if mat.device.type != 'cuda':
    raise ValueError(f'{name}: tensor on {mat.device}, kernel needs cuda')
  if mat.dtype != torch.float32:
    raise TypeError(f'{name}: kernel takes float32, got {mat.dtype}')
  if mat.dim() != 3 or mat.shape[1] != mat.shape[2]:
    raise ValueError(f'{name}: expected (B, n, n), got {tuple(mat.shape)}')
  B, n, _ = mat.shape
  if not 1 <= n <= MAX_N:
    raise ValueError(f'{name}: n={n} outside the kernel limit 1..{MAX_N}')
  if not 1 <= B < 2 ** 31:
    raise ValueError(f'{name}: batch {B} outside the kernel limit')
  if vec is not None:
    if vec.device != mat.device or vec.dtype != torch.float32:
      raise TypeError(f'{name}: rhs must be float32 on {mat.device}')
    if tuple(vec.shape) != (B, n):
      raise ValueError(f'{name}: rhs {tuple(vec.shape)} != {(B, n)}')
  return B, n


def _batch_last(x: torch.Tensor) -> torch.Tensor:
  out = x.permute(*range(1, x.dim()), 0).contiguous()
  assert out.is_contiguous()
  return out


def _stream() -> int:
  return torch.cuda.current_stream().cuda_stream


def cholesky_batched(a: torch.Tensor) -> torch.Tensor:
  """(B, n, n) SPD -> lower Cholesky factor (B, n, n)."""
  if a.device.type == 'cpu':
    return cholesky_plain(a)
  B, n = _check('cholesky_batched', a)
  at = _batch_last(a)
  lt = torch.empty_like(at)
  lib = build.library()
  build.check(lib.dmc_cholesky(at.data_ptr(), lt.data_ptr(), n, B, _stream()),
              'dmc_cholesky')
  LAUNCHES['cholesky_batched'] += 1
  return lt.permute(2, 0, 1)


def chol_solve_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve a @ x = b for (B, n, n) SPD a, (B, n) b (fused factor+solve)."""
  if a.device.type == 'cpu':
    return chol_solve_plain(a, b)
  B, n = _check('chol_solve_batched', a, b)
  at, bt = _batch_last(a), _batch_last(b)
  lt = torch.empty_like(at)
  xt = torch.empty_like(bt)
  lib = build.library()
  build.check(lib.dmc_chol_solve(at.data_ptr(), bt.data_ptr(), lt.data_ptr(),
                                 xt.data_ptr(), n, B, _stream()),
              'dmc_chol_solve')
  LAUNCHES['chol_solve_batched'] += 1
  return xt.permute(1, 0)


def cho_solve_batched(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve L L^T x = b given lower L (B, n, n), b (B, n)."""
  if l.device.type == 'cpu':
    return cho_solve_plain(l, b)
  B, n = _check('cho_solve_batched', l, b)
  lt, bt = _batch_last(l), _batch_last(b)
  xt = torch.empty_like(bt)
  lib = build.library()
  build.check(lib.dmc_cho_solve(lt.data_ptr(), bt.data_ptr(), xt.data_ptr(),
                                n, B, _stream()),
              'dmc_cho_solve')
  LAUNCHES['cho_solve_batched'] += 1
  return xt.permute(1, 0)
