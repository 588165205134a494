"""Batched small-SPD Cholesky factor / solve: CUDA kernels and plain twins.

The port of `dm_control_tpu/ops/linalg_kernel.py` (K1).  Three entry
points, each with a plain PyTorch version beside it:

  cholesky_batched    (B, n, n) SPD -> lower L          (K1a, factor_m)
  chol_solve_batched  (B, n, n), (B, n) -> A^-1 b       (K1b, euler)
  cho_solve_batched   L (B, n, n), (B, n) -> A^-1 b     (K1c, solve_m)

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel
in `csrc/linalg_kernel.cu` (float32, n <= MAX_N) or raises.  Each reads
the port's batch-first tensors as they are and writes its result
batch-first and contiguous, one kernel launch per call, in the block
shape `launch_config` gives.  On the card cho_solve_batched(
cholesky_batched(a), b) gives chol_solve_batched(a, b)'s bits.

The plain versions follow the kernels' algorithm: a right-looking column
loop with pivot sqrt(max(a_jj, 1e-30)), then forward and back
substitution.
"""

from __future__ import annotations

import functools

import torch

from dm_control_tpu_torch.ops import build

MAX_N = 96
SMEM_LIMIT = 232448      # dynamic shared bytes of a block
_TINY = 1e-30
# Lanes per environment (G) by n, as (largest n, G), and warps per block,
# for every mode of the kernel (factor, fused solve, solve with a given
# factor): on the card the fastest of tools/linalg_kernel_designs.py's
# candidates, or within 5% of it, at n = 3, 9, 27, 56, 96 (PERF.md); the
# bounds between those n are not measured.
GROUPS = ((4, 4), (16, 8), (40, 16), (MAX_N, 32))
WARPS = 2

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


def env_words(n: int, group: int) -> int:
  """4-byte words of one environment in the kernel's shared memory (its
  `env_words`): the matrix with odd row stride ld = n | 1, then y and the
  pivots' reciprocals, padded to G * ld words modulo 32."""
  ld = n | 1
  used = n * ld + 2 * n
  return used + (group * ld - used) % 32


@functools.lru_cache(maxsize=None)
def launch_config(n: int, group: int | None = None,
                  warps: int = WARPS) -> tuple[int, int, int]:
  """(environments per block, threads per block, dynamic shared bytes) of
  the K1 kernel (every mode) for n x n matrices.

  `group` lanes work on one environment (by default GROUPS's choice for
  n), 32 * warps / group environments to a block; the shared memory is
  the kernel's carve (`env_words` per environment; the C entry checks the
  bytes again).  Raises where the block's environments do not fit.
  """
  if not 1 <= n <= MAX_N:
    raise ValueError(f'n={n} outside the kernel limit 1..{MAX_N}')
  if group is None:
    group = next(g for top, g in GROUPS if n <= top)
  if group not in (1, 2, 4, 8, 16, 32) or warps not in (1, 2, 4, 8, 16, 32):
    raise ValueError(f'group {group} / warps {warps}: no such block shape')
  envs = 32 * warps // group
  smem = 4 * envs * env_words(n, group)
  if smem > SMEM_LIMIT:
    raise ValueError(
        f'{envs} environments of n={n} need {smem} bytes of shared memory, '
        f'over the {SMEM_LIMIT} a block has')
  return envs, 32 * warps, smem


def _stream(device: torch.device) -> int:
  """The current CUDA stream's raw handle on `device`, read without
  building a torch.cuda.Stream object (a wrapper call is host-bound)."""
  return torch._C._cuda_getCurrentRawStream(device.index)


def cholesky_batched(a: torch.Tensor) -> torch.Tensor:
  """(B, n, n) SPD -> lower Cholesky factor (B, n, n), 0 above the
  diagonal."""
  if a.device.type == 'cpu':
    return cholesky_plain(a)
  B, n = _check('cholesky_batched', a)
  a = a.contiguous()
  l = torch.empty_like(a)
  build.check(build.library().dmc_cholesky(
      a.data_ptr(), l.data_ptr(), n, B, *launch_config(n),
      _stream(a.device)), 'dmc_cholesky')
  LAUNCHES['cholesky_batched'] += 1
  return l


def chol_solve_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve a @ x = b for (B, n, n) SPD a, (B, n) b (fused factor+solve)."""
  if a.device.type == 'cpu':
    return chol_solve_plain(a, b)
  B, n = _check('chol_solve_batched', a, b)
  a, b = a.contiguous(), b.contiguous()
  x = torch.empty_like(b)
  build.check(build.library().dmc_chol_solve(
      a.data_ptr(), b.data_ptr(), x.data_ptr(), n, B, *launch_config(n),
      _stream(a.device)), 'dmc_chol_solve')
  LAUNCHES['chol_solve_batched'] += 1
  return x


def cho_solve_batched(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve L L^T x = b given lower L (B, n, n) (its upper triangle is not
  read), b (B, n)."""
  if l.device.type == 'cpu':
    return cho_solve_plain(l, b)
  B, n = _check('cho_solve_batched', l, b)
  l, b = l.contiguous(), b.contiguous()
  x = torch.empty_like(b)
  build.check(build.library().dmc_cho_solve(
      l.data_ptr(), b.data_ptr(), x.data_ptr(), n, B, *launch_config(n),
      _stream(l.device)), 'dmc_cho_solve')
  LAUNCHES['cho_solve_batched'] += 1
  return x
