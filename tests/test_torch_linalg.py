"""K1: the port's batched Cholesky factor/solve against the JAX package.

The plain versions (what every CPU tensor runs) are held against the
Pallas TPU kernels run in interpret mode at float32 (1e-5, scaled by
max(1, |ref|): float32 rounding in a different operation order) and
against numpy at float64 (1e-10).  The CUDA kernels themselves run only
on a card: those tests carry the `cuda` marker and skip elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dm_control_tpu.ops import linalg_kernel as jlk
from dm_control_tpu_torch.ops import linalg_kernel as lk


def _spd(rng, b, n, dtype):
  A = rng.randn(b, n, n)
  return (A @ A.transpose(0, 2, 1) + n * np.eye(n)).astype(dtype)


def _scaled_err(x, ref):
  return float((np.abs(x - ref) / np.maximum(1.0, np.abs(ref))).max())


@pytest.mark.parametrize('n', [5, 9, 27])
@pytest.mark.parametrize('b', [3, 130])
def test_plain_matches_pallas_interpret_f32(n, b):
  rng = np.random.RandomState(n * 1000 + b)
  A = _spd(rng, b, n, np.float32)
  rhs = rng.randn(b, n).astype(np.float32)
  L_ref = np.asarray(jlk.cholesky_batched(jnp.asarray(A), interpret=True))
  x_ref = np.asarray(jlk.chol_solve_batched(
      jnp.asarray(A), jnp.asarray(rhs), interpret=True))
  x2_ref = np.asarray(jlk.cho_solve_batched(
      jnp.asarray(L_ref), jnp.asarray(rhs), interpret=True))

  At, bt = torch.from_numpy(A), torch.from_numpy(rhs)
  L = lk.cholesky_plain(At).numpy()
  assert (np.triu(L, 1) == 0).all()
  errs = [_scaled_err(L, L_ref),
          _scaled_err(lk.chol_solve_plain(At, bt).numpy(), x_ref),
          _scaled_err(lk.cho_solve_plain(torch.tensor(L_ref), bt).numpy(),
                      x2_ref)]
  print(f'K1 vs pallas interpret f32 n={n} b={b}: max scaled err '
        f'{max(errs):.2e}')
  assert max(errs) <= 1e-5


@pytest.mark.parametrize('n', [5, 9, 27])
def test_plain_matches_numpy_f64(n):
  rng = np.random.RandomState(n)
  A = _spd(rng, 7, n, np.float64)
  rhs = rng.randn(7, n)
  At, bt = torch.from_numpy(A), torch.from_numpy(rhs)
  ref = np.linalg.solve(A, rhs[..., None])[..., 0]
  L = torch.from_numpy(np.linalg.cholesky(A))
  errs = [_scaled_err(lk.cholesky_plain(At).numpy(), L.numpy()),
          _scaled_err(lk.chol_solve_plain(At, bt).numpy(), ref),
          _scaled_err(lk.cho_solve_plain(L, bt).numpy(), ref)]
  print(f'K1 vs numpy f64 n={n}: max scaled err {max(errs):.2e}')
  assert max(errs) <= 1e-10


def test_wrappers_route_cpu_tensors_to_plain_versions():
  rng = np.random.RandomState(0)
  A = torch.from_numpy(_spd(rng, 4, 6, np.float64))
  b = torch.from_numpy(rng.randn(4, 6))
  lk.reset_launches()
  L = lk.cholesky_batched(A)
  torch.testing.assert_close(L, lk.cholesky_plain(A), rtol=0, atol=0)
  torch.testing.assert_close(lk.cho_solve_batched(L, b),
                             lk.cho_solve_plain(L, b), rtol=0, atol=0)
  torch.testing.assert_close(lk.chol_solve_batched(A, b),
                             lk.chol_solve_plain(A, b), rtol=0, atol=0)
  assert all(v == 0 for v in lk.LAUNCHES.values())


@pytest.mark.parametrize('fn', ['cholesky_batched', 'chol_solve_batched',
                                'cho_solve_batched'])
def test_wrappers_never_run_plain_off_the_cpu(fn):
  """A tensor that is not on the CPU goes to the kernel or raises."""
  a = torch.empty((4, 6, 6), device='meta')
  b = torch.empty((4, 6), device='meta')
  args = (a,) if fn == 'cholesky_batched' else (a, b)
  with pytest.raises(ValueError, match='kernel needs cuda'):
    getattr(lk, fn)(*args)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [9, 27, 56])
def test_kernels_match_plain_on_card(n):
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device; chip_smoke.py runs this check there')
  rng = np.random.RandomState(n)
  A = torch.from_numpy(_spd(rng, 4096, n, np.float32)).cuda()
  b = torch.from_numpy(rng.randn(4096, n).astype(np.float32)).cuda()
  lk.reset_launches()
  L = lk.cholesky_batched(A)
  torch.testing.assert_close(L, lk.cholesky_plain(A), rtol=1e-4, atol=1e-4)
  torch.testing.assert_close(lk.cho_solve_batched(L, b),
                             lk.cho_solve_plain(L, b), rtol=1e-4, atol=1e-4)
  torch.testing.assert_close(lk.chol_solve_batched(A, b),
                             lk.chol_solve_plain(A, b), rtol=1e-4, atol=1e-4)
  assert list(lk.LAUNCHES.values()) == [1, 1, 1]
