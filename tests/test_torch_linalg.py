"""K1: the port's batched Cholesky factor/solve against the JAX package.

The plain versions (what every CPU tensor runs) are held against the
Pallas TPU kernels run in interpret mode at float32 (1e-5, scaled by
max(1, |ref|): float32 rounding in a different operation order) and
against numpy at float64 (1e-10).  The CUDA kernels themselves run only
on a card: those tests carry the `cuda` marker and skip elsewhere.
"""

import ctypes

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


@pytest.mark.parametrize('n', [3, 5, 9, 27])
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


@pytest.mark.parametrize('n', [3, 5, 9, 27])
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


def test_kernel_limits_match_source():
  src = (lk.build.CSRC / 'linalg_kernel.cu').read_text()
  assert f'constexpr int MAX_N = {lk.MAX_N};' in src
  assert f'constexpr int SMEM_LIMIT = {lk.SMEM_LIMIT};' in src


# n -> (environments per block, threads, dynamic shared bytes) of every
# mode of the K1 kernel, counted by hand: G = 4, 8, 16, 32, 32 lanes for n <= 4, 16, 40, 96; two warps a
# block; per environment n ld + 2 n words, ld = n | 1, padded so that the
# words are G ld mod 32: n=1 3+1, n=3 15+29, n=9 99+5, n=27 783+1, n=56
# 3304+24, n=96 9504+0.
LAUNCH_CONFIGS = {1: (16, 64, 4 * 16 * 4), 3: (16, 64, 4 * 16 * 44),
                  9: (8, 64, 4 * 8 * 104), 27: (4, 64, 4 * 4 * 784),
                  56: (2, 64, 4 * 2 * 3328), 96: (2, 64, 4 * 2 * 9504)}


@pytest.mark.parametrize('n', sorted(LAUNCH_CONFIGS))
def test_launch_config(n):
  """(environments per block, threads, shared bytes) of K1a/K1b/K1c
  against the kernel's carve counted by hand: G lanes per environment, 32 / G
  environments per warp; per environment n rows of odd stride ld = n | 1,
  then y and the reciprocals (2 n words), padded to G * ld words mod 32."""
  envs, threads, smem = lk.launch_config(n)
  group = threads // envs
  assert (envs, threads, smem) == LAUNCH_CONFIGS[n]
  assert group in (1, 2, 4, 8, 16, 32) and envs * group == threads
  assert threads % 32 == 0 and smem <= lk.SMEM_LIMIT == 232448
  ld = n | 1
  words = smem // (4 * envs)
  assert smem == 4 * envs * words and ld % 2 == 1
  assert n * ld + 2 * n <= words < n * ld + 2 * n + 32
  assert words % 32 == group * ld % 32          # environments on new banks


def test_launch_config_raises_where_the_block_cannot_fit():
  """Past MAX_N, or a block shape whose environments exceed one block's
  shared memory, raises before any launch (no plain fallback on a card)."""
  lk.reset_launches()
  for n in (0, lk.MAX_N + 1):
    with pytest.raises(ValueError, match='kernel limit'):
      lk.launch_config(n)
  with pytest.raises(ValueError, match='shared memory'):
    lk.launch_config(lk.MAX_N, group=1)       # 64 matrices of 96 x 96
  with pytest.raises(ValueError, match='block shape'):
    lk.launch_config(9, group=3)
  assert lk.launch_config(lk.MAX_N, group=32, warps=1)[0] == 1
  assert sum(lk.LAUNCHES.values()) == 0


def _c_param_count(name):
  src = (lk.build.CSRC / 'linalg_kernel.cu').read_text()
  head = f'extern "C" int {name}('
  start = src.index(head) + len(head)
  return len(src[start:src.index(')', start)].split(','))


@pytest.mark.parametrize('fn,entry', [
    ('cholesky_batched', 'dmc_cholesky'),
    ('chol_solve_batched', 'dmc_chol_solve'),
    ('cho_solve_batched', 'dmc_cho_solve')])
def test_wrapper_calls_match_c_signatures(fn, entry, monkeypatch):
  """build._SIGNATURES has the C entry's parameter count, and the wrapper
  passes exactly those arguments: pointers, then n, the batch and
  launch_config(n), then the stream.  Run on meta tensors with the library
  and the device check stubbed, so no kernel is built."""
  calls = []

  class Library:
    def __getattr__(self, name):
      return lambda *args: calls.append((name, args)) or 0

  monkeypatch.setattr(lk.build, 'library', Library)
  monkeypatch.setattr(lk, '_check',
                      lambda name, mat, vec=None: (mat.shape[0], mat.shape[-1]))
  monkeypatch.setattr(lk, '_stream', lambda device: 12345)
  B, n = 5, 9
  a = torch.empty((B, n, n), device='meta')
  b = torch.empty((B, n), device='meta')
  getattr(lk, fn)(*((a,) if fn == 'cholesky_batched' else (a, b)))
  [(name, args)] = calls
  sig = lk.build._SIGNATURES[entry]
  assert name == entry and len(args) == len(sig) == _c_param_count(entry)
  ints = [v for v, t in zip(args, sig) if t is ctypes.c_int]
  assert ints == [n, B] + list(lk.launch_config(n)) and args[-1] == 12345
  assert sig[-1] is ctypes.c_void_p
  assert all(t is ctypes.c_void_p for t in sig[:len(sig) - len(ints) - 1])


def _cuda_kernels(fn):
  """CUDA kernels one call of fn() launches, under torch.profiler."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    fn()
    torch.cuda.synchronize()
  return [e.name for e in p.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]


def test_solve_entries_take_the_same_arguments():
  """K1b's and K1c's C entries take (matrix, rhs, x, n, batch, envs,
  threads, smem_bytes, stream), K1a's the same without rhs: one launch
  configuration for every mode of the kernel."""
  sig = lk.build._SIGNATURES
  assert sig['dmc_cho_solve'] == sig['dmc_chol_solve']
  assert sig['dmc_cholesky'] == sig['dmc_chol_solve'][:1] + sig[
      'dmc_chol_solve'][2:]
  src = (lk.build.CSRC / 'linalg_kernel.cu').read_text()
  for entry, mode in (('dmc_cholesky', 'kFactor'),
                      ('dmc_chol_solve', 'kFactorSolve'),
                      ('dmc_cho_solve', 'kSolve')):
    body = src[src.index(f'extern "C" int {entry}('):]
    assert body[:body.index('}')].count(f'launch_k1<{mode}>') == 1


@pytest.mark.cuda
def test_cholesky_batched_is_contiguous_on_card():
  """K1a returns L batch-first and contiguous, 0 above the diagonal."""
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device; chip_smoke.py runs this check there')
  rng = np.random.RandomState(1)
  A = torch.from_numpy(_spd(rng, 37, 9, np.float32)).cuda()
  L = lk.cholesky_batched(A)
  assert L.is_contiguous() and L.shape == A.shape
  assert bool((torch.triu(L, 1) == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize('n', [3, 9, 27, 56, 96])
def test_kernels_match_plain_on_card(n):
  """Each kernel within 1e-4 of its plain version and one CUDA kernel per
  call, the first B - 3 lanes alone and a second launch giving the full
  batch's bits, and K1c on K1a's L giving K1b's bits."""
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
  x = lk.chol_solve_batched(A, b)
  torch.testing.assert_close(x, lk.chol_solve_plain(A, b), rtol=1e-4,
                             atol=1e-4)
  assert list(lk.LAUNCHES.values()) == [1, 1, 1]
  m = 4096 - 3
  assert torch.equal(lk.cholesky_batched(A), L)
  assert torch.equal(lk.cholesky_batched(A[:m]), L[:m])
  assert torch.equal(lk.chol_solve_batched(A, b), x)
  assert torch.equal(lk.chol_solve_batched(A[:m], b[:m]), x[:m])
  xc = lk.cho_solve_batched(L, b)
  assert torch.equal(xc, x)
  assert torch.equal(lk.cho_solve_batched(L, b), xc)
  assert torch.equal(lk.cho_solve_batched(L[:m], b[:m]), xc[:m])
  assert len(_cuda_kernels(lambda: lk.cholesky_batched(A))) == 1
  assert len(_cuda_kernels(lambda: lk.chol_solve_batched(A, b))) == 1
  assert len(_cuda_kernels(lambda: lk.cho_solve_batched(L, b))) == 1
