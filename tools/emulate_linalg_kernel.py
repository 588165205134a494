"""Rehearse the K1 kernel's lane groups on the CPU, where there is no nvcc.

    python3 tools/emulate_linalg_kernel.py [--batch 128]

Compiles the device code of `dm_control_tpu_torch/csrc/linalg_kernel.cu`
with g++ through `emulate_newton_kernel.py`'s shim (each lane a host
thread, `std::barrier`s for `__syncwarp`/`__syncthreads`, shuffles through
a buffer; shared memory starts filled with NaN), adding the `width` form
of `__shfl_sync` that the groups of G lanes use.

For every n of the port's shapes and more (1 to MAX_N = 96) and every
group size G whose block fits, it runs the emulated factor (K1a), fused
solve (K1b) and solve with a given factor (K1c, on K1a's L) on SPD
matrices made from a seed and holds them against `cholesky_plain` /
`chol_solve_plain` / `cho_solve_plain` (1e-4 scaled by max(1, |ref|), as
`chip_smoke.py`); L (batch-first) must be exactly 0 above the diagonal and
must not change when A's upper triangle is NaN, nor K1c's x when L's is;
K1c on K1a's L must give K1b's bits; the first B - 3 lanes alone and a
repeated launch must give the full batch's bits.
The CPU's float32 arithmetic (no FMA contraction) is not the card's: this
checks the kernel's logic, not its rounding or its speed.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dm_control_tpu_torch.ops import build  # noqa: E402
from dm_control_tpu_torch.ops import linalg_kernel as lk  # noqa: E402
from emulate_newton_kernel import SHIM  # noqa: E402

SHIM_K1 = r'''
static inline float __shfl_sync(unsigned, float v, int s, int width) {
  const int lane = threadIdx.x & 31;
  return exchange(v, (lane & ~(width - 1)) | (s & (width - 1)));
}
'''

LAUNCHER = r'''
extern "C" int emu_k1(int mode, const float* a, const float* rhs, float* out,
                      int n, int batch, int envs, int threads,
                      int smem_bytes) {
  const int group = threads / envs;
  if (threads % 32 || threads % envs || (envs & (envs - 1)) ||
      4LL * envs * env_words(n, group) != smem_bytes)
    return 1;
  blockDim.x = threads;
  std::vector<float> shared(smem_bytes / 4);
  for (unsigned blk = 0; blk < (unsigned)((batch + envs - 1) / envs); ++blk) {
    for (float& v : shared) v = NAN;
    g_smem = shared.data();
    std::barrier<> block(threads);
    g_block = &block;
    std::vector<Warp> ws(threads / 32);
    for (auto& w : ws) w.bar = new std::barrier<>(32);
    g_warps = &ws;
    std::vector<std::thread> lanes;
    for (int t = 0; t < threads; ++t)
      lanes.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = blk;
        if (mode == kFactor) k1_kernel<kFactor>(a, rhs, out, n, batch, envs);
        else if (mode == kFactorSolve)
          k1_kernel<kFactorSolve>(a, rhs, out, n, batch, envs);
        else k1_kernel<kSolve>(a, rhs, out, n, batch, envs);
      });
    for (auto& t : lanes) t.join();
    for (auto& w : ws) delete w.bar;
  }
  return 0;
}
'''

SIZES = (1, 2, 3, 5, 8, 9, 16, 27, 33, 56, 96)


def compile_emulation(out_dir: str) -> ctypes.CDLL:
  src = (build.CSRC / 'linalg_kernel.cu').read_text()
  body = src[src.index('namespace {'):src.index('}  // namespace')]
  marker = 'extern __shared__ float smem[];'
  if body.count(marker) != 1:
    raise RuntimeError(f'{marker!r} not found once in the kernel')
  body = body.replace(marker, 'float* smem = g_smem;')
  cpp = os.path.join(out_dir, 'linalg_emu.cpp')
  lib = os.path.join(out_dir, 'liblinalg_emu.so')
  with open(cpp, 'w') as f:
    f.write(SHIM + SHIM_K1 + body + '}  // namespace\n' + LAUNCHER)
  subprocess.run(['g++', '-std=c++20', '-O1', '-fPIC', '-shared', '-pthread',
                  '-Wno-unknown-pragmas', '-o', lib, cpp], check=True)
  emu = ctypes.CDLL(lib)
  P, I = ctypes.c_void_p, ctypes.c_int
  emu.emu_k1.argtypes = [I, P, P, P] + [I] * 5
  emu.emu_k1.restype = ctypes.c_int
  return emu


FACTOR, FACTOR_SOLVE, SOLVE = 0, 1, 2     # the kernel's Mode


def emulate(emu, mode, a, b, config):
  """K1a (b None), K1b or K1c (a the factor) on CPU float32 tensors, in the
  block shape `config` = (envs, threads, smem bytes)."""
  B, n, _ = a.shape
  a = a.contiguous()
  out = torch.empty_like(a) if b is None else torch.empty_like(b)
  err = emu.emu_k1(mode, a.data_ptr(),
                   None if b is None else b.contiguous().data_ptr(),
                   out.data_ptr(), n, B, *config)
  assert err == 0, 'shared-memory size disagrees with the kernel'
  return out


def scaled_err(x, ref):
  return float(((x - ref).abs() / ref.abs().clamp(min=1.0)).max())


def check(emu, n, B, group, rng):
  config = lk.launch_config(n, group)
  a = rng.randn(B, n, n)
  A = torch.from_numpy((a @ a.transpose(0, 2, 1) + n * np.eye(n))
                       .astype(np.float32))
  b = torch.from_numpy(rng.randn(B, n).astype(np.float32))
  L = emulate(emu, FACTOR, A, None, config)
  x = emulate(emu, FACTOR_SOLVE, A, b, config)
  xc = emulate(emu, SOLVE, L, b, config)
  errs = (scaled_err(L, lk.cholesky_plain(A)),
          scaled_err(x, lk.chol_solve_plain(A, b)),
          scaled_err(xc, lk.cho_solve_plain(L, b)))
  assert max(errs) <= 1e-4, (n, group, errs)
  assert torch.equal(xc, x), (n, group, 'K1c on K1a\'s L is not K1b')
  assert bool((torch.triu(L, 1) == 0).all()), (n, group, 'upper not 0')
  upper = torch.ones(n, n).triu(1).bool()
  assert torch.equal(emulate(emu, FACTOR, A.masked_fill(upper, float('nan')),
                             None, config), L), (
      n, group, 'L depends on the upper triangle')
  assert torch.equal(emulate(emu, SOLVE, L.masked_fill(upper, float('nan')),
                             b, config), xc), (
      n, group, 'K1c depends on the upper triangle')
  m = B - 3
  for mode, out, mat, bb in ((FACTOR, L, A, None), (FACTOR_SOLVE, x, A, b),
                             (SOLVE, xc, L, b)):
    again = emulate(emu, mode, mat, bb, config)
    part = emulate(emu, mode, mat[:m], None if bb is None else bb[:m], config)
    assert torch.equal(out, again) and torch.equal(out[:m], part), (
        n, group, mode, 'bits')
  print(f'n={n:2d} G={group:2d} (envs, threads, smem) {config}: max scaled '
        f'err L {errs[0]:.2e} x {errs[1]:.2e} K1c {errs[2]:.2e}; K1c on L '
        f'gives K1b\'s bits; upper triangles unread; {m} lanes alone and a '
        f'repeat give the same bits')


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--batch', type=int, default=128)
  B = parser.parse_args().batch
  rng = np.random.RandomState(0)
  with tempfile.TemporaryDirectory() as tmp:
    emu = compile_emulation(tmp)
    for n in SIZES:
      for group in (1, 2, 4, 8, 16, 32):
        try:
          lk.launch_config(n, group)
        except ValueError:
          continue                       # the block does not fit
        check(emu, n, B, group, rng)
  print('emulation: every check passed (CPU; no device number)')


if __name__ == '__main__':
  main()
