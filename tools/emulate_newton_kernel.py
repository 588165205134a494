"""Rehearse the Newton kernel's warp logic on the CPU, where there is no nvcc.

    python3 tools/emulate_newton_kernel.py [--batch 64] [--wide-batch 8]

Compiles the device code of `dm_control_tpu_torch/csrc/newton_kernel.cu`
with g++ (C++20), the CUDA keywords defined away: each lane of a warp is a
host thread, `__syncwarp`/`__syncthreads` are `std::barrier`s, and
`__shfl_*_sync`/`__ballot_sync` exchange values through a buffer between
two barrier phases.  Shared memory starts filled with NaN.  A missed
`__syncwarp` or a shuffle that not every lane reaches then hangs or
disagrees here rather than on the card.

It runs the emulated kernel on finger-spin inputs in contact and on
walker-walk inputs after 40 control steps (the port on the CPU, float32),
and holds each against the plain float32 and float64 solves with
`chip_smoke.py`'s gates, converged and after one Newton iteration; the
first B - 3 lanes alone and a repeated launch must give the same bits.
Then again with every row active (walker: more than 32 live rows on a
warp; finger: a row and a contact on one lane), after one Newton
iteration without a line search only: there, contacts far from touching
have curvatures near 1e19, and the reference line search's strict
bracket test decides by rounding on which side of the kink alpha ends
(plain float32 and float64 disagree the same way).
Then the two-dofs-per-lane family (nv > 32, J read from device memory)
on humanoid_CMU's layout (nv 62, nefc 880) at `chip_smoke.impact_states`
(humanoids lying on or pressed into the floor), `--wide-batch` lanes.
Last, the kernel's C = 6 instantiation (elliptic contacts of condim 3, 4
and 6 in one layout) on the cone model (`chip_smoke.cones_xml`) at
`chip_smoke.cone_states`: one copy (nv 18, one dof per lane) and two
(nv 36, two dofs per lane), `--batch` lanes.
The CPU's float32 arithmetic (no FMA contraction) is not the card's: this
checks the kernel's logic, not its rounding or its speed.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from dm_control_tpu_torch import suite  # noqa: E402
from dm_control_tpu_torch._src import efc, forward, solver  # noqa: E402
from dm_control_tpu_torch.ops import build  # noqa: E402
from dm_control_tpu_torch.ops import newton_kernel as nk  # noqa: E402
from dm_control_tpu_torch.parallel import BatchedEnv  # noqa: E402

SHIM = r'''
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
using std::min;
struct alignas(16) float4 { float x, y, z, w; };
struct Dim { unsigned x; };
thread_local Dim threadIdx, blockIdx;
Dim blockDim;
float* g_smem;
struct Warp { std::barrier<>* bar; float buf[32]; };
std::vector<Warp>* g_warps;
std::barrier<>* g_block;
static inline Warp& warp_of() { return (*g_warps)[threadIdx.x >> 5]; }
static inline void __syncwarp() { warp_of().bar->arrive_and_wait(); }
static inline void __syncthreads() { g_block->arrive_and_wait(); }
static inline float exchange(float v, int src) {
  Warp& w = warp_of();
  w.bar->arrive_and_wait();
  w.buf[threadIdx.x & 31] = v;
  w.bar->arrive_and_wait();
  return w.buf[src];
}
static inline float __shfl_xor_sync(unsigned, float v, int o) {
  return exchange(v, (threadIdx.x & 31) ^ o);
}
static inline float __shfl_sync(unsigned, float v, int s) { return exchange(v, s); }
static inline int __popc(unsigned m) { return __builtin_popcount(m); }
static inline unsigned __ballot_sync(unsigned, bool p) {
  exchange(p ? 1.0f : 0.0f, 0);
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (warp_of().buf[i] != 0.0f ? 1u : 0u) << i;
  return m;
}
'''

LAUNCHER = r'''
extern "C" int emu_newton(const float* J, const float* M, const float* aref,
    const float* D, const float* fl, const float* active, const float* a,
    const float* warm, const int* types, const int* ell_rows,
    const int* ell_k, const float* ell_mu, const float* s_row, float* x_out,
    float* f_out, int* iters_out, int nefc, int nv, int ncg, int cmax,
    int batch, int niter, int ls_iter, float tol, float scale, int warps,
    int smem_bytes) {
  Problem q{J, M, aref, D, fl, active, a, warm, types, ell_rows, ell_k,
            ell_mu, s_row, x_out, f_out, iters_out, nefc, nv, ncg,
            (long long)batch};
  const long long words = block_words(nefc, ncg, cmax)
                          + (long long)warps * warp_words(nefc, nv, ncg, cmax);
  if (4 * words != smem_bytes) return 1;
  blockDim.x = warps * 32;
  std::vector<float> shared(words);
  for (unsigned blk = 0; blk < (unsigned)((batch + warps - 1) / warps); ++blk) {
    for (float& v : shared) v = NAN;
    g_smem = shared.data();
    std::barrier<> block(warps * 32);
    g_block = &block;
    std::vector<Warp> ws(warps);
    for (int w = 0; w < warps; ++w) ws[w].bar = new std::barrier<>(32);
    g_warps = &ws;
    std::vector<std::thread> lanes;
    for (int t = 0; t < warps * 32; ++t)
      lanes.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = blk;
        if (cmax == 3) {
          if (nv <= 32) newton_kernel<1, 3>(q, niter, ls_iter, tol, scale);
          else newton_kernel<2, 3>(q, niter, ls_iter, tol, scale);
        } else {
          if (nv <= 32) newton_kernel<1, 6>(q, niter, ls_iter, tol, scale);
          else newton_kernel<2, 6>(q, niter, ls_iter, tol, scale);
        }
      });
    for (auto& t : lanes) t.join();
    for (auto& w : ws) delete w.bar;
  }
  return 0;
}
'''


def compile_emulation(out_dir: str) -> ctypes.CDLL:
  src = (build.CSRC / 'newton_kernel.cu').read_text()
  body = src[src.index('namespace {'):src.index('}  // namespace')]
  marker = 'extern __shared__ float smem[];'
  if body.count(marker) != 1:
    raise RuntimeError(f'{marker!r} not found once in the kernel')
  body = body.replace(marker, 'float* smem = g_smem;')
  cpp = os.path.join(out_dir, 'newton_emu.cpp')
  lib = os.path.join(out_dir, 'libnewton_emu.so')
  with open(cpp, 'w') as f:
    f.write(SHIM + body + '}  // namespace\n' + LAUNCHER)
  subprocess.run(['g++', '-std=c++20', '-O1', '-fPIC', '-shared', '-pthread',
                  '-Wno-unknown-pragmas', '-o', lib, cpp], check=True)
  emu = ctypes.CDLL(lib)
  P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
  emu.emu_newton.argtypes = [P] * 16 + [I] * 7 + [F, F, I, I]
  emu.emu_newton.restype = ctypes.c_int
  return emu


def emulate(emu, args, lay, niter, ls_iter, tol, meaninertia):
  """The kernel wrapper's marshalling, on CPU tensors, into the emulation."""
  B, nefc, nv = args[0].shape
  ins = [t.contiguous() for t in args]
  cones = nk._cones_on(lay, 'cpu') if lay.ell_groups else None
  ncg = cones[0].shape[0] if cones else 0
  cmax = nk.cone_width(lay)
  warps, smem = nk.launch_config(nefc, nv, ncg, cmax)
  x, f = torch.empty(B, nv), torch.empty(B, nefc)
  iters = torch.empty(B, dtype=torch.int32)
  ptrs = [t.data_ptr() for t in cones] if cones else [None] * 4
  err = emu.emu_newton(
      *[t.data_ptr() for t in ins], nk._types_on(lay, 'cpu').data_ptr(),
      *ptrs, x.data_ptr(), f.data_ptr(), iters.data_ptr(), nefc, nv, ncg,
      cmax, B, niter, ls_iter, tol, 1.0 / (max(meaninertia, 1e-12) * nv),
      warps, smem)
  assert err == 0, 'shared-memory size disagrees with the kernel'
  return x, f, iters


def check(emu, name, args, lay, kw, converged=True, one_gates=cs.ell_gates):
  plain = dict(types=lay.types, ell_groups=lay.ell_groups)
  tol64 = dict(tol=solver.effective_tol(1e-8, torch.float64))
  if not converged:
    kw = dict(kw, niter=1, ls_iter=0)
  x, f, iters = emulate(emu, args, lay, **kw)
  x_p, _, it_p = nk.newton_solve_plain(*args, **plain, return_iters=True, **kw)
  x_64, _ = nk.newton_solve_plain(*[a.double() for a in args], **plain,
                                  **dict(kw, **tol64))
  print(f'{name}: iterations mean {iters.float().mean():.2f} max '
        f'{int(iters.max())} (plain float32 {it_p.float().mean():.2f}, '
        f'{int(it_p.max())}); live rows per lane mean '
        f'{(args[5] > 0).sum(1).float().mean():.2f}')
  cs.ell_gates(f'{name} emulated', x, x_p, x_64)
  n = x.shape[0] - 3
  part, again = emulate(emu, [a[:n] for a in args], lay, **kw), emulate(
      emu, args, lay, **kw)
  for u, v, w in zip((x, f, iters), part, again):
    assert torch.equal(u[:n], v) and torch.equal(u, w), f'{name}: bits'
  print(f'{name}: the first {n} lanes alone and a repeat give the same bits')
  if not converged:
    return
  one = {}
  for ls in (0, 1):
    kw1 = dict(kw, niter=1, ls_iter=ls)
    one[ls] = (emulate(emu, args, lay, **kw1)[0],
               nk.newton_solve_plain(*args, **plain, **kw1)[0],
               nk.newton_solve_plain(*[a.double() for a in args], **plain,
                                     **dict(kw1, **tol64))[0])
  off = cs.lane_scaled_err(one[1][2], one[0][2]).amax(dim=1) > 1e-3
  one_gates(f'{name} emulated, one iteration, no line search,', *one[0])
  one_gates(f'{name} emulated, one iteration, one line-search step, '
            'alpha off 1,', *(t[off] for t in one[1]))


def solver_kw(m):
  return dict(niter=int(m.opt.iterations), ls_iter=solver.LS_ITERATIONS,
              tol=solver.effective_tol(m.opt.tolerance, torch.float32),
              meaninertia=float(m.stat_meaninertia))


def cone_args(copies, B):
  """The cone model's float32 solver inputs on the CPU at
  `chip_smoke.cone_states` (generator SLICE11_SEED)."""
  import numpy as np
  from dm_control_tpu_torch._src import engine
  m = engine.load_model_from_string(cs.cones_xml(copies), device='cpu')
  q, v = cs.cone_states(m, B, np.random.RandomState(cs.SLICE11_SEED))
  d = forward.make_data(m, B, torch.float32, 'cpu').replace(
      qpos=torch.tensor(q, dtype=torch.float32),
      qvel=torch.tensor(v, dtype=torch.float32))
  d = forward.fwd_acceleration(m, forward.actuation(
      m, forward.step1(m, d, skipsensor=True)))
  args = [d.efc_J, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss,
          d.efc_active.to(torch.float32), d.qacc_smooth, d.qacc_warmstart]
  return m, efc.layout(m), args


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--batch', type=int, default=64)
  parser.add_argument('--wide-batch', type=int, default=8)
  args = parser.parse_args()
  B = args.batch
  with tempfile.TemporaryDirectory() as tmp:
    emu = compile_emulation(tmp)
    gen = torch.Generator()
    gen.manual_seed(0)
    ft = suite.build_task('finger', 'spin', device='cpu')
    fm, flay = ft.model, efc.layout(ft.model)
    fargs, _ = cs.finger_solver_inputs(fm, flay, B, gen, 'cpu')
    check(emu, 'finger', fargs, flay, solver_kw(fm))
    all_on = list(fargs)
    all_on[5] = torch.ones_like(all_on[5])
    check(emu, 'finger, every row active, one iteration, no line search,',
          all_on, flay, solver_kw(fm), converged=False)
    wt = suite.build_task('walker', 'walk', device='cpu')
    m, lay = wt.model, efc.layout(wt.model)
    env = BatchedEnv(wt, B)
    state, _ = env.rollout_fn(40)(env.reset(), gen)
    d = forward.fwd_acceleration(m, forward.actuation(
        m, forward.step1(m, state.data, skipsensor=True)))
    wargs = [d.efc_J, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss,
             d.efc_active.to(torch.float32), d.qacc_smooth, d.qacc_warmstart]
    check(emu, 'walker', wargs, lay, solver_kw(m))
    wargs[5] = torch.ones_like(wargs[5])
    check(emu, 'walker, every row active, one iteration, no line search,',
          wargs, lay, solver_kw(m), converged=False)
    ct = suite.build_task('humanoid_CMU', 'run', device='cpu')
    cm, clay = ct.model, efc.layout(ct.model)
    d = cs.impact_states('humanoid_CMU-run', cm, args.wide_batch, gen, 'cpu')
    d = forward.fwd_acceleration(cm, forward.actuation(
        cm, forward.step1(cm, d, skipsensor=True)))
    cargs = [d.efc_J, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss,
             d.efc_active.to(torch.float32), d.qacc_smooth, d.qacc_warmstart]
    check(emu, 'humanoid_CMU (two dofs per lane)', cargs, clay, solver_kw(cm),
          one_gates=cs.float32_gates)
    for copies in (1, 2):
      km, klay, kargs = cone_args(copies, B)
      assert nk.cone_width(klay) == 6
      check(emu, f'cone model x{copies} (C = 6, nv {km.nv})', kargs, klay,
            solver_kw(km))
  print('emulation: every check passed (CPU; no device number)')


if __name__ == '__main__':
  main()
