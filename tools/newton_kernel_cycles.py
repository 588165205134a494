"""Where the Newton kernel's slowest warps spend their cycles, on the card.

Run on a machine with one CUDA device and nvcc, from the root of a
checkout:

    python3 tools/newton_kernel_cycles.py [--nvcc-flag=-prec-div=false ...]

ncu and nsys do not run everywhere, so this builds a copy of
`dm_control_tpu_torch/csrc/newton_kernel.cu` with `clock64()` and
`%globaltimer` reads added at its phase boundaries (into
`dm_control_tpu_torch/_build/cycles/`), runs it on the inputs that
`chip_smoke.py` times (K2: walker-walk's solver inputs at batch 4096
after 40 control steps; K2-ell: 4096 finger-spin lanes in contact),
checks that its outputs equal the uninstrumented kernel's bit for bit,
and prints per Newton iteration of the five slowest warps:

  * h+chol+step: the H build, the Cholesky, the two substitutions, then
    J delta and the step's dot products (each part shown);
  * linesearch: the 12 steps, split per step into the row and contact
    terms (eval) and the two shuffle sums with the alpha update (reduce);
  * accept+eval+grad: the new cost, the accept, the terms and gradient;

then the cycles outside the loop (load, warmstart, final forces), each
warp's wall time and start, and the launch's span, with the card's name,
power limit and SM clock.  `--nvcc-flag` adds a flag to the instrumented
build only (for instance approximate division, to see what the IEEE
divisions cost); the outputs may then differ from the kernel's, which is
reported and not an error.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from dm_control_tpu_torch import suite  # noqa: E402
from dm_control_tpu_torch._src import efc, forward, solver  # noqa: E402
from dm_control_tpu_torch.ops import build  # noqa: E402
from dm_control_tpu_torch.ops import newton_kernel as nk  # noqa: E402
from dm_control_tpu_torch.parallel import BatchedEnv  # noqa: E402

BATCH = 4096
# per warp: total, h+chol+step, ls, ev, start ns, end ns, ls eval, ls reduce,
# H build, Cholesky, substitutions
SLOTS = 11

# (marker in the kernel source, text put before it)
PROBES = [
    ('  if (b >= q.B) return;            // the whole warp: its environment is '
     'past B\n', None),
    ('    build_h(p);\n', '    t_mark = clock64();\n'),
    ('    cholesky(p);\n', '    const long long tc = clock64();\n    c_hb += tc - t_mark;\n'),
    ('    const float d_v = newton_step(p, grad);\n',
     '    const long long td = clock64();\n    c_ch += td - tc;\n'),
    ('    if (lane < nv) p.d[lane] = d_v;\n', '    c_st += clock64() - td;\n'),
    ("    // guarded Newton on phi'(alpha), starting at the full step; this\n",
     '    { const long long t1 = clock64(); c_h += t1 - t_mark; t_mark = t1; }\n'),
    ('      float pf = 0.0f, pw = 0.0f;\n', '      const long long ta = clock64();\n'),
    ('      warp_sum2(&pf, &pw);\n',
     '      const long long tb = clock64();\n      c_lse += tb - ta;\n'),
    ('    // accept if improved\n',
     '    { const long long t1 = clock64(); c_ls += t1 - t_mark; t_mark = t1; }\n'),
    ('    const float grad_norm = scale',
     '    c_ev += clock64() - t_mark;\n'),
]


def instrumented_source() -> str:
  src = (build.CSRC / 'newton_kernel.cu').read_text()

  def put(text, marker, before='', after=''):
    if text.count(marker) != 1:
      raise RuntimeError(f'marker not found once in newton_kernel.cu: {marker!r}')
    return text.replace(marker, before + marker + after)

  src = put(src, '__global__ void __launch_bounds__', before=(
      f'__device__ long long g_cycles[{SLOTS} * {BATCH}];\n'
      '__device__ __forceinline__ long long gtime() {\n'
      '  long long t;\n'
      '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
      '  return t;\n}\n'))
  src = put(src, PROBES[0][0], after=(
      '  const long long g_begin = gtime(), t_begin = clock64();\n'
      '  long long c_h = 0, c_ls = 0, c_ev = 0, c_lse = 0, c_lsr = 0, '
      't_mark = 0, c_hb = 0, c_ch = 0, c_st = 0;\n'))
  for marker, before in PROBES[1:]:
    src = put(src, marker, before=before)
  src = put(src, '      alpha = (alpha_n > lo && alpha_n < hi) ? alpha_n : '
            '0.5f * (lo + hi);\n', after='      c_lsr += clock64() - tb;\n')
  src = put(src, '  if (lane == 0) q.iters_out[b] = it;\n', after=(
      f'  if (lane == 0 && b < {BATCH}) {{\n'
      f'    long long* g = g_cycles + {SLOTS} * b;\n'
      '    g[0] = clock64() - t_begin; g[1] = c_h; g[2] = c_ls; g[3] = c_ev;\n'
      '    g[4] = g_begin; g[5] = gtime(); g[6] = c_lse; g[7] = c_lsr;\n'
      '    g[8] = c_hb; g[9] = c_ch; g[10] = c_st;\n  }\n'))
  return src + ('extern "C" int dmc_cycles(long long* dst, int n) {\n'
                '  return (int)cudaMemcpyFromSymbol(dst, g_cycles, n * '
                'sizeof(long long));\n}\n')


def build_instrumented(extra_flags=(), name='cycles') -> ctypes.CDLL:
  out_dir = build.BUILD_DIR / name
  out_dir.mkdir(parents=True, exist_ok=True)
  src, lib_path = out_dir / 'newton_kernel_cycles.cu', out_dir / 'libcycles.so'
  src.write_text(instrumented_source())
  run = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *extra_flags,
                        '-shared', '-o',
                        str(lib_path), str(src)],
                       capture_output=True, text=True)
  if run.returncode:
    raise RuntimeError(f'nvcc failed:\n{run.stdout}{run.stderr}')
  for line in (run.stdout + run.stderr).splitlines():
    if 'registers' in line or 'spill' in line:
      print('  instrumented: ' + line.strip())
  lib = ctypes.CDLL(str(lib_path))
  lib.dmc_newton_solve.argtypes = list(build._SIGNATURES['dmc_newton_solve'])
  lib.dmc_newton_solve.restype = ctypes.c_int
  lib.dmc_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
  lib.dmc_cycles.restype = ctypes.c_int
  return lib


def inputs(dev, gen):
  """{name: (solver args, layout, solver kwargs)} as chip_smoke.py times."""
  wt = suite.build_task('walker', 'walk')
  m, lay = wt.model, efc.layout(wt.model)
  env = BatchedEnv(wt, BATCH)
  state, _ = env.rollout_fn(40)(env.reset(), gen)
  d = forward.fwd_acceleration(m, forward.actuation(
      m, forward.step1(m, state.data, skipsensor=True)))
  wargs = (d.efc_J, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss,
           d.efc_active.to(torch.float32), d.qacc_smooth, d.qacc_warmstart)
  ft = suite.build_task('finger', 'spin')
  fm, flay = ft.model, efc.layout(ft.model)
  fargs, _ = chip_smoke.finger_solver_inputs(fm, flay, BATCH, gen, dev)

  def kw(model):
    return dict(niter=int(model.opt.iterations), ls_iter=solver.LS_ITERATIONS,
                tol=solver.effective_tol(model.opt.tolerance, torch.float32),
                meaninertia=float(model.stat_meaninertia))
  return {'K2 (walker)': (wargs, lay, kw(m)),
          'K2-ell (finger)': (fargs, flay, kw(fm))}


def report(lib, cases, exact=True):
  """Run the instrumented kernel `lib` on each case and print its cycles."""
  plain_lib = build.library()
  for name, (args, lay, kw) in cases.items():
    ref = nk.newton_solve_batched(*args, lay=lay, return_iters=True, **kw)
    build._lib = lib
    try:
      out = nk.newton_solve_batched(*args, lay=lay, return_iters=True, **kw)
      torch.cuda.synchronize()
    finally:
      build._lib = plain_lib
    same = all(torch.equal(a, b) for a, b in zip(out, ref))
    buf = (ctypes.c_longlong * (SLOTS * BATCH))()
    build.check(lib.dmc_cycles(buf, SLOTS * BATCH), 'dmc_cycles')
    g = torch.tensor(list(buf), dtype=torch.float64).reshape(BATCH, SLOTS)
    iters = out[2].double().cpu()
    t0 = g[:, 4].min()
    print(f'{name}: launch span {(g[:, 5].max() - t0) / 1e3:.2f} us '
          f'(globaltimer), last warp start +{(g[:, 4].max() - t0) / 1e3:.2f} '
          f'us; iterations mean {iters.mean():.3f} max {int(iters.max())}; '
          f'outputs {"equal" if same else "differ from"} the kernel\'s, bit '
          'for bit')
    for i in torch.argsort(g[:, 0], descending=True)[:5].tolist():
      n = max(iters[i].item(), 1.0)
      steps = n * kw['ls_iter']
      print(f'  warp {i}: {int(iters[i])} iterations, {g[i, 0]:.0f} cycles; '
            f'per iteration h+chol+step {g[i, 1] / n:.0f} (H {g[i, 8] / n:.0f}, '
            f'Cholesky {g[i, 9] / n:.0f}, substitutions {g[i, 10] / n:.0f}), '
            f'linesearch {g[i, 2] / n:.0f} (per step eval '
            f'{g[i, 6] / steps:.0f}, reduce {g[i, 7] / steps:.0f}), '
            f'accept+eval+grad {g[i, 3] / n:.0f}; outside the loop '
            f'{g[i, 0] - g[i, 1] - g[i, 2] - g[i, 3]:.0f}; wall '
            f'{(g[i, 5] - g[i, 4]) / 1e3:.2f} us from +{(g[i, 4] - t0) / 1e3:.2f} us')
    sel = iters > 0
    print(f'  mean over the {int(sel.sum())} warps that iterate, per '
          f'iteration: h+chol+step {(g[sel, 1] / iters[sel]).mean():.0f}, '
          f'linesearch {(g[sel, 2] / iters[sel]).mean():.0f}, '
          f'accept+eval+grad {(g[sel, 3] / iters[sel]).mean():.0f}; outside '
          f'the loop, all warps {(g[:, 0] - g[:, 1:4].sum(1)).mean():.0f}')
    if exact and not same:
      raise AssertionError(f'{name}: the instrumented kernel changed the result')


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--nvcc-flag', action='append', default=[],
                      help='extra nvcc flag for the instrumented build')
  flags = parser.parse_args().nvcc_flag
  if not torch.cuda.is_available():
    sys.exit('needs a CUDA device')
  print(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit,clocks.sm,clocks.max.sm',
       '--format=csv,noheader'], capture_output=True, text=True,
      check=True).stdout.strip())
  dev = torch.device('cuda')
  gen = torch.Generator(device=dev)
  gen.manual_seed(0)
  print(f'instrumented build, extra nvcc flags: {flags}')
  report(build_instrumented(flags), inputs(dev, gen), exact=not flags)


if __name__ == '__main__':
  main()
