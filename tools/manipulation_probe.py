"""Chip_smoke.py's phase manipulation, task by task, without its asserts:
where the Newton kernel's and the plain solves stop on each task's
solver inputs, and the reference gate's verdicts.

    python3 tools/manipulation_probe.py [--tasks place_cradle_features,...]
        [--dump]

Run on a machine with one CUDA device, from the root of a checkout.  For
each task (of `chip_smoke.MANIPULATION_TASKS`) it makes the states the
phase makes (the task's BatchedEnvironment at chip_smoke.BATCH lanes,
reset with the phase's seed, one control step under the phase's
controls) and prints the step's seconds; then it takes the solver inputs
of those states as `chip_smoke.k2_task_check` does and solves them with
the kernel, the plain float32 solve and the plain float64 one, and
prints each float32 solve's lane-scaled error against the other and
against float64 (mean, max, lanes over 1e-3) and, for the lanes over
1e-3, how far its cost stands above the float64 optimum's in units of
EPS32 x scale (`chip_smoke.solve_cost`), with the iteration counts; then
it runs `chip_smoke.reference_gate` on REF_LANES lanes and prints its
verdict.  With `--dump` it writes the gated lanes' states and controls to
chiprun_out/reference_lanes_manipulation-<task>.npz, which `python3
tools/reference_step_cpu.py --tasks manipulation:<task> --states FILE`
replays on the CPU through the port and the JAX package.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dm_control_tpu_torch._src import efc  # noqa: E402
from dm_control_tpu_torch._src import forward  # noqa: E402
from dm_control_tpu_torch._src import solver  # noqa: E402
from dm_control_tpu_torch.ops import build  # noqa: E402
from dm_control_tpu_torch.ops import linalg_kernel as lk  # noqa: E402
from dm_control_tpu_torch.ops import newton_kernel as nk  # noqa: E402


def stepped(what, dev):
  """(env, carry after one control step, the gate's controls) of task
  `what` as phase manipulation makes them."""
  i_task = cs.MANIPULATION_TASKS.index(what)
  env = cs.manipulation_env(what, cs.BATCH)
  controls = cs.manipulation_controls(i_task, env.model, dev)
  carry = env.reset(seed=i_task)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  carry, _ = env.step(carry, controls(carry.data))
  torch.cuda.synchronize()
  print(f'# {what}@{cs.BATCH}: one control step {time.perf_counter() - t0:.2f}'
        f' s', flush=True)
  return env, carry, controls(carry.data, cs.REF_LANES)


def solves(what, m, d):
  """The kernel's, plain float32's and plain float64's solves of d's
  solver inputs, and where each float32 solve stopped."""
  lay = efc.layout(m)
  d = forward.step1(m, d, skipsensor=True)
  d = forward.actuation(m, d)
  d = forward.fwd_acceleration(m, d)
  args = (d.efc_J, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss,
          d.efc_active.to(torch.float32), d.qacc_smooth, d.qacc_warmstart)
  kw = dict(niter=int(m.opt.iterations), ls_iter=solver.LS_ITERATIONS,
            tol=solver.effective_tol(m.opt.tolerance, torch.float32),
            meaninertia=float(m.stat_meaninertia))
  x_k, _, it_k = nk.newton_solve_batched(*args, lay=lay, return_iters=True,
                                         **kw)
  x_p, _, it_p = nk.newton_solve_plain(*args, types=lay.types,
                                       return_iters=True, **kw)
  x_64, _, it_64 = nk.newton_solve_plain(
      *[a.double() for a in args], types=lay.types, return_iters=True,
      **dict(kw, tol=solver.effective_tol(m.opt.tolerance, torch.float64)))
  print(f'# {what}: iterations kernel mean {it_k.float().mean():.2f} max '
        f'{int(it_k.max())}, plain float32 {it_p.float().mean():.2f} / '
        f'{int(it_p.max())}, plain float64 {it_64.float().mean():.2f} / '
        f'{int(it_64.max())}', flush=True)
  for name, x, ref in (('kernel vs plain float32', x_k, x_p),
                       ('kernel vs plain float64', x_k.double(), x_64),
                       ('plain float32 vs plain float64', x_p.double(), x_64)):
    cs.k2_check(f'{what}: {name}', x, ref, gate=False)

  def cost(x):
    parts = [cs.solve_cost(lay, *[t[i:i + cs.CHUNK].double()
                                  for t in args[:7]],
                           x[i:i + cs.CHUNK].double())
             for i in range(0, x.shape[0], cs.CHUNK)]
    return tuple(torch.cat(p) for p in zip(*parts))

  c_64, s_64 = cost(x_64)
  for name, x, it in (('kernel', x_k, it_k), ('plain float32', x_p, it_p)):
    c, s = cost(x)
    bands = (c - c_64) / (cs.EPS32 * (s + s_64))
    over = cs.lane_scaled_err(x.double(), x_64).amax(dim=1) > 1e-3
    if over.any():
      b = bands[over]
      print(f'# {what}: {name}: {int(over.sum())} lanes over 1e-3; their '
            f'cost above the optimum\'s in EPS32 x scale: median '
            f'{b.median().item():.3g}, max {b.max().item():.3g}, over BAND '
            f'{int((b > cs.BAND).sum())}; their iterations max '
            f'{int(it[over].max())} (niter {kw["niter"]})', flush=True)


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--tasks', default=','.join(cs.MANIPULATION_TASKS))
  parser.add_argument('--dump', action='store_true')
  args = parser.parse_args()
  if not torch.cuda.is_available():
    sys.exit('needs a CUDA device')
  dev = torch.device('cuda')
  build.library()
  for what in args.tasks.split(','):
    t0 = time.perf_counter()
    env, carry, ctrl = stepped(what, dev)
    solves(what, env.model, carry.data)
    if args.dump:
      lanes = torch.arange(cs.REF_LANES, device=dev)
      out = {f: x[lanes].cpu().numpy()
             for f, x in forward.state_items(forward.state_of(carry.data))}
      out['ctrl'] = ctrl.cpu().numpy()
      out['lane'] = lanes.cpu().numpy()
      os.makedirs('chiprun_out', exist_ok=True)
      path = f'chiprun_out/reference_lanes_manipulation-{what}.npz'
      np.savez(path, **out)
      print(f'# {what}: {cs.REF_LANES} gated lanes written to {path}',
            flush=True)
    try:
      cs.reference_gate(what, env.model, carry.data, ctrl, env.n_sub_steps,
                        lk)
      verdict = 'passes'
    except AssertionError as e:
      verdict = f'fails: {e}'
    print(f'# {what}: the gate {verdict} ({time.perf_counter() - t0:.1f} s)',
          flush=True)
    env = carry = None
    torch.cuda.empty_cache()


if __name__ == '__main__':
  main()
