"""Which stage of a float32 control step moves a task's lanes off float64.

    python3 tools/float32_step_probe.py [--task dog-stand] [--lanes 256]

Run on a machine with one CUDA device, from the root of a checkout.  It
makes `chip_smoke.py`'s reference-gate states of the task (the final
states of its last slice run, `chip_smoke.slice_run`) and controls
(`chip_smoke.slice_controls`), then runs one control step of the first
`--lanes` lanes several ways and prints, for each, the per-lane max
scaled error of qpos, qvel and act against the card's float64 step
(`chip_smoke.one_step` through the plain versions of every kernel): its
largest, its median, the lanes over REF_TOL and their count:

  * card float32 (the main path, K1 kernels);
  * CPU float32 and CPU float64 (the plain versions, the same states);
  * card float32 with noslip (`solver._noslip`) at float64, its inputs
    cast up and its results cast down;
  * card float32 with the Newton solve at float64 (the plain float64
    core on the stage's cast inputs);
  * card float32 with both.

A variant that brings the card's float32 lanes to the CPU float32 step's
errors names the stage whose float32 arithmetic on the card moves them.
Prints the card's name and power limit first.
"""

import argparse
import contextlib
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from dm_control_tpu_torch import suite  # noqa: E402
from dm_control_tpu_torch._src import solver  # noqa: E402
from dm_control_tpu_torch.ops import linalg_kernel as lk  # noqa: E402
from dm_control_tpu_torch.ops import newton_kernel as nk  # noqa: E402
from dm_control_tpu_torch.parallel import BatchedEnv  # noqa: E402

BATCH = 4096


@contextlib.contextmanager
def noslip64():
  """Inside, `solver._noslip` runs at float64 on float32 steps."""
  saved = solver._noslip

  def run(m, lay, d, x, force):
    if x.dtype == torch.float64:
      return saved(m, lay, d, x, force)
    up = lambda t: t.double() if t.is_floating_point() else t
    d64 = d.replace(**{f: up(getattr(d, f)) for f in (
        'efc_J', 'qLD', 'efc_aref', 'efc_frictionloss', 'qacc_smooth')})
    x64, f64 = saved(m, lay, d64, x.double(), force.double())
    return x64.float(), f64.float()

  solver._noslip = run
  try:
    yield
  finally:
    solver._noslip = saved


@contextlib.contextmanager
def core64():
  """Inside, the Newton solve past 64 dofs runs at float64 (plain) on
  float32 steps."""
  saved = nk.newton_solve_core

  def run(*args, lay, **kw):
    if args[0].dtype == torch.float64:
      return saved(*args, lay=lay, **kw)
    kw = dict(kw, tol=solver.effective_tol(1e-8, torch.float64))
    kw.pop('return_iters', None)
    x, f = nk.newton_solve_plain(*[a.double() for a in args],
                                 types=lay.types, ell_groups=lay.ell_groups,
                                 **kw)
    return x.float(), f.float()

  nk.newton_solve_core = run
  try:
    yield
  finally:
    nk.newton_solve_core = saved


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--task', default='dog-stand')
  parser.add_argument('--lanes', type=int, default=cs.REF_LANES)
  args = parser.parse_args()
  if not torch.cuda.is_available():
    sys.exit('needs a CUDA device')
  print(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip(), flush=True)
  dev = torch.device('cuda')
  what = args.task
  i_task = (cs.SLICE_TASKS + cs.STACKER_TASKS).index(what)
  task = suite.build_task(*what.split('-'))
  state, _, _, _ = cs.slice_run(BatchedEnv(task, BATCH), i_task,
                                cs.SLICE_RUN, dev)
  n = args.lanes
  ctrl = cs.slice_controls(i_task, task.model.nu, n, dev)
  n_sub = task.n_sub_steps()
  m, m_cpu = task.model, suite.build_task(*what.split('-'),
                                          device='cpu').model
  lanes = slice(0, n)
  with cs.plain_kernels(lk, nk):
    ref = cs.one_step(m, state.data, lanes, ctrl, n_sub, torch.float64, dev)
  ref = {f: x.cpu().double() for f, x in ref.items()}

  def report(name, out):
    err = torch.stack([cs.scaled_err(out[f].cpu().double(), ref[f]).amax(1)
                       for f in ref]).amax(0)
    over = torch.nonzero(err > cs.REF_TOL).flatten().tolist()
    print(f'{what}, {name}: vs the card\'s float64: largest '
          f'{err.max().item():.3g}, median {err.median().item():.3g}, over '
          f'{cs.REF_TOL:g} {len(over)}: {over}', flush=True)

  report('card float32', cs.one_step(m, state.data, lanes, ctrl, n_sub,
                                     torch.float32, dev))
  cpu = cs.state_fields(m)
  for dt in (torch.float32, torch.float64):
    out = cs.one_step(m_cpu, state.data, lanes, ctrl.cpu(), n_sub, dt, 'cpu')
    report(f'CPU {str(dt).split(".")[1]}', {f: out[f] for f in cpu})
  for name, ctx in (('card float32, noslip at float64', noslip64),
                    ('card float32, Newton solve at float64', core64)):
    with ctx():
      report(name, cs.one_step(m, state.data, lanes, ctrl, n_sub,
                               torch.float32, dev))
  with noslip64(), core64():
    report('card float32, both at float64', cs.one_step(
        m, state.data, lanes, ctrl, n_sub, torch.float32, dev))


if __name__ == '__main__':
  main()
