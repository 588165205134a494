"""chip_smoke.py's reference steps with the K1 kernels and with K1's plain versions.

    python3 tools/k1_reference_step.py [--sizes 9,27,56] [--lanes 64]

Run on a machine with one CUDA device, from the root of a checkout.  It
replays `chip_smoke.py`'s draws up to its reference phase: from one
generator seeded 0, a (4096, n, n) and a (4096, n) normal draw for each n
of `--sizes` (chip_smoke.py's kernel phase: 9, 27, 56), a 40-control-step
walker-walk@4096 rollout, the finger-spin solver inputs in contact, then
the two reference steps' controls (for the first 64 lanes; with more
`--lanes`, the rest drawn after them).  On the states so made it runs one
control step of the walker lanes and of the finger lanes on the card at
float32 (`chip_smoke.one_step`) twice: through the K1 kernels, and with
K1's wrappers on the card sent to their plain versions; and once on the
CPU at float64.  For each route it prints each field's largest and mean
per-lane max scaled error against float64 and the lanes above 1e-3 and
1e-2 (chip_smoke.py gates the first 64 lanes' largest at 1e-2), and the
same between the two float32 routes.  An error that the plain versions
share is float32's on that state, not the kernels'.

Prints the card's name and power limit first.
"""

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from dm_control_tpu_torch import suite  # noqa: E402
from dm_control_tpu_torch._src import efc  # noqa: E402
from dm_control_tpu_torch.ops import linalg_kernel as lk  # noqa: E402
from dm_control_tpu_torch.parallel import BatchedEnv  # noqa: E402

BATCH = 4096
PLAIN = {'cholesky_batched': lk.cholesky_plain,
         'chol_solve_batched': lk.chol_solve_plain,
         'cho_solve_batched': lk.cho_solve_plain}


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--sizes', default='9,27,56')
  parser.add_argument('--lanes', type=int, default=64)
  args = parser.parse_args()
  sizes = [int(s) for s in args.sizes.split(',')]
  B = args.lanes
  if not torch.cuda.is_available():
    sys.exit('needs a CUDA device')
  print(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip())
  dev = torch.device('cuda')
  gen = torch.Generator(device=dev)
  gen.manual_seed(0)
  for n in sizes:
    torch.randn((BATCH, n, n), generator=gen, device=dev)
    torch.randn((BATCH, n), generator=gen, device=dev)
  task = suite.build_task('walker', 'walk')
  env = BatchedEnv(task, BATCH)
  state, _ = env.rollout_fn(40)(env.reset(), gen)
  f_task = suite.build_task('finger', 'spin')
  _, f_d = cs.finger_solver_inputs(f_task.model, efc.layout(f_task.model),
                                   BATCH, gen, dev)
  lanes = slice(0, B)
  models = {}
  for name, t in (('walker-walk', task), ('finger-spin', f_task)):
    nu = t.model.nu
    ctrl = torch.rand((64, nu), generator=gen, device=dev) * 2 - 1
    models[name] = [t.model, ctrl]
  for name, (m, ctrl) in models.items():     # lanes past chip_smoke's 64
    extra = torch.rand((B - 64, m.nu), generator=gen, device=dev) * 2 - 1
    models[name][1] = torch.cat([ctrl, extra])[:B]
  steps = (
      ('walker-walk', suite.build_task('walker', 'walk', device='cpu').model,
       state.data, env.n_sub_steps),
      ('finger-spin', suite.build_task('finger', 'spin', device='cpu').model,
       f_d, f_task.n_sub_steps()))
  kernels = {k: getattr(lk, k) for k in PLAIN}
  print(f'# draws before the rollout: n = {sizes}; lanes {B}')
  for name, m_cpu, data, n_sub in steps:
    m, ctrl = models[name]
    ref = cs.one_step(m_cpu, data, lanes, ctrl, n_sub, torch.float64, 'cpu')
    out = {}
    for route in ('K1 kernels', 'K1 plain versions on the card'):
      for k, fn in (PLAIN if 'plain' in route else kernels).items():
        setattr(lk, k, fn)
      lk.reset_launches()
      out[route] = cs.one_step(m, data, lanes, ctrl, n_sub, torch.float32,
                               dev)
      report(f'{name}, {route} vs float64 CPU', out[route], ref,
             sum(lk.LAUNCHES.values()))
    for k, fn in kernels.items():
      setattr(lk, k, fn)
    report(f'{name}, K1 kernels vs K1 plain versions (both float32 card)',
           out['K1 kernels'],
           {f: x.double() for f, x in
            out['K1 plain versions on the card'].items()}, None)


def report(what, out, ref, launches):
  for f in ('qpos', 'qvel'):
    err = cs.scaled_err(out[f].cpu().double(), ref[f].cpu()).amax(dim=1)
    print(f'{what}: {f} per-lane max scaled err: max {err.max().item():.2e} '
          f'mean {err.mean().item():.2e} first 64 lanes max '
          f'{err[:64].max().item():.2e}; lanes above 1e-3 '
          f'{int((err > 1e-3).sum())}, above 1e-2 {int((err > 1e-2).sum())}'
          + (f'; K1 launches {launches}' if launches is not None else ''),
          flush=True)


if __name__ == '__main__':
  main()
