"""chip_smoke.py's reference steps, with the K1 kernels and with K1's plain
versions, and what flips on the lanes that miss the gate's tolerance.

    python3 tools/k1_reference_step.py [--sizes 9,27,56] [--lanes 1024]
        [--tasks walker-walk,finger-spin,cheetah-run,...]

Run on a machine with one CUDA device, from the root of a checkout.  It
replays `chip_smoke.py`'s draws up to its reference phase: from one
generator seeded 0, a (4096, n, n) and a (4096, n) normal draw for each n
of `--sizes` (chip_smoke.py's kernel phase: 9, 27, 56), a 40-control-step
walker-walk@4096 rollout, the finger-spin solver inputs in contact, then
the reference steps' controls of chip_smoke.py's REF_LANES lanes of each
task, drawn as it draws them (`chip_smoke.reference_controls`: the first
64 from that generator, the rest from the reference generator, seeded 2),
and those of the lanes past them from a generator of the task's own
(`extra_controls`).  The slice's tasks (`chip_smoke.SLICE_TASKS`:
cheetah-run, hopper-hop, pendulum-swingup, reacher-easy,
cartpole-swingup, acrobot-swingup, finger-turn_easy, point_mass-easy,
ball_in_cup-catch, swimmer-swimmer6, fish-swim, humanoid-run,
quadruped-walk, the four manipulator tasks, humanoid_CMU-run,
quadruped-escape, quadruped-fetch, lqr-lqr_6_2, jaco and dog's five, and
`chip_smoke.STACKER_TASKS`, which chip_smoke.py holds in its kernel
phase only) start, as in
chip_smoke.py's phase slice, from the final states of its last rollout
run of each (`chip_smoke.slice_run`), with its reference controls first
(`chip_smoke.slice_controls`) and those of the lanes past them from the
task's own generator.  On the states so made
it runs one control step of each task's lanes on the card at float32
(`chip_smoke.one_step`) twice: through the K1 kernels (route `kernels`),
and with K1's wrappers sent to their plain versions on the card (route
`plain`); and once on the CPU at float64.  Each run records the discrete
choices of every substep (`chip_smoke.branches`: the top-K selection,
the box colliders' corner and axis choices, contact and limit activity,
the heightfield cells of the live heightfield contacts, the solve's
warmstart choice, the zones of
its rows and cones at the solution, and, at float32, where each Newton
solve stopped: `solve stop`).

For each route and task it prints the per-lane max scaled error of qpos,
qvel and (quadruped) act against float64 (largest, mean, lanes above 1e-3 and REF_TOL),
the lanes whose choices all matched and their largest error, and for
every lane over REF_TOL its verdict and what decided it
(`chip_smoke.lane_reason`): the first choice that differs (acc stage,
quantity, element, and how far the float64 run's deciding value stood
from its threshold in units of EPS32 * scale) or, where every choice
matched, the largest distance its solves stopped at from the float64
optimum's cost, with the lane's error scaled by its own largest |value|
beside it; and the quantiles of every lane's solve-stop distance.  It then counts the first
differences of all lanes by quantity with their distances' quantiles,
the gate's verdicts (`chip_smoke.lane_verdicts`), and what
the gate (`chip_smoke.gate_failures`) would fail on these lanes.

With `--dump` it also writes, for each task, the float32 integration
states (`forward.state_items`) and controls of the lanes over REF_TOL on
the kernels' route to chiprun_out/reference_lanes_TASK.npz, for
`tools/reference_step_cpu.py --states` to replay on the CPU.

Prints the card's name and power limit first.
"""

import argparse
import contextlib
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from dm_control_tpu_torch import suite  # noqa: E402
from dm_control_tpu_torch._src import efc  # noqa: E402
from dm_control_tpu_torch._src import forward  # noqa: E402
from dm_control_tpu_torch.ops import linalg_kernel as lk  # noqa: E402
from dm_control_tpu_torch.parallel import BatchedEnv  # noqa: E402

BATCH = 4096


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--sizes', default='9,27,56')
  parser.add_argument('--lanes', type=int, default=1024)
  parser.add_argument('--tasks', default=','.join(
      ('walker-walk', 'finger-spin') + cs.SLICE_TASKS + cs.STACKER_TASKS))
  parser.add_argument('--dump', action='store_true')
  args = parser.parse_args()
  sizes = [int(s) for s in args.sizes.split(',')]
  wanted = args.tasks.split(',')
  B = args.lanes
  if B < cs.REF_LANES:
    sys.exit(f'--lanes must be at least chip_smoke.py\'s {cs.REF_LANES}')
  if not torch.cuda.is_available():
    sys.exit('needs a CUDA device')
  print(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip())
  dev = torch.device('cuda')
  tasks = []
  if {'walker-walk', 'finger-spin'} & set(wanted):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ref_gen = torch.Generator(device=dev)
    ref_gen.manual_seed(cs.REF_SEED)
    for n in sizes:
      torch.randn((BATCH, n, n), generator=gen, device=dev)
      torch.randn((BATCH, n), generator=gen, device=dev)
    task = suite.build_task('walker', 'walk')
    env = BatchedEnv(task, BATCH)
    state, _ = env.rollout_fn(40)(env.reset(), gen)
    f_task = suite.build_task('finger', 'spin')
    _, f_d = cs.finger_solver_inputs(f_task.model, efc.layout(f_task.model),
                                     BATCH, gen, dev)
    # chip_smoke.py's lanes first, drawn as it draws them
    for name, t, data in (('walker-walk', task, state.data),
                          ('finger-spin', f_task, f_d)):
      ctrl = cs.reference_controls(gen, ref_gen, t.model.nu, cs.REF_LANES,
                                   dev)
      if name in wanted:
        tasks.append((name, t, data, t.n_sub_steps(), ctrl))
  for i_task, name in enumerate(cs.SLICE_TASKS + cs.STACKER_TASKS):
    if name in wanted:
      t = suite.build_task(*name.split('-'))
      state, _, _, _ = cs.slice_run(BatchedEnv(t, BATCH), i_task,
                                    cs.SLICE_RUN, dev)
      tasks.append((name, t, state.data, t.n_sub_steps(),
                    cs.slice_controls(i_task, t.model.nu, cs.REF_LANES,
                                      dev)))
  steps = []
  for name, t, data, n_sub, ctrl in tasks:
    extra = extra_controls(name, t.model.nu, B - cs.REF_LANES, dev)
    cpu = suite.build_task(*name.split('-'), device='cpu').model
    steps.append((name, t.model, cpu, data, n_sub,
                  torch.cat([ctrl, extra])))
  lanes = slice(0, B)
  print(f'# draws before the rollout: n = {sizes}; lanes {B}; band '
        f'{cs.BAND:g} x EPS32 x scale')

  for name, m, m_cpu, data, n_sub, ctrl in steps:
    t0 = time.perf_counter()
    ref = cs.one_step(m_cpu, data, lanes, ctrl, n_sub, torch.float64, 'cpu',
                      record=True)
    print(f'# {name}: float64 CPU step {time.perf_counter() - t0:.1f} s')
    gated = {}
    for route in ('kernels', 'plain'):
      lk.reset_launches()
      with cs.plain_k1(lk) if route == 'plain' else contextlib.nullcontext():
        out = cs.one_step(m, data, lanes, ctrl, n_sub, torch.float32, dev,
                          record=True)
      gated[route], err = report(f'{name}, K1 {route}', out, ref,
                                 sum(lk.LAUNCHES.values()))
      if route == 'kernels':
        over = torch.nonzero(err > cs.REF_TOL).flatten()
    failures = cs.gate_failures(gated['kernels'], gated['plain'])
    print(f'{name}: the gate on these {B} lanes: '
          f'{"; ".join(failures) or "passes"}', flush=True)
    if args.dump and len(over):
      dump(name, data, ctrl, over.to(dev))


def extra_controls(name, nu, n, dev):
  """The controls of task `name`'s lanes past chip_smoke.py's REF_LANES,
  uniform in [-1, 1], from a generator of the task's own (seeded REF_SEED
  + 1 + 100 x its index in walker-walk, finger-spin, SLICE_TASKS and
  STACKER_TASKS), so
  that they do not depend on which other tasks `--tasks` names."""
  order = (['walker-walk', 'finger-spin'] + list(cs.SLICE_TASKS)
           + list(cs.STACKER_TASKS))
  gen = torch.Generator(device=dev)
  gen.manual_seed(cs.REF_SEED + 1 + 100 * order.index(name))
  return torch.rand((n, nu), generator=gen, device=dev) * 2 - 1


def dump(name, data, ctrl, idx):
  """Write lanes `idx` of `data` (their state) and `ctrl` for
  tools/reference_step_cpu.py --states."""
  out = {f: x[idx].cpu().numpy()
         for f, x in forward.state_items(forward.state_of(data))}
  out['ctrl'] = ctrl[idx].cpu().numpy()
  out['lane'] = idx.cpu().numpy()
  os.makedirs('chiprun_out', exist_ok=True)
  np.savez(f'chiprun_out/reference_lanes_{name}.npz', **out)
  print(f'# {name}: lanes {out["lane"].tolist()} written to '
        f'chiprun_out/reference_lanes_{name}.npz', flush=True)


def report(what, out, ref, launches):
  fields = [f for f in ('qpos', 'qvel', 'act') if f in ref]
  errs = {f: cs.scaled_err(out[f].cpu().double(), ref[f]).amax(dim=1)
          for f in fields}
  for f, err in errs.items():
    print(f'{what} vs float64 CPU: {f} per-lane max scaled err: max '
          f'{err.max().item():.2e} mean {err.mean().item():.2e} first '
          f'{cs.REF_LANES} lanes max {err[:cs.REF_LANES].max().item():.2e}; '
          f'lanes above 1e-3 '
          f'{int((err > 1e-3).sum())}, above {cs.REF_TOL:g} '
          f'{int((err > cs.REF_TOL).sum())}; K1 launches {launches}',
          flush=True)
  err = torch.stack(list(errs.values())).amax(dim=0)
  first = cs.first_differences(out['branches'], ref['branches'],
                               err.shape[0])
  stops = cs.stop_distances(out['branches'], err.shape[0])
  matched = torch.tensor([f is None for f in first])
  print(f'{what}: lanes whose choices all matched {int(matched.sum())} of '
        f'{len(first)}, their largest error '
        f'{err[matched].max().item() if matched.any() else 0:.2e}')
  lane_err = torch.stack([
      cs.lane_scaled_err(out[f].cpu().double(), ref[f]).amax(dim=1)
      for f in fields]).amax(dim=0)
  verdicts = cs.lane_verdicts(err, first, cs.BAND, stops)
  for lane in torch.nonzero(err > cs.REF_TOL).flatten().tolist():
    print(f'{what}: lane {lane} error {err[lane].item():.2e} (lane-scaled '
          f'{lane_err[lane].item():.2e}) {verdicts[lane]}: '
          f'{cs.lane_reason(first[lane], stops[lane])}')
  if stops.isfinite().any():
    qs = torch.quantile(stops, torch.tensor([0.5, 0.9, 0.99, 1.0],
                                            dtype=torch.float64)).tolist()
    print(f'{what}: solve stop of every lane (x EPS32 x scale, largest over '
          f'its acc stages): median {qs[0]:.3g} p90 {qs[1]:.3g} p99 '
          f'{qs[2]:.3g} max {qs[3]:.3g}')
  by_q = {}
  for f in first:
    if f is not None:
      by_q.setdefault(f[1], []).append(f[3])
  for q, dists in by_q.items():
    d = torch.tensor(dists, dtype=torch.float64)
    qs = torch.quantile(d, torch.tensor([0.0, 0.5, 0.9, 1.0],
                                        dtype=torch.float64)).tolist()
    print(f'{what}: first differences in {q}: {len(dists)} lanes; distance '
          f'(x EPS32 x scale) min {qs[0]:.3g} median {qs[1]:.3g} p90 '
          f'{qs[2]:.3g} max {qs[3]:.3g}')
  print(f'{what}: verdicts: '
        + ', '.join(f'{v} {verdicts.count(v)}'
                    for v in ('held', 'excused', 'failed')),
        flush=True)
  return verdicts, err


if __name__ == '__main__':
  main()
