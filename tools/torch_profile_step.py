"""Where a control step of the PyTorch/CUDA port spends its time.

Run on a machine with one CUDA device, from the root of a checkout:

    python3 tools/torch_profile_step.py [--task walker-walk|finger-spin|humanoid-run|...]
        [--steps 3] [--warm 30]
    python3 tools/torch_profile_step.py --task composer:go_to_target-ant [--steps 3] [--warm 5]

Builds the task (walker-walk by default) at batch 4096 (bench.py's batch)
on the card, warms it up (`--warm` control steps), then runs the same
window of `--steps` control steps three ways and prints, per control step
(jaco's control step is 100 RK4 physics steps of ~1M CUDA kernels:
`--steps 1 --warm 1`):

  * untraced: wall time, with the stream synchronised at both ends;
  * torch.profiler: CUDA kernels launched and summed kernel time, then the
    device's idle share, 1 - kernel time / untraced wall time, the
    kernels that take the most device time, and the Newton kernel's share
    of the kernel time (K2 on walker, K2-ell on finger) and the K1
    kernel's (factor, fused solve, substitution: each mode apart);
  * cProfile: host time by Python function (cProfile slows the host, so
    read its shares, not its times), and the share of `types.mirror`.

A `composer:` task (one of `chip_smoke.COMPOSER_TASKS`) runs the
composer's BatchedEnvironment instead, with uniform controls in [-1, 1]
(warm-up `--warm` control steps from the reset; they end no episode at
the default 5), and also prints the observation pipeline's cost: the
share of host time under cProfile inside `ObservationPipeline.update` and
`read` (cumulative), and the untraced wall of the same window with
`update` made a no-op, beside the wall with it.

Where the task's solve takes the core past the Newton kernel's dofs
(dog), the untraced window also times each core call with CUDA events
(its loop synchronises the stream every iteration, so the events span
its host work too) and prints the core's ms per control step and share
of the wall; K1b's kernels inside it are among the K1 kernels.

Prints the card's name and power limit, the host's architecture, the cores
this process may use and the load average first.
"""

import argparse
import cProfile
import os
import platform
import pstats
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dm_control_tpu_torch import suite  # noqa: E402
from dm_control_tpu_torch.ops import newton_kernel as nk  # noqa: E402
from dm_control_tpu_torch.parallel import BatchedEnv  # noqa: E402

BATCH = 4096
STEPS = 3
TASKS = {what: tuple(what.split('-')) for what in (
    'walker-walk', 'finger-spin', 'cheetah-run', 'hopper-hop',
    'pendulum-swingup', 'reacher-easy', 'cartpole-swingup',
    'acrobot-swingup', 'finger-turn_easy', 'point_mass-easy',
    'ball_in_cup-catch', 'swimmer-swimmer6', 'fish-swim', 'humanoid-run',
    'quadruped-walk', 'manipulator-bring_ball', 'manipulator-bring_peg',
    'manipulator-insert_ball', 'manipulator-insert_peg', 'stacker-stack_2',
    'stacker-stack_4', 'humanoid_CMU-run', 'quadruped-escape',
    'quadruped-fetch', 'lqr-lqr_6_2', 'jaco-position_reacher_7DOF',
    'dog-stand', 'dog-walk', 'dog-trot', 'dog-run', 'dog-fetch')}


def composer_rollout(env, steps):
  """A (carry, generator) -> (carry, None) loop of `steps` control steps
  of composer environment `env`, controls uniform in [-1, 1]."""
  nu = env.model.nu

  def run(carry, gen):
    for _ in range(steps):
      u = torch.rand((BATCH, nu), generator=gen, device='cuda')
      carry, _ = env.step(carry, 2 * u - 1)
    return carry, None
  return run


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  import chip_smoke
  composer = [f'composer:{t}' for t in chip_smoke.COMPOSER_TASKS]
  parser.add_argument('--task', choices=sorted(TASKS) + composer,
                      default='walker-walk')
  parser.add_argument('--steps', type=int, default=STEPS)
  parser.add_argument('--warm', type=int, default=None,
                      help='30 control steps; 5 for a composer task')
  args = parser.parse_args()
  task, steps = args.task, args.steps
  if not torch.cuda.is_available():
    sys.exit('needs a CUDA device')
  print(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip())
  print(f'host: {platform.machine()}; {len(os.sched_getaffinity(0))} cores; '
        f'load average {os.getloadavg()}')
  gen = torch.Generator(device='cuda')
  gen.manual_seed(0)
  if task.startswith('composer:'):
    env = chip_smoke.composer_env(task.split(':')[1], BATCH)
    state = env.reset()
    state, _ = composer_rollout(env, 5 if args.warm is None else args.warm)(
        state, gen)
    run = composer_rollout(env, steps)
  else:
    env = BatchedEnv(suite.build_task(*TASKS[task]), BATCH)
    state = env.reset()
    state, _ = env.rollout_fn(30 if args.warm is None else args.warm)(
        state, gen)   # walkers on the floor
    run = env.rollout_fn(steps)
  core_ms = []
  solve = nk.newton_solve_core

  def timed_core(*a, **k):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = solve(*a, **k)
    end.record()
    end.synchronize()
    core_ms.append(start.elapsed_time(end))
    return out

  torch.cuda.synchronize()
  nk.newton_solve_core = timed_core
  nk.reset_launches()
  t0 = time.perf_counter()
  state, _ = run(state, gen)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  nk.newton_solve_core = solve
  if core_ms:
    print(f'core (K1b inside): {len(core_ms) / steps:.0f} calls and '
          f'{nk.CORE_LOOPS["loops"] / steps:.1f} K1b launches per control '
          f'step, {sum(core_ms) / steps:.2f} ms per control step (CUDA '
          f'events around each call), {sum(core_ms) / 1e3 / wall:.3f} of the '
          f'untraced wall')

  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    state, _ = run(state, gen)
    torch.cuda.synchronize()
    wall_traced = time.perf_counter() - t0
  kernels = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
  busy_us = sum(e.device_time for e in kernels)
  print(f'{task}@{BATCH}: {wall / steps * 1e3:.2f} ms per control step '
        f'(wall, untraced), {wall_traced / steps * 1e3:.2f} ms (wall, '
        f'traced), {len(kernels) / steps:.0f} CUDA kernels per control step, '
        f'{busy_us / steps / 1e3:.2f} ms kernel time per control step, '
        f'device idle share {1 - busy_us / 1e6 / wall:.3f} (of untraced wall)')
  by_name = {}
  for e in kernels:
    t, c = by_name.get(e.name, (0.0, 0))
    by_name[e.name] = (t + e.device_time, c + 1)
  print('kernel time per control step, top 15:')
  for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
    print(f'  {t / steps / 1e3:8.3f} ms  {c / steps:7.0f} calls  {name[:90]}')
  for what, mark in (('newton_kernel', 'newton_kernel'),
                     ('K1 kernels', 'k1_kernel')):
    hits = {name: tc for name, tc in by_name.items() if mark in name}
    t_hit = sum(t for t, _ in hits.values())
    print(f'{what}: {t_hit / steps / 1e3:.3f} ms per control step in '
          f'{sum(c for _, c in hits.values()) / steps:.0f} launches, '
          f'{t_hit / max(busy_us, 1e-9):.3f} of the kernel time'
          + ''.join(f'; {name[:60]} {t / steps / 1e3:.4f} ms in '
                    f'{c / steps:.0f}' for name, (t, c) in sorted(
                        hits.items()) if len(hits) > 1))

  prof_host = cProfile.Profile()
  torch.cuda.synchronize()
  prof_host.enable()
  state, _ = run(state, gen)
  torch.cuda.synchronize()
  prof_host.disable()
  stats = pstats.Stats(prof_host)
  total = stats.total_tt
  print(f'host under cProfile: {total / steps * 1e3:.2f} ms per control step; '
        'top 12 functions by own time (share of that):')
  rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])
  for (path, line, fn), (_, ncalls, tottime, cumtime, _) in rows[:12]:
    print(f'  {tottime / total:6.3f}  {ncalls / steps:7.0f} calls  '
          f'{os.path.basename(path)}:{line}({fn})')
  for (path, line, fn), (_, ncalls, _, cumtime, _) in rows:
    if fn == 'mirror' and path.endswith('types.py'):
      print(f'types.mirror: {ncalls / steps:.0f} calls per control step, '
            f'{cumtime / total:.3f} of host time (cumulative)')
    if fn in ('update', 'read') and path.endswith('observation.py'):
      print(f'ObservationPipeline.{fn}: {ncalls / steps:.0f} calls per '
            f'control step, {cumtime / total:.3f} of host time (cumulative)')

  if task.startswith('composer:'):
    pipeline = env.pipeline
    update = pipeline.update
    pipeline.update = lambda state_, *a, **k: state_
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = run(state, gen)
    torch.cuda.synchronize()
    bare = time.perf_counter() - t0
    pipeline.update = update
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = run(state, gen)
    torch.cuda.synchronize()
    full = time.perf_counter() - t0
    print(f'observation pipeline: {full / steps * 1e3:.2f} ms per control '
          f'step with it, {bare / steps * 1e3:.2f} ms with update a no-op '
          f'(untraced; {len(pipeline.shapes)} observables, '
          f'{env.n_sub_steps} updates per control step)')


if __name__ == '__main__':
  main()
