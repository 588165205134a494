"""Locomotion tasks (reference: locomotion/tasks/go_to_target.py,
random_goal_maze.py, escape.py, reach.py, corridors.py).

The port of `dm_control_tpu/locomotion/tasks.py`.  Each builds a
ComposerTask over a walker entity and a procedural arena, with batched
episode inits (drawn from the environment's torch.Generator), rewards,
terminations and step hooks, and returns a `BatchedEnvironment` of
`batch_size` lanes, or the single-lane `Environment` without one, on
`device` (CUDA unless the caller passes device='cpu').
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np
import torch

from dm_control_tpu_torch._src.types import mirror
from dm_control_tpu_torch.composer.environment import (BatchedEnvironment,
                                                       Environment)
from dm_control_tpu_torch.composer.observation import ObservableSpec
from dm_control_tpu_torch.composer.task import ComposerTask
from dm_control_tpu_torch.locomotion import arenas
from dm_control_tpu_torch.locomotion import props
from dm_control_tpu_torch.locomotion import walkers
from dm_control_tpu_torch.utils import rewards


def _add_target_geom(arena):
  """Add a visual target site geom to an arena entity."""
  wb = arena.mjcf_root.find('worldbody')
  ET.SubElement(wb, 'geom', dict(
      name='target', type='sphere', size='0.2', pos='0 0 0.2',
      contype='0', conaffinity='0', rgba='1 0 0 .5'))
  return arena


def _environment(task, batch_size, time_limit, random, dtype):
  if batch_size:
    return BatchedEnvironment(task, batch_size, time_limit=time_limit,
                              dtype=dtype)
  return Environment(task, time_limit=time_limit, random=random, dtype=dtype)


def _uniform(d, generator, lo, hi, shape):
  """(B, *shape) uniform in [lo, hi) at d's dtype and device."""
  u = torch.rand((d.qpos.shape[0],) + tuple(shape), generator=generator,
                 dtype=d.qpos.dtype, device=d.qpos.device)
  return lo + (hi - lo) * u


def _geom_pos(m, d):
  """(B, ngeom, 3): each lane's geom_pos (its model_var's, else the
  model's)."""
  mv = d.model_var or {}
  if 'geom_pos' in mv:
    return mv['geom_pos']
  return mirror(m, d.qpos, m.geom_pos).expand(
      (d.qpos.shape[0],) + m.geom_pos.shape)


def _with_walker(task, walker):
  """Compile, register the walker's observables under 'walker/'; returns
  (model, torso body id)."""
  m = task.compile()
  obs, torso = walker.observables_for(m, 'walker')
  for name, spec in obs.items():
    task.add_observable(f'walker/{name}', spec)
  return m, torso


def go_to_target(batch_size=None, time_limit=25.0, random=None,
                 walker=None, device=None, dtype=torch.float32):
  """walker: any walker entity with a 'root' freejoint on its root frame
  (Ant by default; also walkers.Rat, walkers.CMUHumanoid), or the jumping
  ball's root_x/root_y slides."""
  arena = _add_target_geom(arenas.floor(size=(8.0, 8.0)))
  walker = walker if walker is not None else walkers.Ant()
  task = ComposerTask(arena=arena, control_timestep=0.025, device=device)
  task.attach(walker)
  m, torso = _with_walker(task, walker)
  target_g = m.name2id('geom', 'target')
  free_root = 'walker/root' in m.names['joint']
  if free_root:
    root_q = int(m.jnt_qposadr[m.name2id('joint', 'walker/root')])
  else:  # planar walkers (jumping ball): root_x/root_y slide pair
    root_q = int(m.jnt_qposadr[m.name2id('joint', 'walker/root_x')])

  def target_pos(m_, d):
    return _geom_pos(m_, d)[:, target_g]

  task.add_observable('target', ObservableSpec(
      fn=lambda m_, d: target_pos(m_, d) - d.xpos[:, torso]))

  def init_episode(m_, d, generator):
    geom_pos = _geom_pos(m_, d).clone()
    geom_pos[:, target_g, :2] = _uniform(d, generator, -6.0, 6.0, (2,))
    qpos = d.qpos.clone()
    qpos[:, root_q:root_q + 2] = _uniform(d, generator, -6.0, 6.0, (2,))
    if free_root:  # random yaw only makes sense for a free root
      yaw = _uniform(d, generator, 0.0, 2 * np.pi, ())
      zero = torch.zeros_like(yaw)
      qpos[:, root_q + 3:root_q + 7] = torch.stack(
          [torch.cos(yaw / 2), zero, zero, torch.sin(yaw / 2)], dim=-1)
    mv = dict(d.model_var or {})
    mv['geom_pos'] = geom_pos
    return d.replace(qpos=qpos, model_var=mv)

  task.add_init_hook(init_episode)
  task.set_reward(lambda m_, d: (torch.linalg.vector_norm(
      target_pos(m_, d)[:, :2] - d.xpos[:, torso, :2], dim=-1) < 1.0).to(
          d.qpos.dtype))
  task.set_termination(lambda m_, d: d.xpos[:, torso, 2] < 0.2)
  return _environment(task, batch_size, time_limit, random, dtype)


def random_goal_maze(n_cells=5, batch_size=None, time_limit=30.0,
                     random=None, maze_seed=0, device=None,
                     dtype=torch.float32):
  """Goal-reaching in a procedural maze (reference
  tasks/random_goal_maze.py + arenas/mazes.py).  The maze topology is
  fixed at build time (one compiled model); the goal cell and walker
  spawn cell are drawn per episode, two distinct cells per lane, from
  the maze's open cells."""
  arena, open_pos = arenas.maze(n_cells=n_cells, seed=maze_seed)
  arena = _add_target_geom(arena)
  walker = walkers.Ant()
  task = ComposerTask(arena=arena, control_timestep=0.025, device=device)
  task.attach(walker)
  m, torso = _with_walker(task, walker)
  target_g = m.name2id('geom', 'target')
  root_q = int(m.jnt_qposadr[m.name2id('joint', 'walker/root')])
  n_open = len(open_pos)

  def target_pos(m_, d):
    return _geom_pos(m_, d)[:, target_g]

  task.add_observable('target', ObservableSpec(
      fn=lambda m_, d: target_pos(m_, d) - d.xpos[:, torso]))

  def init_episode(m_, d, generator):
    cells = mirror(m_, d.qpos, open_pos)       # (K, 2)
    B = d.qpos.shape[0]
    spawn = torch.randint(0, n_open, (B,), generator=generator,
                          device=d.qpos.device)
    goal = torch.randint(0, n_open - 1, (B,), generator=generator,
                         device=d.qpos.device)
    goal = goal + (goal >= spawn).to(goal.dtype)   # a cell of the others
    geom_pos = _geom_pos(m_, d).clone()
    geom_pos[:, target_g, :2] = cells[goal]
    qpos = d.qpos.clone()
    qpos[:, root_q:root_q + 2] = cells[spawn]
    mv = dict(d.model_var or {})
    mv['geom_pos'] = geom_pos
    return d.replace(qpos=qpos, model_var=mv)

  task.add_init_hook(init_episode)

  def reached(m_, d):
    return torch.linalg.vector_norm(
        target_pos(m_, d)[:, :2] - d.xpos[:, torso, :2], dim=-1) < 0.8

  task.set_reward(lambda m_, d: reached(m_, d).to(d.qpos.dtype))
  task.set_termination(lambda m_, d: reached(m_, d)
                       | (d.xpos[:, torso, 2] < 0.2))
  return _environment(task, batch_size, time_limit, random, dtype)


def escape(radius=8.0, depth=2.0, batch_size=None, time_limit=20.0,
           random=None, device=None, dtype=torch.float32):
  """Escape a heightfield bowl (reference tasks/escape.py:188 +
  arenas/bowl.py): reward is the linear tolerance on the walker's radial
  distance reaching the bowl rim (the suite quadruped escape reward
  shape, suite/quadruped.py:373-394)."""
  arena, heights = arenas.bowl(radius=radius, depth=depth)
  walker = walkers.Ant()
  task = ComposerTask(arena=arena, control_timestep=0.025, device=device)
  task.attach(walker)
  m, torso = _with_walker(task, walker)
  root_q = int(m.jnt_qposadr[m.name2id('joint', 'walker/root')])
  terrain = heights.ravel()

  task.add_observable('origin_distance', ObservableSpec(
      fn=lambda m_, d: torch.linalg.vector_norm(
          d.xpos[:, torso], dim=-1)[:, None]))

  def init_episode(m_, d, generator):
    mv = dict(d.model_var or {})
    mv['hfield_data'] = mirror(m_, d.qpos, terrain).expand(
        d.qpos.shape[0], terrain.size).clone()
    # start near the bowl center, slightly above the terrain
    qpos = d.qpos.clone()
    qpos[:, root_q + 2] = 0.7
    return d.replace(qpos=qpos, model_var=mv)

  task.add_init_hook(init_episode)

  def get_reward(m_, d):
    r = torch.linalg.vector_norm(d.xpos[:, torso, :2], dim=-1)
    return rewards.tolerance(r, (radius, np.inf), margin=radius,
                             sigmoid='linear', value_at_margin=0.0)

  task.set_reward(get_reward)
  return _environment(task, batch_size, time_limit, random, dtype)


def two_touch(batch_size=None, time_limit=20.0, random=None, walker=None,
              touch_interval=0.8, interval_tolerance=0.1,
              failure_timeout=1.2, touch_reward=0.2, timing_reward=1.0,
              aliveness_reward=0.0, z_height=0.14, target_radius=0.1,
              target_area=(0.3, 0.6), device=None, dtype=torch.float32):
  """Reach task: tap a target twice with a timed interval (reference
  locomotion/tasks/reach.py TwoTouch, :37-370).  The reference's
  5-state trial machine (PRE_TOUCH / TOUCHED_ONCE / TOUCHED_TWICE /
  TOUCHED_TOO_SOON / NO_SECOND_TOUCH) runs per lane: the state, the
  state-entry time and this step's reward pulse ride each lane's
  model_var['tt_state'], so the task batches and auto-resets per lane.
  Trials cycle within an episode — a terminal state returns to
  PRE_TOUCH after failure_timeout, as the reference cycles its target
  queue."""
  arena = arenas.floor(size=(2.0, 2.0))
  walker = walker if walker is not None else walkers.Rat()
  target = props.TargetSphere(radius=target_radius,
                              height_above_ground=z_height, name='target')
  # trigger bodies come from the walker entity (the reference resolves
  # 'lhand'/'rhand' then 'hand_L'/'hand_R', reach.py:70-74); walkers
  # without hands cannot run this task
  hands = getattr(walker, 'hand_bodies', None)
  if not hands:
    raise ValueError(
        f'two_touch requires a walker with hand bodies; '
        f'{type(walker).__name__} declares no hand_bodies attribute')
  target.install_hooks([f'{walker.name}/{b}' for b in hands])
  task = ComposerTask(arena=arena, control_timestep=0.03, device=device)
  task.attach(walker)
  task.attach(target)
  m, torso = _with_walker(task, walker)
  target_g = m.name2id('geom', 'target/target')
  root_q = int(m.jnt_qposadr[m.name2id('joint', 'walker/root')])

  def target_pos(m_, d):
    return _geom_pos(m_, d)[:, target_g]

  def tt_state(d):
    mv = d.model_var or {}
    if 'tt_state' in mv:
      return mv['tt_state']
    return d.qpos.new_zeros((d.qpos.shape[0], 3))

  task.add_observable('target', ObservableSpec(
      fn=lambda m_, d: target_pos(m_, d) - d.xpos[:, torso]))
  task.add_observable('task_state', ObservableSpec(
      fn=lambda m_, d: tt_state(d)[:, :2]))

  def init_episode(m_, d, generator):
    # rectangle with half-extents target_area, as the reference's
    # _randomize_targets does (reach.py TwoTouch: uniform over
    # [-area[0], area[0]] x [-area[1], area[1]])
    geom_pos = _geom_pos(m_, d).clone()
    geom_pos[:, target_g, 0] = _uniform(d, generator, -target_area[0],
                                        target_area[0], ())
    geom_pos[:, target_g, 1] = _uniform(d, generator, -target_area[1],
                                        target_area[1], ())
    mv = dict(d.model_var or {})
    mv['geom_pos'] = geom_pos
    mv['tt_state'] = d.qpos.new_zeros((d.qpos.shape[0], 3))
    qpos = d.qpos.clone()
    qpos[:, root_q + 2] = 0.06
    return d.replace(model_var=mv, qpos=qpos)

  task.add_init_hook(init_episode)

  def state_machine(m_, d, generator, prefix):
    """after_step: advance each lane's two-touch trial machine.
    tt_state = [state, state-entry time, reward pulse this step]."""
    mv = dict(d.model_var or {})
    st = tt_state(d)
    state, t0 = st[:, 0], st[:, 1]
    touch = target.touching(m_, d, 'target')
    dt = d.time - t0
    in_pre = state < 0.5
    in_once = (state > 0.5) & (state < 1.5)
    terminal = state > 1.5
    to_once = in_pre & touch
    to_twice = in_once & touch & (
        (dt - touch_interval).abs() <= interval_tolerance)
    to_soon = in_once & touch & (dt < touch_interval - interval_tolerance)
    to_nosecond = in_once & ~touch & (
        dt > touch_interval + interval_tolerance)
    trial_reset = terminal & (dt > failure_timeout)
    new_state = torch.where(to_once, 1.0, state)
    new_state = torch.where(to_twice, 2.0, new_state)
    new_state = torch.where(to_soon, 3.0, new_state)
    new_state = torch.where(to_nosecond, 4.0, new_state)
    new_state = torch.where(trial_reset, 0.0, new_state)
    entered = to_once | to_twice | to_soon | to_nosecond
    new_t0 = torch.where(entered, d.time, t0)
    pulse = (touch_reward * to_once.to(st.dtype)
             + timing_reward * to_twice.to(st.dtype))
    mv['tt_state'] = torch.stack([new_state, new_t0, pulse], dim=-1)
    return d.replace(model_var=mv)

  arena.after_step_hook = state_machine
  task.set_reward(lambda m_, d: tt_state(d)[:, 2] + aliveness_reward)
  return _environment(task, batch_size, time_limit, random, dtype)


def run_through_corridor(corridor='empty', target_velocity=3.0,
                         batch_size=None, time_limit=30.0, random=None,
                         device=None, dtype=torch.float32):
  """RunThroughCorridor (reference tasks/corridors.py): reward is the
  linear tolerance on the walker's forward velocity."""
  maker = dict(empty=arenas.empty_corridor, gaps=arenas.gaps_corridor,
               walls=arenas.walls_corridor)[corridor]
  arena = maker()
  walker = walkers.Ant()
  task = ComposerTask(arena=arena, control_timestep=0.025, device=device)
  task.attach(walker)
  m, torso = _with_walker(task, walker)
  root_q = int(m.jnt_qposadr[m.name2id('joint', 'walker/root')])
  root_d = int(m.jnt_dofadr[m.name2id('joint', 'walker/root')])

  def init_episode(m_, d, generator):
    qpos = d.qpos.clone()
    qpos[:, root_q] = 1.0
    qpos[:, root_q + 1] = 0.0
    return d.replace(qpos=qpos)

  task.add_init_hook(init_episode)

  def get_reward(m_, d):
    return rewards.tolerance(
        d.qvel[:, root_d], (target_velocity, target_velocity),
        margin=target_velocity, sigmoid='linear', value_at_margin=0.0)

  task.set_reward(get_reward)
  task.set_termination(lambda m_, d: d.xpos[:, torso, 2] < 0.2)
  return _environment(task, batch_size, time_limit, random, dtype)
