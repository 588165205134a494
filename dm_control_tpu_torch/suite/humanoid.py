"""Humanoid domain (reference: dm_control/suite/humanoid.py): stand, walk,
run and run_pure_state."""

from __future__ import annotations

import functools

import torch

from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import rewards

_CONTROL_TIMESTEP = .025
_STAND_HEIGHT = 1.4
_WALK_SPEED = 1
_RUN_SPEED = 10

# (move_speed, pure_state)
TASKS = {'stand': (0.0, False), 'walk': (float(_WALK_SPEED), False),
         'run': (float(_RUN_SPEED), False),
         'run_pure_state': (float(_RUN_SPEED), True)}


@functools.lru_cache(maxsize=None)
def _model(device: str):
  # The self-collision candidate sets (39 sphere-capsule and 100
  # capsule-capsule pairs) and the 16 plane-capsule floor pairs go through
  # the top-K broadphase: 12, 12 and 8 pairs per lane, selected by their
  # exact distances (nefc 136 instead of 243), as the JAX package's model.
  return engine.load_model(common.model_path('humanoid.xml'), device,
                           broadphase_threshold=30, broadphase_cap=12,
                           broadphase_plane_cap=8)


@functools.lru_cache(maxsize=None)
def _make_task(move_speed: float, pure_state: bool,
               device: str) -> control.TaskDef:
  m = _model(device)
  torso = m.name2id('body', 'torso')
  head = m.name2id('body', 'head')
  limbs = [m.name2id('body', s + l)
           for s in ('left_', 'right_') for l in ('hand', 'foot')]
  s = m.name2id('sensor', 'torso_subtreelinvel')
  com_adr = int(m.sensor_adr[s])

  def init_episode(m_, d, generator):
    # the first collision-free draw of 20 per lane
    def sample(d_, g):
      return d_.replace(qpos=base.randomize_limited_and_rotational_joints(
          m_, d_.qpos, g))
    return base.collision_free_init(sample, m_, d, generator)

  def get_observation(m_, d):
    if pure_state:
      return {'position': d.qpos, 'velocity': d.qvel}
    torso_pos = d.xpos[:, torso]
    # the extremities' positions in the torso's frame
    ext = torch.einsum('Bli,Bij->Blj', d.xpos[:, limbs] - torso_pos[:, None],
                       d.xmat[:, torso])
    return {'joint_angles': d.qpos[:, 7:],
            'head_height': d.xpos[:, head, 2],
            'extremities': ext.reshape(ext.shape[0], -1),
            'torso_vertical': d.xmat[:, torso, 2, :],
            'com_velocity': d.sensordata[:, com_adr:com_adr + 3],
            'velocity': d.qvel}

  def get_reward(m_, d):
    standing = rewards.tolerance(
        d.xpos[:, head, 2], bounds=(_STAND_HEIGHT, float('inf')),
        margin=_STAND_HEIGHT / 4)
    upright = rewards.tolerance(
        d.xmat[:, torso, 2, 2], bounds=(0.9, float('inf')),
        sigmoid='linear', margin=1.9, value_at_margin=0)
    stand_reward = standing * upright
    small_control = rewards.tolerance(
        d.ctrl, margin=1, value_at_margin=0, sigmoid='quadratic').mean(-1)
    small_control = (4 + small_control) / 5
    com_v = d.sensordata[:, com_adr:com_adr + 2]
    if move_speed == 0:
      dont_move = rewards.tolerance(com_v, margin=2).mean(-1)
      return small_control * stand_reward * dont_move
    move = rewards.tolerance(
        torch.linalg.norm(com_v, dim=-1), bounds=(move_speed, float('inf')),
        margin=move_speed, value_at_margin=0, sigmoid='linear')
    return small_control * stand_reward * (5 * move + 1) / 6

  return control.TaskDef(
      name='humanoid', model=m, init_episode=init_episode,
      get_observation=get_observation, get_reward=get_reward,
      control_timestep=_CONTROL_TIMESTEP, expensive_init=True)


def make_task(task_name: str, device: str) -> control.TaskDef:
  if task_name not in TASKS:
    raise ValueError(f'unknown humanoid task {task_name!r}')
  return _make_task(*TASKS[task_name], device)
