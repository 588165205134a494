"""CMU humanoid domain, 56 actuated dofs (reference:
dm_control/suite/humanoid_CMU.py): stand and run."""

from __future__ import annotations

import functools

import torch

from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import rewards

_CONTROL_TIMESTEP = .02
_STAND_HEIGHT = 1.4
_RUN_SPEED = 10

TASKS = {'stand': 0.0, 'run': float(_RUN_SPEED)}


@functools.lru_cache(maxsize=None)
def _model(device: str):
  # the default top-K broadphase: the 290 sphere-capsule, 675
  # capsule-capsule and 66 capsule-ellipsoid candidate pairs are 20 per
  # lane each (nefc 880), as in the JAX package's model
  return engine.load_model(common.model_path('humanoid_CMU.xml'), device)


@functools.lru_cache(maxsize=None)
def _make_task(move_speed: float, device: str) -> control.TaskDef:
  m = _model(device)
  thorax = m.name2id('body', 'thorax')
  head = m.name2id('body', 'head')
  limbs = [m.name2id('body', s + l) for s in ('l', 'r')
           for l in ('hand', 'foot')]
  s = m.name2id('sensor', 'thorax_subtreelinvel')
  com_adr = int(m.sensor_adr[s])

  def init_episode(m_, d, generator):
    # the first collision-free draw of 20 per lane
    def sample(d_, g):
      return d_.replace(qpos=base.randomize_limited_and_rotational_joints(
          m_, d_.qpos, g))
    return base.collision_free_init(sample, m_, d, generator)

  def get_observation(m_, d):
    torso_pos = d.xpos[:, thorax]
    # the extremities' positions in the thorax's frame
    ext = torch.einsum('Bli,Bij->Blj', d.xpos[:, limbs] - torso_pos[:, None],
                       d.xmat[:, thorax])
    return {'joint_angles': d.qpos[:, 7:],
            'head_height': d.xpos[:, head, 2],
            'extremities': ext.reshape(ext.shape[0], -1),
            'torso_vertical': d.xmat[:, thorax, 2, :],
            'com_velocity': d.sensordata[:, com_adr:com_adr + 3],
            'velocity': d.qvel}

  def get_reward(m_, d):
    standing = rewards.tolerance(
        d.xpos[:, head, 2], bounds=(_STAND_HEIGHT, float('inf')),
        margin=_STAND_HEIGHT / 4)
    upright = rewards.tolerance(
        d.xmat[:, thorax, 2, 1], bounds=(0.9, float('inf')),
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
    return small_control * stand_reward * ((5 * move + 1) / 6)

  return control.TaskDef(
      name='humanoid_CMU', model=m, init_episode=init_episode,
      get_observation=get_observation, get_reward=get_reward,
      control_timestep=_CONTROL_TIMESTEP, expensive_init=True)


def make_task(task_name: str, device: str) -> control.TaskDef:
  if task_name not in TASKS:
    raise ValueError(f'unknown humanoid_CMU task {task_name!r}')
  return _make_task(TASKS[task_name], device)
