"""Fish domain (reference: dm_control/suite/fish.py), upright and swim.

A free-floating body in a fluid, without gravity or constraints: the
root quaternion is drawn from a normal and normalised each episode, and
the swim task places the target at random, a per-lane `geom_pos` in
`Data.model_var`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch._src.types import mirror
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import rewards

_CONTROL_TIMESTEP = .04
_JOINTS = ['tail1', 'tail_twist', 'tail2', 'finright_roll', 'finright_pitch',
           'finleft_roll', 'finleft_pitch']
TASKS = {'upright': False, 'swim': True}


@functools.lru_cache(maxsize=None)
def _model(device: str):
  return engine.load_model(common.model_path('fish.xml'), device)


@functools.lru_cache(maxsize=None)
def _make_task(swim: bool, device: str) -> control.TaskDef:
  m = _model(device)
  torso = m.name2id('body', 'torso')
  root_q = int(m.jnt_qposadr[m.name2id('joint', 'root')])
  joint_qadr = [int(m.jnt_qposadr[m.name2id('joint', j)]) for j in _JOINTS]
  g_target = m.name2id('geom', 'target')
  g_mouth = m.name2id('geom', 'mouth')
  radii = float(m.geom_size[g_target, 0] + m.geom_size[g_mouth, 0])

  def init_episode(m_, d, generator):
    # a random orientation and fin and tail angles (suite/fish.py:85-94)
    qpos = d.qpos.clone()
    B = qpos.shape[0]
    kw = dict(generator=generator, dtype=qpos.dtype, device=qpos.device)
    quat = torch.randn((B, 4), **kw)
    qpos[:, root_q + 3:root_q + 7] = quat / quat.norm(dim=-1, keepdim=True)
    qpos[:, joint_qadr] = -.2 + .4 * torch.rand((B, len(_JOINTS)), **kw)
    d = d.replace(qpos=qpos)
    if swim:
      # the target uniform in [-.4, .4] x [-.4, .4] x [.1, .3]
      u = torch.rand((B, 3), **kw)
      geom_pos = mirror(m_, qpos, m_.geom_pos).expand(B, m_.ngeom, 3).clone()
      geom_pos[:, g_target] = (mirror(m_, qpos, np.array([-.4, -.4, .1]))
                               + mirror(m_, qpos, np.array([.8, .8, .2])) * u)
      d = d.replace(model_var=dict(d.model_var or {}, geom_pos=geom_pos))
    return d

  def mouth_to_target(d):
    vec = d.geom_xpos[:, g_target] - d.geom_xpos[:, g_mouth]
    return torch.einsum('Bi,Bij->Bj', vec, d.geom_xmat[:, g_mouth])

  def get_observation(m_, d):
    obs = {'joint_angles': d.qpos[:, joint_qadr],
           'upright': d.xmat[:, torso, 2, 2]}
    if swim:
      obs['target'] = mouth_to_target(d)
    obs['velocity'] = d.qvel
    return obs

  def get_reward(m_, d):
    upright = d.xmat[:, torso, 2, 2]
    if not swim:
      return rewards.tolerance(upright, bounds=(1, 1), margin=1)
    in_target = rewards.tolerance(mouth_to_target(d).norm(dim=-1),
                                  bounds=(0, radii), margin=2 * radii)
    return (7 * in_target + 0.5 * (upright + 1)) / 8

  return control.TaskDef(
      name='fish', model=m, init_episode=init_episode,
      get_observation=get_observation, get_reward=get_reward,
      control_timestep=_CONTROL_TIMESTEP)


def make_task(task_name: str, device: str) -> control.TaskDef:
  if task_name not in TASKS:
    raise ValueError(f'unknown fish task {task_name!r}')
  return _make_task(TASKS[task_name], device)
