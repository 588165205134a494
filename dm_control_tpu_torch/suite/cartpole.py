"""Cartpole domain, incl. procedural multi-pole models (reference:
dm_control/suite/cartpole.py).  The model integrates with RK4."""

from __future__ import annotations

import functools
import math
import xml.etree.ElementTree as ET

import torch

from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import rewards

# (swing_up, sparse, n_poles)
TASKS = {
    'balance': (False, False, 1),
    'balance_sparse': (False, True, 1),
    'swingup': (True, False, 1),
    'swingup_sparse': (True, True, 1),
    'two_poles': (True, False, 2),
    'three_poles': (True, False, 3),
}


@functools.lru_cache(maxsize=None)
def _model(n_poles: int, device: str):
  root = common.load_xml_root('cartpole.xml')
  if n_poles > 1:
    # chain additional poles under pole_1 (semantics of reference
    # suite/cartpole.py:110-132, re-generated with ElementTree)
    parent = root.find('./worldbody/body/body')
    for k in range(2, n_poles + 1):
      child = ET.Element('body', dict(name=f'pole_{k}', pos='0 0 1',
                                      childclass='pole'))
      ET.SubElement(child, 'joint', dict(name=f'hinge_{k}'))
      ET.SubElement(child, 'geom', dict(name=f'pole_{k}'))
      parent.append(child)
      parent = child
    floor = root.find('./worldbody/geom')
    floor.set('pos', f'0 0 {1 - n_poles - .05}')
  return engine.model_from_root(root, device)


@functools.lru_cache(maxsize=None)
def _make_task(swing_up: bool, sparse: bool, n_poles: int,
               device: str) -> control.TaskDef:
  m = _model(n_poles, device)
  slider_q = int(m.jnt_qposadr[m.name2id('joint', 'slider')])
  hinge1_q = int(m.jnt_qposadr[m.name2id('joint', 'hinge_1')])
  nv, nq = m.nv, m.nq
  pole_bodies = list(range(2, m.nbody))  # cart is body 1; poles follow

  def init_episode(m_, d, generator):
    qpos = d.qpos.clone()
    B = qpos.shape[0]
    kw = dict(generator=generator, dtype=qpos.dtype, device=qpos.device)
    if swing_up:
      # (suite/cartpole.py:192-195)
      qpos[:, slider_q] = .01 * torch.randn(B, **kw)
      qpos[:, hinge1_q] = math.pi + .01 * torch.randn(B, **kw)
      qpos[:, 2:] = .1 * torch.randn((B, nq - 2), **kw)
    else:
      qpos[:, slider_q] = -.1 + .2 * torch.rand(B, **kw)
      qpos[:, 1:] = -.034 + .068 * torch.rand((B, nq - 1), **kw)
    qvel = .01 * torch.randn((B, nv), **kw)
    return d.replace(qpos=qpos, qvel=qvel)

  def get_observation(m_, d):
    parts = [d.qpos[:, slider_q:slider_q + 1]]
    for b in pole_bodies:
      parts += [d.xmat[:, b, 2, 2:3], d.xmat[:, b, 0, 2:3]]
    return {'position': torch.cat(parts, -1), 'velocity': d.qvel}

  def get_reward(m_, d):
    cart_position = d.qpos[:, slider_q]
    pole_angle_cosine = d.xmat[:, pole_bodies, 2, 2]
    if sparse:
      cart_in_bounds = rewards.tolerance(cart_position, (-.25, .25))
      angle_in_bounds = rewards.tolerance(pole_angle_cosine,
                                          (.995, 1)).prod(-1)
      return cart_in_bounds * angle_in_bounds
    upright = (pole_angle_cosine + 1) / 2
    centered = (1 + rewards.tolerance(cart_position, margin=2)) / 2
    small_control = rewards.tolerance(d.ctrl, margin=1, value_at_margin=0,
                                      sigmoid='quadratic')[:, 0]
    small_control = (4 + small_control) / 5
    small_velocity = rewards.tolerance(d.qvel[:, 1:], margin=5).amin(-1)
    small_velocity = (1 + small_velocity) / 2
    return upright.mean(-1) * small_control * small_velocity * centered

  return control.TaskDef(
      name=f'cartpole_{n_poles}', model=m, init_episode=init_episode,
      get_observation=get_observation, get_reward=get_reward)


def make_task(task_name: str, device: str) -> control.TaskDef:
  if task_name not in TASKS:
    raise ValueError(f'unknown cartpole task {task_name!r}')
  return _make_task(*TASKS[task_name], device)
