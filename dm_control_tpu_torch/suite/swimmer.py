"""Swimmer domain with procedural n-link models (reference:
dm_control/suite/swimmer.py): swimmer6 and swimmer15.

`_model(n)` extends the chain to n segments in the MJCF tree (each with a
hinge, a motor, and a velocimeter and a gyro at its site) and compiles
it.  The fluid's drag propels it.  Each episode places the target at
random: a per-lane `geom_pos` in `Data.model_var`.
"""

from __future__ import annotations

import functools
import xml.etree.ElementTree as ET

import torch

from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch._src.types import mirror
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import rewards

_CONTROL_TIMESTEP = .03
TASKS = {'swimmer6': 6, 'swimmer15': 15}
# sensordata of the head's sensors (nose and target framepos, the head's
# x and y axes), before the segments' velocimeter and gyro pairs
_HEAD_SENSORDATA = 12


@functools.lru_cache(maxsize=None)
def _model(n_bodies: int, device: str):
  """The swimmer chain extended to n_bodies segments (semantics of
  reference suite/swimmer.py:88-139)."""
  if n_bodies < 3:
    raise ValueError('at least 3 bodies required')
  root = common.load_xml_root('swimmer.xml')
  parent = root.find('./worldbody/body')
  actuator = ET.SubElement(root, 'actuator')
  sensor = ET.SubElement(root, 'sensor')
  for i in range(n_bodies - 1):
    child = ET.Element('body', dict(name=f'segment_{i}', pos='0 .1 0'))
    ET.SubElement(child, 'geom', {'class': 'visual', 'name': f'visual_{i}'})
    ET.SubElement(child, 'geom',
                  {'class': 'inertial', 'name': f'inertial_{i}'})
    ET.SubElement(child, 'site', dict(name=f'site_{i}'))
    limit = 360.0 / n_bodies
    ET.SubElement(child, 'joint', dict(name=f'joint_{i}',
                                       range=f'{-limit} {limit}'))
    actuator.append(ET.Element('motor', dict(name=f'motor_{i}',
                                             joint=f'joint_{i}')))
    sensor.append(ET.Element('velocimeter', dict(name=f'velocimeter_{i}',
                                                 site=f'site_{i}')))
    sensor.append(ET.Element('gyro', dict(name=f'gyro_{i}',
                                          site=f'site_{i}')))
    parent.append(child)
    parent = child
  return engine.model_from_root(root, device)


@functools.lru_cache(maxsize=None)
def _make_task(n_links: int, device: str) -> control.TaskDef:
  m = _model(n_links, device)
  g_target = m.name2id('geom', 'target')
  g_nose = m.name2id('geom', 'nose')
  head = m.name2id('body', 'head')
  target_size = float(m.geom_size[g_target, 0])

  def init_episode(m_, d, generator):
    qpos = base.randomize_limited_and_rotational_joints(m_, d.qpos,
                                                        generator)
    # the target near the swimmer one time in five, else anywhere in a
    # 4 x 4 box (suite/swimmer.py:149-154)
    B = qpos.shape[0]
    kw = dict(generator=generator, dtype=qpos.dtype, device=qpos.device)
    close = torch.rand(B, **kw) < 0.2
    box = torch.where(close, 0.3, 2.0)
    xy = (2 * torch.rand((B, 2), **kw) - 1) * box[:, None]
    geom_pos = mirror(m_, qpos, m_.geom_pos).expand(B, m_.ngeom, 3).clone()
    geom_pos[:, g_target, :2] = xy
    return d.replace(qpos=qpos,
                     model_var=dict(d.model_var or {}, geom_pos=geom_pos))

  def nose_to_target(d):
    vec = d.geom_xpos[:, g_target] - d.geom_xpos[:, g_nose]
    return torch.einsum('Bi,Bij->Bj', vec, d.xmat[:, head])[:, :2]

  def get_observation(m_, d):
    B = d.qpos.shape[0]
    xvel_local = d.sensordata[:, _HEAD_SENSORDATA:].reshape(B, -1, 6)
    return {'joints': d.qpos[:, 3:], 'to_target': nose_to_target(d),
            'body_velocities': xvel_local[:, :, [0, 1, 5]].reshape(B, -1)}

  def get_reward(m_, d):
    return rewards.tolerance(nose_to_target(d).norm(dim=-1),
                             bounds=(0, target_size),
                             margin=5 * target_size, sigmoid='long_tail')

  return control.TaskDef(
      name=f'swimmer{n_links}', model=m, init_episode=init_episode,
      get_observation=get_observation, get_reward=get_reward,
      control_timestep=_CONTROL_TIMESTEP)


def make_task(task_name: str, device: str) -> control.TaskDef:
  if task_name not in TASKS:
    raise ValueError(f'unknown swimmer task {task_name!r}')
  return _make_task(TASKS[task_name], device)
