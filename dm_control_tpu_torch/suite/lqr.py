"""LQR domain (reference: dm_control/suite/lqr.py): procedural chains of
slide-joint bodies on springs, lqr_2_1 and lqr_6_2.

`_make_model_xml` is the JAX package's (suite/lqr.py:26-61) as it is: the
joints' stiffnesses come from a numpy RandomState(seed), so the port's
model equals the JAX package's field for field.  Constraints are
disabled: the step runs K1 only.  Each episode starts on the sphere
|qpos| = sqrt(2); the reward 1 - (state cost + 0.1 control cost) has no
lower bound, the time limit is infinite, and an episode ends (discount 0)
once |(qpos, qvel)| < 1e-6.  The analytic policy (`utils/lqr_solver.py`)
differentiates through the step: its K1 calls are autograd Functions.
"""

from __future__ import annotations

import functools
import math
import xml.etree.ElementTree as ET

import numpy as np
import torch

from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import common

_CONTROL_COST_COEF = 0.1
_TERMINAL_TOL = 1e-6
# task -> (bodies, actuators); the model's seed is 0, as the reference's
# with no `random` given
TASKS = {'lqr_2_1': (2, 1), 'lqr_6_2': (6, 2)}


def _make_model_xml(n_bodies, n_actuators, rng,
                    stiffness_range=(15, 25), damping_range=(0, 0)):
  """Procedural chain of slide-joint bodies (reference suite/lqr.py:145-207)."""
  root = common.load_xml_root('lqr.xml')
  parent = root.find('./worldbody')
  actuator = ET.SubElement(root, 'actuator')
  tendon = ET.SubElement(root, 'tendon')
  for b in range(n_bodies):
    body = ET.Element('body', dict(name=f'body_{b}', pos='.25 0 0'))
    joint = ET.SubElement(body, 'joint', dict(name=f'joint_{b}'))
    body.append(ET.Element('geom', dict(name=f'geom_{b}')))
    joint.set('stiffness', str(rng.uniform(*stiffness_range)))
    joint.set('damping', str(rng.uniform(*damping_range)))
    body.append(ET.Element('site', dict(name=f'site_{b}')))
    if b == 0:
      body.set('pos', '.25 0 .1')
    if b < n_actuators:
      actuator.append(ET.Element('motor', dict(
          name=f'motor_{b}', joint=f'joint_{b}')))
    if b < n_bodies - 1:
      spatial = ET.SubElement(tendon, 'spatial', dict(name=f'tendon_{b}'))
      spatial.append(ET.Element('site', dict(site=f'site_{b}')))
      spatial.append(ET.Element('site', dict(site=f'site_{b + 1}')))
    parent.append(body)
    parent = body
  return root


@functools.lru_cache(maxsize=None)
def _model(n_bodies: int, n_actuators: int, seed: int, device: str):
  rng = np.random.RandomState(seed)
  return engine.model_from_root(
      _make_model_xml(n_bodies, n_actuators, rng), device)


@functools.lru_cache(maxsize=None)
def _make_task(n_bodies: int, n_actuators: int, control_cost_coef: float,
               seed: int, device: str) -> control.TaskDef:
  m = _model(n_bodies, n_actuators, seed, device)

  def init_episode(m_, d, generator):
    unit = torch.randn(d.qpos.shape, generator=generator, dtype=d.qpos.dtype,
                       device=d.qpos.device)
    return d.replace(qpos=math.sqrt(2.0) * unit
                     / unit.norm(dim=1, keepdim=True))

  def get_observation(m_, d):
    return {'position': d.qpos, 'velocity': d.qvel}

  def get_reward(m_, d):
    state_cost = 0.5 * (d.qpos * d.qpos).sum(-1)
    control_cost = 0.5 * (d.ctrl * d.ctrl).sum(-1)
    return 1.0 - (state_cost + control_cost * control_cost_coef)

  def get_termination(m_, d):
    norm = torch.sqrt((d.qpos * d.qpos).sum(-1) + (d.qvel * d.qvel).sum(-1))
    return norm < _TERMINAL_TOL

  return control.TaskDef(
      name=f'lqr_{n_bodies}_{n_actuators}', model=m,
      init_episode=init_episode, get_observation=get_observation,
      get_reward=get_reward, get_termination=get_termination)


def make_task(task_name: str, device: str) -> control.TaskDef:
  if task_name not in TASKS:
    raise ValueError(f'unknown lqr task {task_name!r}')
  return _make_task(*TASKS[task_name], _CONTROL_COST_COEF, 0, device)
