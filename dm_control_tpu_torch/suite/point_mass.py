"""Point-mass domain (reference: dm_control/suite/point_mass.py), easy and
hard.

Two fixed tendons drive the mass.  The hard task draws random,
non-parallel actuation directions each episode: the tendons' joint
coefficients, a per-lane `wrap_prm` in `Data.model_var`, which
`smooth.tendon` reads through `smooth.mparam`.
"""

from __future__ import annotations

import functools

import torch

from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import rewards

TASKS = {'easy': False, 'hard': True}
# candidates for the second direction; the first not within |cos| 0.9 of
# the first direction is taken (the first candidate where none is)
_DIR_CANDIDATES = 10


@functools.lru_cache(maxsize=None)
def _model(device: str):
  return engine.load_model(common.model_path('point_mass.xml'), device)


def _directions(B: int, ref: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
  """(B, 4) tendon coefficients: two unit directions in the plane, the
  second not near-parallel to the first (suite/point_mass.py:100-112)."""
  kw = dict(generator=generator, dtype=ref.dtype, device=ref.device)
  d1 = torch.randn((B, 2), **kw)
  d1 = d1 / d1.norm(dim=-1, keepdim=True)
  d2s = torch.randn((B, _DIR_CANDIDATES, 2), **kw)
  d2s = d2s / d2s.norm(dim=-1, keepdim=True)
  ok = torch.einsum('bkx,bx->bk', d2s, d1).abs() <= 0.9
  idx = torch.argmax(ok.to(torch.int32), dim=1)
  d2 = d2s[torch.arange(B, device=ref.device), idx]
  return torch.cat([d1, d2], dim=-1)


@functools.lru_cache(maxsize=None)
def _make_task(randomize_gains: bool, device: str) -> control.TaskDef:
  m = _model(device)
  g_target = m.name2id('geom', 'target')
  g_mass = m.name2id('geom', 'pointmass')
  target_size = float(m.geom_size[g_target, 0])

  def init_episode(m_, d, generator):
    qpos = base.randomize_limited_and_rotational_joints(m_, d.qpos,
                                                        generator)
    d = d.replace(qpos=qpos)
    if randomize_gains:
      d = d.replace(model_var=dict(
          d.model_var or {},
          wrap_prm=_directions(qpos.shape[0], qpos, generator)))
    return d

  def get_observation(m_, d):
    return {'position': d.qpos, 'velocity': d.qvel}

  def get_reward(m_, d):
    dist = (d.geom_xpos[:, g_target] - d.geom_xpos[:, g_mass]).norm(dim=-1)
    near_target = rewards.tolerance(dist, bounds=(0, target_size),
                                    margin=target_size)
    control_reward = rewards.tolerance(d.ctrl, margin=1, value_at_margin=0,
                                       sigmoid='quadratic').mean(-1)
    return near_target * (control_reward + 4) / 5

  return control.TaskDef(
      name='point_mass', model=m, init_episode=init_episode,
      get_observation=get_observation, get_reward=get_reward)


def make_task(task_name: str, device: str) -> control.TaskDef:
  if task_name not in TASKS:
    raise ValueError(f'unknown point_mass task {task_name!r}')
  return _make_task(TASKS[task_name], device)
