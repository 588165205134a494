"""Locomotion props (reference locomotion/props/target_sphere.py:25-124).

The port of `dm_control_tpu/locomotion/props.py`.  TargetSphere: a
non-colliding sphere that activates on touch and stays activated for the
rest of the episode.  The reference detects activation through contact
pairs against specific geoms; geoms here are non-colliding by
construction, so activation is a proximity test of named trigger bodies
against the sphere, evaluated by entity lifecycle hooks on every lane,
with each lane's activation latch and sphere colour carried in its
Data.model_var (so it auto-resets per lane with the rest of the state).
"""

from __future__ import annotations

from typing import Optional, Sequence
import xml.etree.ElementTree as ET

import numpy as np
import torch

from dm_control_tpu_torch._src.types import mirror
from dm_control_tpu_torch.composer.entity import Entity


class TargetSphere(Entity):
  """Touch-activated target.  Attach to a task, then call
  `install_hooks(trigger_bodies=[...])` with the FULL (prefixed) names
  of the bodies whose proximity activates it."""

  def __init__(self, radius: float = 0.6,
               height_above_ground: float = 1.0,
               rgb1: Sequence[float] = (0.0, 0.4, 0.0),
               rgb2: Sequence[float] = (0.0, 0.7, 0.0),
               name: str = 'target'):
    root = ET.fromstring('<mujoco><worldbody/></mujoco>')
    wb = root.find('worldbody')
    ET.SubElement(wb, 'geom', dict(
        name='target', type='sphere', size=str(radius),
        pos=f'0 0 {height_above_ground}', contype='0', conaffinity='0',
        rgba=f'{rgb1[0]} {rgb1[1]} {rgb1[2]} 1'))
    super().__init__(mjcf_root=root, name=name)
    self.radius = radius
    self._rgb1 = tuple(rgb1) + (1.0,)
    self._rgb2 = tuple(rgb2) + (1.0,)
    self._triggers: Optional[Sequence[str]] = None
    self.init_hook = self._init
    self.after_step_hook = self._after_step

  def install_hooks(self, trigger_bodies: Sequence[str]):
    """Bodies (full prefixed names) whose proximity activates this."""
    self._triggers = list(trigger_bodies)
    return self

  # -- batched hooks ---------------------------------------------------------

  def _state_key(self, prefix):
    return f'{prefix or self.name}_activated'

  def _geom_id(self, m, prefix):
    return m.name2id('geom', f'{prefix}/target' if prefix else 'target')

  def touching(self, m, d, prefix):
    """(B,) bool: a trigger body within the radius of the sphere."""
    gid = self._geom_id(m, prefix)
    mv = d.model_var or {}
    geom_pos = (mv['geom_pos'][:, gid] if 'geom_pos' in mv
                else mirror(m, d.qpos, m.geom_pos)[gid].expand(
                    d.qpos.shape[0], 3))
    if not self._triggers:
      return torch.zeros_like(d.diverged)
    tb = mirror(m, d.qpos, np.asarray(
        [m.name2id('body', b) for b in self._triggers], np.int64))
    dist = torch.linalg.vector_norm(d.xpos[:, tb] - geom_pos[:, None],
                                    dim=-1)
    return dist.amin(dim=1) < self.radius

  def activated(self, m, d, prefix=None):
    """(B,) bool: the lane's latch."""
    key = self._state_key(prefix)
    mv = d.model_var or {}
    if key not in mv:
      return torch.zeros_like(d.diverged)
    return mv[key] > 0.5

  def _rgba(self, m, d):
    mv = d.model_var or {}
    if 'geom_rgba' in mv:
      return mv['geom_rgba']
    return mirror(m, d.qpos, m.geom_rgba).expand(
        (d.qpos.shape[0],) + m.geom_rgba.shape)

  def _init(self, m, d, generator, prefix):
    mv = dict(d.model_var or {})
    mv[self._state_key(prefix)] = torch.zeros_like(d.time)
    rgba = self._rgba(m, d).clone()
    rgba[:, self._geom_id(m, prefix)] = mirror(m, d.qpos,
                                               np.asarray(self._rgb1))
    mv['geom_rgba'] = rgba
    return d.replace(model_var=mv)

  def _after_step(self, m, d, generator, prefix):
    mv = dict(d.model_var or {})
    key = self._state_key(prefix)
    was = mv.get(key, torch.zeros_like(d.time))
    now = torch.maximum(was, self.touching(m, d, prefix).to(d.time.dtype))
    mv[key] = now
    rgba = self._rgba(m, d).clone()
    rgba[:, self._geom_id(m, prefix)] = torch.where(
        (now > 0.5)[:, None], mirror(m, d.qpos, np.asarray(self._rgb2)),
        mirror(m, d.qpos, np.asarray(self._rgb1)))
    mv['geom_rgba'] = rgba
    return d.replace(model_var=mv)
