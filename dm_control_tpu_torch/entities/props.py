"""Primitive props and the position detector (reference:
entities/props/primitive.py:28, position_detector.py:45).

The port of `dm_control_tpu/entities/props.py`.  A Primitive is a single
free-jointed geom with pose and velocity observables (the reference
attaches framepos/framequat/framelinvel/frameangvel sensors; here the
observables read the free joint's qpos/qvel directly: the same values,
no sensor rows).

A PositionDetector reports whether a body lies inside a cuboidal region.
The reference flips geom colors from a host-side hook; here detection is
a function of batched Data, exposed as an observable and as a
`detected(m, d, body)` predicate, (B,) bool, for rewards and
terminations.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence
import xml.etree.ElementTree as ET

import numpy as np
import torch

from dm_control_tpu_torch._src.types import mirror
from dm_control_tpu_torch.composer.entity import Entity
from dm_control_tpu_torch.composer.observation import ObservableSpec

_GEOM_SIZES = {'sphere': 1, 'capsule': 2, 'cylinder': 2, 'ellipsoid': 3,
               'box': 3}


class Primitive(Entity):
  """Free prop of a single geom (reference primitive.py:28-58)."""

  def __init__(self, geom_type: str, size: Sequence[float],
               name: str = 'prop', mass: Optional[float] = None,
               rgba=(0.8, 0.6, 0.2, 1.0), friction=None, pos=(0, 0, 0.5)):
    if geom_type not in _GEOM_SIZES:
      raise ValueError(f'unsupported geom type {geom_type!r}')
    if len(size) != _GEOM_SIZES[geom_type]:
      raise ValueError(
          f'{geom_type} wants {_GEOM_SIZES[geom_type]} size values')
    root = ET.Element('mujoco')
    wb = ET.SubElement(root, 'worldbody')
    body = ET.SubElement(wb, 'body', dict(
        name=name, pos=' '.join(str(v) for v in pos)))
    ET.SubElement(body, 'freejoint', dict(name=f'{name}_root'))
    geom = dict(name=f'{name}_geom', type=geom_type,
                size=' '.join(str(v) for v in size),
                rgba=' '.join(str(v) for v in rgba))
    if mass is not None:
      geom['mass'] = str(mass)
    if friction is not None:
      geom['friction'] = ' '.join(str(v) for v in friction)
    ET.SubElement(body, 'geom', geom)
    super().__init__(mjcf_root=root, name=name,
                     observables=self._make_observables(name))
    self.geom_type = geom_type
    self.size = tuple(size)

  @staticmethod
  def _make_observables(name):
    def factory(field, lo, n):
      def make(m, prefix):
        j = m.name2id('joint', f'{prefix or name}/{name}_root')
        adr = int(m.jnt_qposadr[j] if field == 'qpos' else m.jnt_dofadr[j])
        return ObservableSpec(
            fn=lambda m_, d, a=adr + lo: getattr(d, field)[:, a:a + n])
      return make
    return {
        'position': factory('qpos', 0, 3),
        'orientation': factory('qpos', 3, 4),
        'linear_velocity': factory('qvel', 0, 3),
        'angular_velocity': factory('qvel', 3, 3),
    }

  def root_joint(self, m, prefix=None):
    """(qpos_adr, dof_adr) of the prop's free joint in a compiled model."""
    j = m.name2id('joint', f'{prefix or self.name}/{self.name}_root')
    return int(m.jnt_qposadr[j]), int(m.jnt_dofadr[j])


@dataclasses.dataclass
class PositionDetector:
  """Cuboidal region detector (reference position_detector.py:45-130).

  2D mode (len(pos) == 2): infinite z extent.  `inverted` detects
  bodies OUTSIDE the region."""
  pos: Sequence[float]
  size: Sequence[float]
  inverted: bool = False
  name: str = 'position_detector'

  def __post_init__(self):
    if len(self.pos) != len(self.size) or len(self.pos) not in (2, 3):
      raise ValueError('pos/size must both have length 2 or 3')

  def site_entity(self, rgba=(1, 1, 1, 0.25)) -> Entity:
    """Optional visual marker for the region (non-colliding geom)."""
    root = ET.Element('mujoco')
    wb = ET.SubElement(root, 'worldbody')
    pos3 = tuple(self.pos) + (0.0,) * (3 - len(self.pos))
    size3 = tuple(self.size) + (0.01,) * (3 - len(self.size))
    ET.SubElement(wb, 'geom', dict(
        name=f'{self.name}_region', type='box', contype='0',
        conaffinity='0', pos=' '.join(str(v) for v in pos3),
        size=' '.join(str(v) for v in size3),
        rgba=' '.join(str(v) for v in rgba)))
    return Entity(mjcf_root=root, name=self.name)

  def detected(self, m, d, body: int) -> torch.Tensor:
    """(B,) bool: is `body`'s frame origin inside (or outside, when
    inverted) the region?"""
    k = len(self.pos)
    p = d.xpos[:, body, :k]
    pos = mirror(m, p, np.asarray(self.pos, np.float64))
    size = mirror(m, p, np.asarray(self.size, np.float64))
    inside = ((p >= pos - size) & (p <= pos + size)).all(-1)
    return ~inside if self.inverted else inside

  def observable(self, body: int) -> ObservableSpec:
    return ObservableSpec(
        fn=lambda m, d: self.detected(m, d, body).to(d.qpos.dtype)[:, None])
