"""Episode initializers (reference: composer/initializers/).

The port of `dm_control_tpu/composer/initializers.py`.  Both take a
batched (Model, Data, torch.Generator) like any episode init hook.

PropPlacer: collision-free placement by rejection sampling with a bounded
number of attempts (the reference re-runs mj_forward and a contact check
per attempt, initializers/prop_initializer.py:49-140): every attempt
proposes a pose for every lane, and each lane keeps its first
collision-free proposal (its first proposal where none is).

ToolCenterPointInitializer: damped-least-squares IK on a site (reference
initializers/tcp_initializer.py:35 over utils/inverse_kinematics.py).
"""

from __future__ import annotations

from typing import Sequence

import torch

from dm_control_tpu_torch._src.types import Data, Model
from dm_control_tpu_torch.composer import variation as variation_lib
from dm_control_tpu_torch.suite import base as suite_base


def _per_lane(value, generator, ref: torch.Tensor, n: int) -> torch.Tensor:
  """(B, n): `value` (a Variation, or constants, of n components) drawn
  once per lane, in lane order, from `generator`."""
  rows = []
  for _ in range(ref.shape[0]):
    x = variation_lib.evaluate(value, generator)
    if isinstance(x, (tuple, list)):
      x = torch.stack([torch.as_tensor(c, dtype=ref.dtype,
                                       device=ref.device).reshape(())
                       for c in x])
    rows.append(torch.as_tensor(x, dtype=ref.dtype,
                                device=ref.device).reshape(n))
  return torch.stack(rows)


class PropPlacer:
  """Places free bodies at sampled poses, keeping collision-free draws.

  prop_qpos_addrs: qpos address of each prop's free joint.
  position / quaternion: Variations (or constants) drawn per lane and
  attempt.
  """

  def __init__(self, prop_qpos_addrs: Sequence[int], position,
               quaternion=None, max_attempts: int = 20,
               ignore_collisions: bool = False):
    self._addrs = list(prop_qpos_addrs)
    self._position = position
    self._quaternion = quaternion
    self._max_attempts = max_attempts
    self._ignore = ignore_collisions

  def __call__(self, m: Model, d: Data,
               generator: torch.Generator) -> Data:
    for adr in self._addrs:
      d = self._place_one(m, d, adr, generator)
    return d

  def _propose(self, d, adr, generator):
    qpos = d.qpos.clone()
    qpos[:, adr:adr + 3] = _per_lane(self._position, generator, d.qpos, 3)
    if self._quaternion is not None:
      qpos[:, adr + 3:adr + 7] = _per_lane(self._quaternion, generator,
                                           d.qpos, 4)
    return d.replace(qpos=qpos)

  def _place_one(self, m, d, adr, generator):
    first = self._propose(d, adr, generator)
    if self._ignore:
      return first
    qpos = first.qpos
    found = ~suite_base.has_contacts(m, first)
    for _ in range(1, self._max_attempts):
      cand = self._propose(d, adr, generator)
      ok = ~suite_base.has_contacts(m, cand)
      take = ok & ~found
      qpos = torch.where(take[:, None], cand.qpos, qpos)
      found = found | ok
    return d.replace(qpos=qpos)


class ToolCenterPointInitializer:
  """Set arm joints so a site reaches a sampled target position
  (reference initializers/tcp_initializer.py:35), one target per lane."""

  def __init__(self, site_name: str, position, joint_mask=None,
               ik_steps: int = 30):
    self._site = site_name
    self._position = position
    self._joint_mask = joint_mask
    self._steps = ik_steps

  def __call__(self, m: Model, d: Data,
               generator: torch.Generator) -> Data:
    from dm_control_tpu_torch.utils import inverse_kinematics as ik
    target = _per_lane(self._position, generator, d.qpos, 3)
    result = ik.qpos_from_site_pose(
        m, d, self._site, target_pos=target,
        joint_mask=self._joint_mask, max_steps=self._steps)
    return d.replace(qpos=result.qpos)
