"""Arm/hand abstraction tier (reference entities/manipulators/base.py).

The port of `dm_control_tpu/entities/manipulators_base.py`.  The
reference's `RobotArm`/`RobotHand` ABCs (base.py:44,185) give every arm a
uniform surface (`joints`, `wrist_site`/`attachment_site`,
`randomize_arm_joints`, IK-driven `set_site_to_xpos`) and every hand
`set_grasp` and `tool_center_point`, so tasks compose against the
abstraction instead of a specific robot.

An arm or hand here is an `Entity` subclass carrying static metadata
(joint and site names, grasp ranges); every behavioral method takes
batched (Model, Data) and, where it draws, a torch.Generator, with the
names resolved against the compiled model.  The IK retry loop
(base.py:130-158: attempt IK, re-randomize the joints on failure) runs
every lane that has not reached the target again, up to the attempt
limit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dm_control_tpu_torch._src.types import Data, JointType, Model, mirror
from dm_control_tpu_torch.composer.entity import Entity

# points the pinch site straight down (reference base.py:36)
DOWN_QUATERNION = np.array([0., 0.70710678118, 0.70710678118, 0.])


def _resolve_joints(m: Model, names: Sequence[str],
                    prefix: Optional[str]) -> Tuple[np.ndarray, np.ndarray,
                                                    np.ndarray]:
  """(qadr, dadr, jids) for the arm's joints under the attach prefix."""
  qs, ds, js = [], [], []
  for nm in names:
    j = m.name2id('joint', f'{prefix}/{nm}' if prefix else nm)
    qs.append(int(m.jnt_qposadr[j]))
    ds.append(int(m.jnt_dofadr[j]))
    js.append(j)
  return np.asarray(qs), np.asarray(ds), np.asarray(js)


@dataclasses.dataclass
class RobotArm(Entity):
  """An attachable arm with the reference's RobotArm surface."""
  joint_names: Sequence[str] = ()
  wrist_site_name: str = ''

  @property
  def attachment_site(self) -> str:
    """Site name where a hand attaches (reference base.py:49)."""
    return self.wrist_site_name

  def _prefix(self, prefix: Optional[str]) -> Optional[str]:
    # attached entities are name-prefixed by default
    return self.name if prefix is None else (prefix or None)

  def joint_addrs(self, m: Model, prefix: Optional[str] = None):
    qs, ds, _ = _resolve_joints(m, self.joint_names, self._prefix(prefix))
    return qs, ds

  def joint_pos_sampling_bounds(self, m: Model,
                                prefix: Optional[str] = None) -> np.ndarray:
    """(2, n) lower/upper qpos bounds (reference base.py:53-77:
    unlimited hinges sample [0, 2pi); non-hinge joints must be
    limited)."""
    _, _, jids = _resolve_joints(m, self.joint_names, self._prefix(prefix))
    lo, hi = [], []
    for j in jids:
      if bool(m.jnt_limited[j]):
        lo.append(float(m.jnt_range[j, 0]))
        hi.append(float(m.jnt_range[j, 1]))
      elif JointType(int(m.jnt_type[j])) == JointType.HINGE:
        lo.append(0.0)
        hi.append(2 * np.pi)
      else:
        raise RuntimeError(
            f'non-hinge joint {j} must have limits (reference '
            f'base.py:38-40)')
    return np.stack([np.asarray(lo), np.asarray(hi)])

  def randomize_arm_joints(self, m: Model, d: Data,
                           generator: torch.Generator,
                           prefix: Optional[str] = None) -> Data:
    """Uniform joint randomization of every lane (reference
    base.py:79-89)."""
    qs, _ = self.joint_addrs(m, prefix)
    bounds = self.joint_pos_sampling_bounds(m, prefix)
    lo, hi = mirror(m, d.qpos, bounds[0]), mirror(m, d.qpos, bounds[1])
    u = torch.rand((d.qpos.shape[0], len(qs)), generator=generator,
                   dtype=d.qpos.dtype, device=d.qpos.device)
    qpos = d.qpos.clone()
    qpos[:, qs] = lo + (hi - lo) * u
    return d.replace(qpos=qpos)

  def set_site_to_xpos(self, m: Model, d: Data, generator: torch.Generator,
                       site_name: str, target_pos, target_quat='down',
                       max_ik_attempts: int = 10, pos_tol: float = 1e-3,
                       prefix: Optional[str] = None
                       ) -> Tuple[Data, torch.Tensor]:
    """IK the arm so `site_name` reaches target_pos/quat, re-randomizing
    a lane's joints between its attempts (reference base.py:91-160).
    Returns (Data, (B,) success).

    target_quat: 'down' (default) = the reference's vertically-down
    orientation; None = position-only IK (the right choice when the site
    frame's down-pointing quat differs from the reference hand's)."""
    from dm_control_tpu_torch._src import forward as fwd
    from dm_control_tpu_torch.utils import inverse_kinematics as ik

    if isinstance(target_quat, str) and target_quat == 'down':
      target_quat = DOWN_QUATERNION
    _, ds = self.joint_addrs(m, prefix)
    joint_mask = np.zeros(m.nv, bool)
    joint_mask[ds] = True
    ref = d.qpos
    target_pos = torch.as_tensor(target_pos, dtype=ref.dtype,
                                 device=ref.device)
    site = m.name2id('site', site_name)

    def attempt(qpos):
      res = ik.qpos_from_site_pose(
          m, d.replace(qpos=qpos), site_name, target_pos=target_pos,
          target_quat=target_quat, joint_mask=joint_mask, rot_weight=2.0)
      dd = fwd.forward(m, d.replace(qpos=res.qpos))
      return res.qpos, torch.linalg.vector_norm(
          dd.site_xpos[:, site] - target_pos, dim=-1)

    qpos = ref
    err = torch.full((ref.shape[0],), float('inf'), dtype=ref.dtype,
                     device=ref.device)
    for i in range(max_ik_attempts):
      todo = err > pos_tol
      if not bool(todo.any()):
        break
      start = qpos if i == 0 else self.randomize_arm_joints(
          m, d.replace(qpos=qpos), generator, prefix).qpos
      sol, e = attempt(start)
      qpos = torch.where(todo[:, None], sol, qpos)
      err = torch.where(todo, e, err)
    return d.replace(qpos=qpos), err <= pos_tol


@dataclasses.dataclass
class RobotHand(Entity):
  """An attachable hand (reference base.py:185-202): `set_grasp` maps a
  [0, 1] close factor onto each finger joint's range; the tool center
  point is a named site."""
  finger_joint_names: Sequence[str] = ()
  tool_center_point_name: str = ''
  # per-finger (open, closed) qpos; defaults to the joint range
  grasp_range: Optional[np.ndarray] = None

  @property
  def tool_center_point(self) -> str:
    return self.tool_center_point_name

  def set_grasp(self, m: Model, d: Data, close_factors,
                prefix: Optional[str] = None) -> Data:
    """close_factors: scalar, (n_fingers,) or (B, n_fingers) in [0, 1];
    0 = open, 1 = closed (reference base.py:188-199)."""
    pref = self.name if prefix is None else (prefix or None)
    qs, _, jids = _resolve_joints(m, self.finger_joint_names, pref)
    if self.grasp_range is not None:
      rng = np.asarray(self.grasp_range, np.float64)
    else:
      rng = np.asarray(m.jnt_range)[jids]
    ref = d.qpos
    f = torch.as_tensor(close_factors, dtype=ref.dtype, device=ref.device)
    f = f.expand(ref.shape[0], len(qs)) if f.ndim < 2 else f
    qpos = ref.clone()
    qpos[:, qs] = mirror(m, ref, rng[:, 0]) + f * mirror(
        m, ref, rng[:, 1] - rng[:, 0])
    return d.replace(qpos=qpos)
