"""Inverse kinematics: damped least-squares site posing.

The port of `dm_control_tpu/utils/inverse_kinematics.py`, the reference's
dm_control/utils/inverse_kinematics.py:42-235 (`qpos_from_site_pose`,
regularized Jacobian steps) as a fixed-iteration solver over every lane
of a batched Data at once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dm_control_tpu_torch._src import forward as _forward
from dm_control_tpu_torch._src import math as _math
from dm_control_tpu_torch._src import smooth as _smooth
from dm_control_tpu_torch._src.types import Data, Model, mirror


@dataclasses.dataclass
class IKResult:
  qpos: torch.Tensor       # (B, nq)
  err_norm: torch.Tensor   # (B,)
  steps: int
  success: torch.Tensor    # (B,) bool


def qpos_from_site_pose(
    m: Model,
    d: Data,
    site_name: str,
    target_pos=None,
    target_quat=None,
    joint_mask: Optional[np.ndarray] = None,
    tol: float = 1e-14,
    rot_weight: float = 1.0,
    regularization_strength: float = 3e-2,
    max_steps: int = 100,
    max_update_norm: float = 2.0,
) -> IKResult:
  """Iterate each lane's qpos so the site reaches target_pos and/or
  target_quat ((3,) and (4,), or (B, 3) and (B, 4) per lane).

  Fixed max_steps iterations; `joint_mask` (nv bool) restricts which dofs
  move, like the reference's joint_names argument.  A lane stops moving
  once its error is at or below `tol`.
  """
  if target_pos is None and target_quat is None:
    raise ValueError('need target_pos and/or target_quat')
  site = m.name2id('site', site_name)
  ref = d.qpos
  B = ref.shape[0]
  mask = (mirror(m, ref, np.asarray(joint_mask, np.float64))
          if joint_mask is not None else ref.new_ones(m.nv))
  bodyid = int(m.site_bodyid[site])

  def per_lane(x, n):
    x = torch.as_tensor(x, dtype=ref.dtype, device=ref.device)
    return x.expand(B, n)

  if target_pos is not None:
    target_pos = per_lane(target_pos, 3)
  if target_quat is not None:
    target_quat = per_lane(target_quat, 4)

  def err_and_jac(qpos):
    dd = d.replace(qpos=qpos)
    dd = _smooth.kinematics(m, dd)
    dd = _smooth.com_pos(m, dd)
    x = dd.site_xpos[:, site]
    jacp, jacr = _smooth.jac(m, dd, x, bodyid)       # (B, nv, 3)
    rows, errs = [], []
    if target_pos is not None:
      rows.append(jacp.transpose(1, 2))
      errs.append(target_pos - x)
    if target_quat is not None:
      site_quat = _math.mat_to_quat(dd.site_xmat[:, site])
      # world-frame rotational error to match the world-frame jacr
      rows.append(jacr.transpose(1, 2) * rot_weight)
      errs.append(_math.quat_sub_world(target_quat, site_quat) * rot_weight)
    return torch.cat(errs, -1), torch.cat(rows, 1) * mask

  qpos = ref
  for _ in range(max_steps):
    err, jac = err_and_jac(qpos)
    err_norm = torch.linalg.vector_norm(err, dim=-1)
    # damped least squares: dq = J^T (J J^T + lambda I)^-1 err
    jjt = jac @ jac.transpose(1, 2)
    reg = regularization_strength * torch.eye(
        jjt.shape[-1], dtype=ref.dtype, device=ref.device)
    dq = (jac.transpose(1, 2) @ torch.linalg.solve(
        jjt + reg, err[..., None]))[..., 0]
    dq_norm = torch.linalg.vector_norm(dq, dim=-1, keepdim=True)
    dq = dq * torch.clamp(max_update_norm / dq_norm.clamp(min=1e-14),
                          max=1.0)
    new_qpos = _forward._integrate_pos(m, qpos, dq * mask, 1.0)
    qpos = torch.where((err_norm > tol)[:, None], new_qpos, qpos)
  err_norm = torch.linalg.vector_norm(err_and_jac(qpos)[0], dim=-1)
  return IKResult(qpos=qpos, err_norm=err_norm, steps=max_steps,
                  success=err_norm < 1e-3)
