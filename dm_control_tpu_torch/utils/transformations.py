"""Rigid-body transformation utilities (torch).

The port of `dm_control_tpu/utils/transformations.py`, the semantics of
the reference's dm_control/utils/transformations.py:66-594: quaternion
algebra, rotation-matrix and Euler-angle conversions (all seven
orderings), homogeneous transforms.  Every function broadcasts over
leading axes and takes tensors (or anything `torch.as_tensor` takes).
"""

from __future__ import annotations

import torch

from dm_control_tpu_torch._src import math as _math

# the core quaternion ops under the reference's names
quat_conj = _math.quat_conj
quat_mul = _math.quat_mul
quat_rotate = _math.quat_rotate
quat_to_mat3 = _math.quat_to_mat
mat3_to_quat = _math.mat_to_quat
axisangle_to_quat_split = _math.axis_angle_to_quat


def _t(x) -> torch.Tensor:
  return x if isinstance(x, torch.Tensor) else torch.as_tensor(
      x, dtype=torch.get_default_dtype())


def quat_inv(q):
  q = _t(q)
  return _math.quat_conj(q) / (q * q).sum(-1, keepdim=True)


def quat_diff(source, target):
  """Quaternion that rotates source to target: conj(source) * target."""
  return _math.quat_mul(_math.quat_conj(_t(source)), _t(target))


def quat_dist(source, target):
  """Angular distance (radians) between two unit quaternions."""
  d = quat_diff(_math.normalize(_t(source)), _math.normalize(_t(target)))
  return 2.0 * torch.atan2(_math.norm_safe(d[..., 1:]), d[..., 0].abs())


def quat_angle(q):
  """Rotation angle of a unit quaternion."""
  q = _t(q)
  return 2.0 * torch.atan2(_math.norm_safe(q[..., 1:]), q[..., 0].abs())


def quat_axis(q):
  """Rotation axis of a unit quaternion."""
  return _math.normalize(_t(q)[..., 1:])


def axisangle_to_quat(axisangle):
  """3-vector whose norm is the angle -> quaternion."""
  axisangle = _t(axisangle)
  angle = _math.norm_safe(axisangle)
  axis = _math.normalize(axisangle)
  q = _math.axis_angle_to_quat(axis, angle)
  return torch.where(angle[..., None] > 0, q,
                     q.new_tensor([1.0, 0, 0, 0]).expand(q.shape))


def quat_to_axisangle(q):
  """Quaternion -> 3-vector whose norm is the angle."""
  q = _t(q)
  angle = quat_angle(q)
  sign = torch.sign(q[..., 0:1])
  axis = _math.normalize(q[..., 1:] * sign)
  return axis * angle[..., None]


def _embed4(r3: torch.Tensor) -> torch.Tensor:
  out = r3.new_zeros(r3.shape[:-2] + (4, 4))
  out[..., :3, :3] = r3
  out[..., 3, 3] = 1.0
  return out


def quat_to_mat(q):
  """Quaternion -> 4x4 homogeneous rotation matrix."""
  return _embed4(_math.quat_to_mat(_t(q)))


def mat_to_quat(m):
  """3x3 or 4x4 rotation matrix -> quaternion."""
  return _math.mat_to_quat(_t(m)[..., :3, :3])


def quat_slerp(q0, q1, t):
  """Spherical linear interpolation between unit quaternions."""
  q0, q1 = _t(q0), _t(q1)
  t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
  dot = (q0 * q1).sum(-1, keepdim=True)
  q1 = torch.where(dot < 0, -q1, q1)
  dot = dot.abs()
  theta = torch.arccos(dot.clamp(-1.0, 1.0))
  sin_theta = torch.sin(theta)
  near = sin_theta < 1e-7
  w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta)
                   / sin_theta.clamp(min=1e-12))
  w1 = torch.where(near, t, torch.sin(t * theta) / sin_theta.clamp(min=1e-12))
  return _math.normalize(w0 * q0 + w1 * q1)


# --- Euler conversions -----------------------------------------------------

_AXES = {'X': (1.0, 0.0, 0.0), 'Y': (0.0, 1.0, 0.0), 'Z': (0.0, 0.0, 1.0)}
_ORDERINGS = ('XYZ', 'XYX', 'XZY', 'ZYX', 'YZX', 'ZXY', 'YXZ')


def _axis_rot(axis: str, angle: torch.Tensor) -> torch.Tensor:
  a = angle.new_tensor(_AXES[axis]).expand(angle.shape + (3,))
  return _math.quat_to_mat(_math.axis_angle_to_quat(a, angle))


def euler_to_rmat(euler_vec, ordering: str = 'ZYX'):
  """Euler angles -> 3x3 rotation matrix.

  `ordering` gives intrinsic rotations applied in sequence (reference
  transformations.py semantics: R = R(a0) @ R(a1) @ R(a2))."""
  if ordering.upper() not in _ORDERINGS and len(ordering) != 3:
    raise ValueError(f'bad ordering {ordering}')
  euler_vec = _t(euler_vec)
  r = None
  for i, ax in enumerate(ordering.upper()):
    ri = _axis_rot(ax, euler_vec[..., i])
    r = ri if r is None else r @ ri
  return r


def euler_to_quat(euler_vec, ordering: str = 'ZYX'):
  return _math.mat_to_quat(euler_to_rmat(euler_vec, ordering))


def rmat_to_euler(rmat, ordering: str = 'ZYX'):
  """3x3 rotation matrix -> Euler angles for the given ordering (the
  reference's extraction rules, transformations.py:93-238, in their
  non-degenerate branch; gimbal poles resolve through atan2)."""
  r = _t(rmat)
  atan2 = torch.atan2

  def sqrt_sum(a, b):
    return torch.sqrt((a ** 2 + b ** 2).clamp(min=1e-24))

  if ordering == 'ZYX':
    y = atan2(-r[..., 2, 0], sqrt_sum(r[..., 0, 0], r[..., 1, 0]))
    return torch.stack([atan2(r[..., 1, 0], r[..., 0, 0]), y,
                        atan2(r[..., 2, 1], r[..., 2, 2])], -1)
  if ordering == 'XYZ':
    y = atan2(r[..., 0, 2], sqrt_sum(r[..., 0, 0], r[..., 0, 1]))
    return torch.stack([atan2(-r[..., 1, 2], r[..., 2, 2]), y,
                        atan2(-r[..., 0, 1], r[..., 0, 0])], -1)
  if ordering == 'ZXY':
    x = atan2(r[..., 2, 1], sqrt_sum(r[..., 0, 1], r[..., 1, 1]))
    return torch.stack([atan2(-r[..., 0, 1], r[..., 1, 1]), x,
                        atan2(-r[..., 2, 0], r[..., 2, 2])], -1)
  if ordering == 'XYX':
    y = torch.arccos(r[..., 0, 0].clamp(-1.0, 1.0))
    return torch.stack([atan2(r[..., 1, 0], -r[..., 2, 0]), y,
                        atan2(r[..., 0, 1], r[..., 0, 2])], -1)
  if ordering == 'XZY':
    y = atan2(r[..., 0, 2], r[..., 0, 0])
    z = -torch.arcsin(r[..., 0, 1].clamp(-1.0, 1.0))
    return torch.stack([atan2(r[..., 2, 1], r[..., 1, 1]), z, y], -1)
  if ordering == 'YZX':
    x = -atan2(r[..., 1, 2], r[..., 1, 1])
    z = torch.arcsin(r[..., 1, 0].clamp(-1.0, 1.0))
    return torch.stack([-atan2(r[..., 2, 0], r[..., 0, 0]), z, x], -1)
  if ordering == 'YXZ':
    x = -torch.arcsin(r[..., 1, 2].clamp(-1.0, 1.0))
    return torch.stack([atan2(r[..., 0, 2], r[..., 2, 2]), x,
                        atan2(r[..., 1, 0], r[..., 1, 1])], -1)
  raise NotImplementedError(f'rmat_to_euler ordering {ordering}')


def quat_to_euler(q, ordering: str = 'ZYX'):
  return rmat_to_euler(_math.quat_to_mat(_t(q)), ordering)


def quat_log(q, tol: float = 1e-10):
  """Quaternion logarithm (reference transformations.py:371 semantics)."""
  q = _t(q)
  q_norm = torch.sqrt((q * q).sum(-1, keepdim=True).clamp(min=tol))
  v = q[..., 1:]
  v_norm = torch.sqrt((v * v).sum(-1, keepdim=True).clamp(min=tol))
  angle = torch.arccos((q[..., 0:1] / q_norm).clamp(-1.0, 1.0))
  return torch.cat([torch.log(q_norm), v / v_norm * angle], dim=-1)


def rotation_x_axis(theta, full: bool = False):
  """Rotation about X; full=True embeds into a 4x4 homogeneous matrix."""
  r = _axis_rot('X', _t(theta))
  return _embed4(r) if full else r


def rotation_y_axis(theta, full: bool = False):
  r = _axis_rot('Y', _t(theta))
  return _embed4(r) if full else r


def rotation_z_axis(theta, full: bool = False):
  r = _axis_rot('Z', _t(theta))
  return _embed4(r) if full else r


def rotation_matrix_2d(theta):
  theta = _t(theta)
  ct, st = torch.cos(theta), torch.sin(theta)
  return torch.stack([torch.stack([ct, -st], -1),
                      torch.stack([st, ct], -1)], -2)


def pos_quat_to_hmat(pos, quat):
  """Position + quaternion -> 4x4 homogeneous transform."""
  out = quat_to_mat(quat)
  out[..., :3, 3] = _t(pos)
  return out


def hmat_inv(h):
  h = _t(h)
  rt = h[..., :3, :3].transpose(-1, -2)
  out = torch.zeros_like(h)
  out[..., :3, :3] = rt
  out[..., :3, 3] = -(rt @ h[..., :3, 3:4])[..., 0]
  out[..., 3, 3] = 1.0
  return out
