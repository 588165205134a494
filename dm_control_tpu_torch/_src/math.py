"""Quaternion, rotation and 6-D spatial algebra primitives (torch).

The counterpart of `dm_control_tpu/_src/math.py`, for the functions the
walker and finger paths call.  Every function broadcasts over leading axes, so the
batch axis B rides along.  Conventions:

  * quaternions are (w, x, y, z), unit norm;
  * rotation matrices are world-from-local (R @ v_local = v_world);
  * 6-D motion vectors are [angular(3); linear(3)];
  * 6-D force  vectors are [torque(3);  force(3)];
  * spatial inertia about a frame origin is packed as a 10-vector:
      [Ixx, Ixy, Ixz, Iyy, Iyz, Izz, hx, hy, hz, m]
    with I the rotational inertia about the origin and h = m * c.

The JAX package's `safe_set`/`safe_add` are not carried over: they work
around an XLA:TPU scatter miscompile, and the port assigns by index.
"""

from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Cross product over the last axis, broadcasting the leading axes."""
  ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
  bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
  return torch.stack(
      [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
  """Safe unit-normalization along the last axis."""
  n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
  return v / torch.clamp(n, min=eps)


def norm_safe(v: torch.Tensor) -> torch.Tensor:
  """Norm along the last axis with a sqrt that is 0 at 0."""
  return torch.sqrt(torch.clamp((v * v).sum(-1), min=0.0))


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z).
# ---------------------------------------------------------------------------


def quat_mul(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
  """Hamilton product q * p."""
  qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
  pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
  return torch.stack([
      qw * pw - qx * px - qy * py - qz * pz,
      qw * px + qx * pw + qy * pz - qz * py,
      qw * py - qx * pz + qy * pw + qz * px,
      qw * pz + qx * py - qy * px + qz * pw,
  ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
  return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
  """3x3 rotation matrix -> unit quaternion (w, x, y, z), w >= 0: of the
  four constructions, the one with the largest pivot."""
  m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
  m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
  m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
  tr = m00 + m11 + m22
  cases = torch.stack([
      torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1),
      torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20],
                  -1),
      torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21],
                  -1),
      torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22],
                  -1)], dim=-2)
  pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
  best = pivots.argmax(dim=-1)
  q = torch.take_along_dim(cases, best[..., None, None], dim=-2)[..., 0, :]
  q = normalize(q)
  return torch.where(q[..., 0:1] < 0, -q, q)


def _quat_log_vel(dq: torch.Tensor) -> torch.Tensor:
  """2 * log(dq) as an axis * angle 3-vector, angle wrapped to [-pi, pi]."""
  sin_half = norm_safe(dq[..., 1:])
  axis = normalize(dq[..., 1:])
  angle = 2.0 * torch.atan2(sin_half, dq[..., 0])
  angle = torch.where(angle > torch.pi, angle - 2 * torch.pi, angle)
  return axis * angle[..., None]


def quat_sub_world(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
  """World-frame velocity taking qb to qa in unit time: log(qa * qb^-1),
  the frame of the angular Jacobian (`smooth.jac`'s jacr)."""
  return _quat_log_vel(quat_mul(qa, quat_conj(qb)))


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Rotate vector v by quaternion q (world = q * v_local)."""
  u = q[..., 1:]
  w = q[..., 0:1]
  uv = cross(u, v)
  return v + 2.0 * (w * uv + cross(u, uv))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
  """Unit quaternion -> 3x3 rotation matrix."""
  w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
  xx, yy, zz = x * x, y * y, z * z
  wx, wy, wz = w * x, w * y, w * z
  xy, xz, yz = x * y, x * z, y * z
  return torch.stack([
      torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
      torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
      torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
  ], dim=-2)


def mul33(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Batched (...,3,3) @ (...,3,3) as three multiply-adds."""
  return (a[..., :, 0:1] * b[..., 0:1, :]
          + a[..., :, 1:2] * b[..., 1:2, :]
          + a[..., :, 2:3] * b[..., 2:3, :])


def rot3(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Batched (...,3,3) @ (...,3) matvec as three multiply-adds."""
  return (a[..., :, 0] * v[..., 0:1] + a[..., :, 1] * v[..., 1:2]
          + a[..., :, 2] * v[..., 2:3])


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor
                       ) -> torch.Tensor:
  """Unit axis + angle -> quaternion."""
  half = angle * 0.5
  s = torch.sin(half)
  c = torch.cos(half)
  return torch.cat([c[..., None], axis * s[..., None]], dim=-1)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
  """Integrate quaternion by local-frame angular velocity `omega` over dt."""
  theta = norm_safe(omega) * dt
  axis = normalize(omega)
  nq = quat_mul(q, axis_angle_to_quat(axis, theta))
  nq = torch.where(theta[..., None] > 0.0, nq, q)
  return normalize(nq)


# ---------------------------------------------------------------------------
# 6-D spatial algebra ([angular; linear] motion, [torque; force] force).
# ---------------------------------------------------------------------------


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
  """Spatial cross product of motion vectors: v x m."""
  vang, vlin = v[..., :3], v[..., 3:]
  mang, mlin = m[..., :3], m[..., 3:]
  ang = cross(vang, mang)
  lin = cross(vlin, mang) + cross(vang, mlin)
  return torch.cat([ang, lin], dim=-1)


def motion_cross_force(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
  """Spatial cross product applied to a force vector: v x* f."""
  vang, vlin = v[..., :3], v[..., 3:]
  ftrq, flin = f[..., :3], f[..., 3:]
  trq = cross(vang, ftrq) + cross(vlin, flin)
  lin = cross(vang, flin)
  return torch.cat([trq, lin], dim=-1)


# --- 10-vector spatial inertia -------------------------------------------


def inert_pack(inertia: torch.Tensor, h: torch.Tensor, mass: torch.Tensor
               ) -> torch.Tensor:
  """Pack (3x3 inertia about origin, first moment h, mass) -> 10-vector."""
  i = torch.stack([
      inertia[..., 0, 0], inertia[..., 0, 1], inertia[..., 0, 2],
      inertia[..., 1, 1], inertia[..., 1, 2], inertia[..., 2, 2]], dim=-1)
  return torch.cat([i, h, mass[..., None]], dim=-1)


def inert_unpack(cin: torch.Tensor):
  """10-vector -> (3x3 inertia, h, mass)."""
  ixx, ixy, ixz = cin[..., 0], cin[..., 1], cin[..., 2]
  iyy, iyz, izz = cin[..., 3], cin[..., 4], cin[..., 5]
  inertia = torch.stack([
      torch.stack([ixx, ixy, ixz], -1),
      torch.stack([ixy, iyy, iyz], -1),
      torch.stack([ixz, iyz, izz], -1)], dim=-2)
  return inertia, cin[..., 6:9], cin[..., 9]


def inert_from_body(mass: torch.Tensor, diag_inertia: torch.Tensor,
                    imat: torch.Tensor, ipos: torch.Tensor) -> torch.Tensor:
  """Spatial inertia 10-vector about a frame origin.

  mass (...,), diag_inertia (..., 3) principal inertia at the com, imat
  (..., 3, 3) world-from-inertial rotation, ipos (..., 3) com offset.
  """
  # I_origin = R diag R^T + m * (c.c 1 - c c^T)   (parallel axis)
  i_com = torch.einsum('...ik,...k,...jk->...ij', imat, diag_inertia, imat)
  c = ipos
  cc = c[..., :, None] * c[..., None, :]
  c2 = (c * c).sum(-1)[..., None, None]
  eye = torch.eye(3, dtype=c.dtype, device=c.device)
  i_origin = i_com + mass[..., None, None] * (c2 * eye - cc)
  h = mass[..., None] * c
  return inert_pack(i_origin, h, mass.expand(h.shape[:-1]))


def inert_mul(cin: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
  """10-vector spatial inertia times a motion vector -> force vector:
  f = [I w + h x v;  m v - h x w]   with vec = [w; v]."""
  inertia, h, mass = inert_unpack(cin)
  w, v = vec[..., :3], vec[..., 3:]
  trq = rot3(inertia, w) + cross(h, v)
  lin = mass[..., None] * v - cross(h, w)
  return torch.cat([trq, lin], dim=-1)


def transform_motion(vec: torch.Tensor, offset: torch.Tensor,
                     rot: torch.Tensor | None = None) -> torch.Tensor:
  """A motion vector [ang; lin] moved to a frame origin `offset` away
  (new origin - old, world frame): lin' = lin - offset x ang; with `rot`,
  then rotated into that frame (rot @ ang, rot @ lin)."""
  ang, lin = vec[..., :3], vec[..., 3:]
  lin = lin - cross(offset, ang)
  if rot is not None:
    ang = rot3(rot, ang)
    lin = rot3(rot, lin)
  return torch.cat([ang, lin], dim=-1)


def transform_force(vec: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
  """A force vector [trq; lin] moved to a frame origin `offset` away (new
  origin - old, world frame): trq' = trq - offset x lin."""
  trq, lin = vec[..., :3], vec[..., 3:]
  return torch.cat([trq - cross(offset, lin), lin], dim=-1)


# ---------------------------------------------------------------------------
# Segments.
# ---------------------------------------------------------------------------


def closest_segment_point(a: torch.Tensor, b: torch.Tensor,
                          pt: torch.Tensor) -> torch.Tensor:
  """Closest point on segment [a, b] to point pt."""
  ab = b - a
  denom = (ab * ab).sum(-1, keepdim=True)
  t = ((pt - a) * ab).sum(-1, keepdim=True) / torch.clamp(denom, min=1e-12)
  return a + torch.clamp(t, 0.0, 1.0) * ab


def closest_segment_to_segment_points(p1, q1, p2, q2):
  """Closest points between segments [p1,q1] and [p2,q2] (branch-free)."""
  d1 = q1 - p1
  d2 = q2 - p2
  r = p1 - p2
  a = (d1 * d1).sum(-1)
  e = (d2 * d2).sum(-1)
  f = (d2 * r).sum(-1)
  c = (d1 * r).sum(-1)
  b = (d1 * d2).sum(-1)
  denom = a * e - b * b
  eps = 1e-12
  s = torch.where(denom > eps,
                  (b * f - c * e) / torch.clamp(denom, min=eps), 0.0)
  s = torch.clamp(s, 0.0, 1.0)
  t = torch.clamp((b * s + f) / torch.clamp(e, min=eps), 0.0, 1.0)
  # re-project s for the clamped t
  s = torch.clamp((b * t - c) / torch.clamp(a, min=eps), 0.0, 1.0)
  return p1 + d1 * s[..., None], p2 + d2 * t[..., None]
