"""Vectorized narrowphase colliders (torch).

The port of the parts of `dm_control_tpu/_src/colliders.py` the ported
tasks reach: contact-parameter mixing, the contact frame, the
plane-sphere, plane-capsule, plane-ellipsoid, plane-cylinder,
sphere-sphere, sphere-capsule, sphere-ellipsoid, sphere-cylinder,
capsule-capsule, capsule-ellipsoid, capsule-cylinder,
ellipsoid-ellipsoid, ellipsoid-cylinder and cylinder-cylinder colliders,
the box colliders (plane-box, sphere-box, capsule-box, ellipsoid-box,
cylinder-box and box-box, the last with its separating-axis test and face
clipping written once over a batch of pairs), the heightfield against spheres, capsules, ellipsoids and
cylinders (`hfield_height`, per lane where `model_var` carries
`hfield_data`), convex meshes against planes, spheres, capsules, boxes
and meshes (Frank-Wolfe over the hull vertices, `hull_table`), the top-K
broadphase score and the `collide_all` dispatch.  A collider returns
either one normal or a whole frame per contact; `collide_all` builds the
frame from a normal.  Every other geom-type pair raises
NotImplementedError naming the pair.
"""

from __future__ import annotations

import numpy as np
import torch

from dm_control_tpu_torch._src import math
from dm_control_tpu_torch._src.types import (Contact, Data, GeomType, Model,
                                             mirror)


def _combine_params(m: Model, g1: int, g2: int, pairinfo):
  """(condim, friction(5), solref(2), solimp(5), margin, gap) for a pair."""
  if pairinfo is not None:
    return (pairinfo['condim'], pairinfo['friction'], pairinfo['solref'],
            pairinfo['solimp'], pairinfo['margin'], pairinfo['gap'])
  p1, p2 = int(m.geom_priority[g1]), int(m.geom_priority[g2])
  if p1 != p2:
    g = g1 if p1 > p2 else g2
    condim = int(m.geom_condim[g])
    fr3 = m.geom_friction[g]
    solref = m.geom_solref[g]
    solimp = m.geom_solimp[g]
  else:
    condim = max(int(m.geom_condim[g1]), int(m.geom_condim[g2]))
    fr3 = np.maximum(m.geom_friction[g1], m.geom_friction[g2])
    # solmix weighting
    s1, s2 = float(m.geom_solmix[g1]), float(m.geom_solmix[g2])
    mix = s1 / (s1 + s2) if (s1 + s2) > 1e-12 else 0.5
    if m.geom_solref[g1, 0] > 0 and m.geom_solref[g2, 0] > 0:
      solref = mix * m.geom_solref[g1] + (1 - mix) * m.geom_solref[g2]
    else:
      solref = np.minimum(m.geom_solref[g1], m.geom_solref[g2])
    solimp = mix * m.geom_solimp[g1] + (1 - mix) * m.geom_solimp[g2]
  friction = np.array([fr3[0], fr3[0], fr3[1], fr3[2], fr3[2]])
  margin = max(float(m.geom_margin[g1]), float(m.geom_margin[g2]))
  gap = max(float(m.geom_gap[g1]), float(m.geom_gap[g2]))
  return condim, friction, solref, solimp, margin, gap


def make_frame(normal: torch.Tensor) -> torch.Tensor:
  """(..., 3, 3) frame with rows (normal, tangent1, tangent2).

  The auxiliary seed is the world y axis unless |n_y| > 0.5, then z;
  t2 = normalize(n x seed), t1 = t2 x n (the oracle's mju_makeFrame)."""
  n = math.normalize(normal)
  zero, one = torch.zeros_like(n[..., 0]), torch.ones_like(n[..., 0])
  z = torch.stack([zero, zero, one], -1)
  y = torch.stack([zero, one, zero], -1)
  seed = torch.where(n[..., 1:2].abs() > 0.5, z, y)
  t2 = math.normalize(math.cross(n, seed))
  t1 = math.cross(t2, n)
  return torch.stack([n, t1, t2], dim=-2)


def _plane_sphere(p_pos, p_mat, p_size, s_pos, s_mat, s_size):
  """One contact at the sphere's point nearest the plane."""
  n = p_mat[..., :, 2]
  h = (n * (s_pos - p_pos)).sum(-1)
  r = s_size[..., 0]
  dist = h - r
  pos = s_pos - n * (r + dist / 2)[..., None]
  return dist[..., None], pos[..., None, :], n[..., None, :]


def _sphere_sphere(pos1, mat1, size1, pos2, mat2, size2):
  """One contact on the line between the centers."""
  r1, r2 = size1[..., 0], size2[..., 0]
  vec = pos2 - pos1
  n = math.normalize(vec)
  dist = math.norm_safe(vec) - r1 - r2
  pos = pos1 + n * (r1 + dist / 2)[..., None]
  return dist[..., None], pos[..., None, :], n[..., None, :]


def _sphere_capsule(s_pos, s_mat, s_size, c_pos, c_mat, c_size):
  """Sphere vs the sphere of the capsule's radius at the axis point
  nearest the sphere's center."""
  axis = c_mat[..., :, 2]
  hl = c_size[..., 1:2]
  closest = math.closest_segment_point(c_pos - hl * axis, c_pos + hl * axis,
                                       s_pos)
  return _sphere_sphere(s_pos, s_mat, s_size, closest, c_mat,
                        c_size.expand(s_size.shape))


def _sphere_ellipsoid(s_pos, s_mat, s_size, e_pos, e_mat, e_size):
  """Sphere vs ellipsoid through the radial projection of the sphere's
  center onto the surface (exact for spheres)."""
  r_s = s_size[..., 0]
  local = torch.einsum('...ij,...i->...j', e_mat, s_pos - e_pos)
  u = local / e_size
  un = math.norm_safe(u)
  surf_l = e_size * (u / torch.clamp(un, min=1e-12)[..., None])
  # the gradient of the implicit function: the outward normal
  n_l = math.normalize(surf_l / (e_size * e_size))
  d_out = math.norm_safe(local - surf_l)
  dist = torch.where(un < 1.0, -d_out, d_out) - r_s
  n = torch.einsum('...ij,...j->...i', e_mat, -n_l)  # sphere -> ellipsoid
  surf = e_pos + torch.einsum('...ij,...j->...i', e_mat, surf_l)
  pos = (surf + s_pos + n * r_s[..., None]) / 2
  return dist[..., None], pos[..., None, :], n[..., None, :]


def _capsule_ellipsoid(c_pos, c_mat, c_size, e_pos, e_mat, e_size):
  """Sphere-ellipsoid at the capsule's axis point nearest the
  ellipsoid's center."""
  axis = c_mat[..., :, 2]
  hl = c_size[..., 1:2]
  closest = math.closest_segment_point(c_pos - hl * axis, c_pos + hl * axis,
                                       e_pos)
  return _sphere_ellipsoid(closest, c_mat, c_size, e_pos, e_mat, e_size)


def _ellipsoid_ellipsoid(pos1, mat1, size1, pos2, mat2, size2):
  """Two spheres along the center line, each of its ellipsoid's radius in
  that direction."""
  vec = pos2 - pos1
  n = math.normalize(vec)
  d1 = torch.einsum('...ij,...i->...j', mat1, n)
  d2 = torch.einsum('...ij,...i->...j', mat2, n)
  r1 = 1.0 / torch.clamp(math.norm_safe(d1 / size1), min=1e-12)
  r2 = 1.0 / torch.clamp(math.norm_safe(d2 / size2), min=1e-12)
  dist = math.norm_safe(vec) - r1 - r2
  pos = pos1 + n * (r1 + dist / 2)[..., None]
  return dist[..., None], pos[..., None, :], n[..., None, :]


def _plane_capsule(p_pos, p_mat, p_size, c_pos, c_mat, c_size):
  """Two contacts, one at each capsule end; frame t1 along the projected
  capsule axis (the generic frame when the axis is near the normal)."""
  n = p_mat[..., :, 2]
  axis = c_mat[..., :, 2]
  r = c_size[..., 0]
  hl = c_size[..., 1]
  axp = axis - n * (axis * n).sum(-1, keepdim=True)
  ok = (axp * axp).sum(-1, keepdim=True) > 1e-12
  t1 = torch.where(ok, math.normalize(axp), make_frame(n)[..., 1, :])
  t2 = math.cross(n, t1)
  frame = torch.stack([n, t1, t2], dim=-2)
  dists, poss = [], []
  for sign in (1.0, -1.0):
    end = c_pos + sign * hl[..., None] * axis
    h = (n * (end - p_pos)).sum(-1)
    dist = h - r
    dists.append(dist)
    poss.append(end - n * (r + dist / 2)[..., None])
  return (torch.stack(dists, -1), torch.stack(poss, -2),
          torch.stack([frame, frame], -3))


def _plane_ellipsoid(p_pos, p_mat, p_size, e_pos, e_mat, e_size):
  """One contact at the ellipsoid's support point along -normal."""
  n = p_mat[..., :, 2]
  nl = torch.einsum('...ij,...i->...j', e_mat, n)   # n in the ellipsoid frame
  denom = math.norm_safe(nl * e_size)
  sp_l = -(e_size * e_size * nl) / torch.clamp(denom, min=1e-12)[..., None]
  sp = e_pos + torch.einsum('...ij,...j->...i', e_mat, sp_l)
  dist = (n * (sp - p_pos)).sum(-1)
  pos = sp - n * (dist / 2)[..., None]
  return dist[..., None], pos[..., None, :], n[..., None, :]


def _plane_cylinder(p_pos, p_mat, p_size, c_pos, c_mat, c_size):
  """Up to 4 contacts: two rim points at each end cap (approximate rim)."""
  n = p_mat[..., :, 2]
  axis = c_mat[..., :, 2]
  r = c_size[..., 0]
  hl = c_size[..., 1]
  # radial direction: -n projected onto the plane perpendicular to the axis
  proj = -n + axis * (n * axis).sum(-1, keepdim=True)
  pnorm = math.norm_safe(proj)
  # axis ~ parallel to n: any radial direction
  safe = (pnorm > 1e-8)[..., None]
  radial = torch.where(safe, proj / torch.clamp(pnorm, min=1e-12)[..., None],
                       c_mat[..., :, 0])
  dists, poss = [], []
  for sign_end in (1.0, -1.0):
    end = c_pos + sign_end * hl[..., None] * axis
    for sign_rad in (1.0, -1.0):
      p = end + sign_rad * r[..., None] * radial
      h = (n * (p - p_pos)).sum(-1)
      dists.append(h)
      poss.append(p - n * (h / 2)[..., None])
  return (torch.stack(dists, -1), torch.stack(poss, -2),
          torch.stack([n] * 4, -2))


def _capsule_capsule(pos1, mat1, size1, pos2, mat2, size2):
  """One contact between the closest points of the two axes; the second
  slot is inactive padding."""
  ax1, ax2 = mat1[..., :, 2], mat2[..., :, 2]
  h1, h2 = size1[..., 1:2], size2[..., 1:2]
  c1, c2 = math.closest_segment_to_segment_points(
      pos1 - h1 * ax1, pos1 + h1 * ax1, pos2 - h2 * ax2, pos2 + h2 * ax2)
  r1, r2 = size1[..., 0], size2[..., 0]
  vec = c2 - c1
  n = math.normalize(vec)
  dist = math.norm_safe(vec) - r1 - r2
  pos = c1 + n * (r1 + dist / 2)[..., None]
  big = torch.full_like(dist, 1e10)
  return (torch.stack([dist, big], -1), torch.stack([pos, pos], -2),
          torch.stack([n, n], -2))


def _sphere_cylinder(s_pos, s_mat, s_size, c_pos, c_mat, c_size):
  """Sphere vs solid cylinder: side, cap and rim cases, branch-free."""
  r_s = s_size[..., 0]
  R = c_size[..., 0]
  hl = c_size[..., 1]
  local = torch.einsum('...ij,...i->...j', c_mat, s_pos - c_pos)
  xy = local[..., :2]
  z = local[..., 2]
  r_xy = math.norm_safe(xy)
  u_xy = xy / torch.clamp(r_xy, min=1e-12)[..., None]

  inside = (r_xy < R) & (z.abs() < hl)
  # outside: clamp to the solid cylinder
  xy_c = torch.where((r_xy > R)[..., None], u_xy * R[..., None], xy)
  z_c = torch.maximum(torch.minimum(z, hl), -hl)
  closest_out = torch.cat([xy_c, z_c[..., None]], -1)
  d_out = math.norm_safe(local - closest_out)
  n_out = (local - closest_out) / torch.clamp(d_out, min=1e-12)[..., None]

  # inside: push out through the nearest face (side vs cap)
  d_side = R - r_xy
  d_cap = hl - z.abs()
  use_side = d_side < d_cap
  zero = torch.zeros_like(z)[..., None]
  n_in = torch.where(use_side[..., None], torch.cat([u_xy, zero], -1),
                     torch.cat([torch.zeros_like(xy), torch.sign(z)[..., None]],
                               -1))
  d_in = -torch.where(use_side, d_side, d_cap)
  closest_in = torch.where(
      use_side[..., None], torch.cat([u_xy * R[..., None], z[..., None]], -1),
      torch.cat([xy, (torch.sign(z) * hl)[..., None]], -1))

  dist = torch.where(inside, d_in, d_out) - r_s
  n_l = torch.where(inside[..., None], n_in, n_out)
  surf_l = torch.where(inside[..., None], closest_in, closest_out)
  # normal from the sphere (geom1) to the cylinder (geom2) = -outward
  n = torch.einsum('...ij,...j->...i', c_mat, -n_l)
  surf = c_pos + torch.einsum('...ij,...j->...i', c_mat, surf_l)
  pos = (surf + s_pos + n * r_s[..., None]) / 2
  return dist[..., None], pos[..., None, :], n[..., None, :]


def _capsule_cylinder(cp_pos, cp_mat, cp_size, cy_pos, cy_mat, cy_size):
  """Capsule vs cylinder: sphere-cylinder at the closest capsule point."""
  ax_cp, ax_cy = cp_mat[..., :, 2], cy_mat[..., :, 2]
  h_cp, h_cy = cp_size[..., 1:2], cy_size[..., 1:2]
  c1, _ = math.closest_segment_to_segment_points(
      cp_pos - h_cp * ax_cp, cp_pos + h_cp * ax_cp,
      cy_pos - h_cy * ax_cy, cy_pos + h_cy * ax_cy)
  d, p, n = _sphere_cylinder(c1, cp_mat, cp_size, cy_pos, cy_mat, cy_size)
  return (torch.cat([d, torch.full_like(d, 1e10)], -1),
          torch.cat([p, p], -2), torch.cat([n, n], -2))


_RIM_SAMPLES = 8


def _rim_points(pos, mat, r, h):
  """(..., 2 * _RIM_SAMPLES, 3) world points on both rim circles."""
  ang = np.linspace(0, 2 * np.pi, _RIM_SAMPLES, endpoint=False)
  circ = np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)], -1)
  # (2, K, 3) local offsets for unit radius / unit half-length
  circ = torch.as_tensor(circ, dtype=pos.dtype, device=pos.device)
  ends = torch.as_tensor([-1.0, 1.0], dtype=pos.dtype, device=pos.device)
  ez = torch.as_tensor([0.0, 0.0, 1.0], dtype=pos.dtype, device=pos.device)
  local = (r[..., None, None, None] * circ
           + h[..., None, None] * ends[:, None, None] * ez)
  local = local.reshape(local.shape[:-3] + (2 * _RIM_SAMPLES, 3))
  return pos[..., None, :] + torch.einsum('...ij,...kj->...ki', mat, local)


def _deepest_point(points, c_pos, c_mat, c_size):
  """Deepest of the points (..., k, 3) vs a solid cylinder:
  (dist (..., 1), pos (..., 1, 3), normal (..., 1, 3))."""
  shape = points.shape[:-1]
  cpos_b = c_pos[..., None, :].expand(points.shape)
  cmat_b = c_mat[..., None, :, :].expand(shape + (3, 3))
  csize_b = c_size[..., None, :].expand(shape + (c_size.shape[-1],))
  ssize_b = points.new_zeros(shape + (c_size.shape[-1],))
  d, p, n = _sphere_cylinder(points, cmat_b, ssize_b, cpos_b, cmat_b, csize_b)
  d, p, n = d[..., 0], p[..., 0, :], n[..., 0, :]
  i = torch.argmin(d, dim=-1, keepdim=True)
  return (torch.gather(d, -1, i),
          torch.gather(p, -2, i[..., None].expand(i.shape + (3,))),
          torch.gather(n, -2, i[..., None].expand(i.shape + (3,))))


def _cylinder_cylinder(pos1, mat1, size1, pos2, mat2, size2):
  """Cylinder vs cylinder with flat caps and sharp rims: the 2 deepest of
  five candidates (the JAX package's analytic families):
    1. side-side: sphere(r1) at the closest axis point vs solid cylinder 2,
       kept only where the contact is radial on cylinder 1;
    2./3. the deepest of 8 samples on each rim of one cylinder vs the
       other solid cylinder (normals flipped for cylinder 2's rims);
    4./5. the deepest axis endpoint of one cylinder vs the other (coaxial
       stacks of equal radii).
  """
  r1, h1, ax1 = size1[..., 0], size1[..., 1:2], mat1[..., :, 2]
  r2, h2, ax2 = size2[..., 0], size2[..., 1:2], mat2[..., :, 2]

  p1, q1 = pos1 - h1 * ax1, pos1 + h1 * ax1
  p2, q2 = pos2 - h2 * ax2, pos2 + h2 * ax2
  c1, _ = math.closest_segment_to_segment_points(p1, q1, p2, q2)
  d_ss, pos_ss, n_ss = _sphere_cylinder(c1, mat1, size1, pos2, mat2, size2)
  align = torch.einsum('...i,...i->...', n_ss[..., 0, :], ax1).abs()
  d_ss = torch.where(align[..., None] < 0.3, d_ss, 1e10)

  d_r1, p_r1, n_r1 = _deepest_point(_rim_points(pos1, mat1, r1, h1),
                                    pos2, mat2, size2)
  d_r2, p_r2, n_r2 = _deepest_point(_rim_points(pos2, mat2, r2, h2),
                                    pos1, mat1, size1)
  d_e1, p_e1, n_e1 = _deepest_point(torch.stack([p1, q1], -2),
                                    pos2, mat2, size2)
  d_e2, p_e2, n_e2 = _deepest_point(torch.stack([p2, q2], -2),
                                    pos1, mat1, size1)

  dists = torch.cat([d_ss, d_r1, d_r2, d_e1, d_e2], -1)       # (..., 5)
  poss = torch.cat([pos_ss, p_r1, p_r2, p_e1, p_e2], -2)
  ns = torch.cat([n_ss, n_r1, -n_r2, n_e1, -n_e2], -2)        # geom1 -> 2
  order = torch.argsort(dists, dim=-1, stable=True)[..., :2]
  o3 = order[..., None].expand(order.shape + (3,))
  return (torch.gather(dists, -1, order), torch.gather(poss, -2, o3),
          torch.gather(ns, -2, o3))


def _take(x, idx):
  """x[..., idx] for a per-element index tensor idx (...,), x's leading
  axes broadcast against idx's (a group's sizes against its poses)."""
  x = x.expand(idx.shape + x.shape[-1:])
  return torch.take_along_dim(x, idx[..., None], dim=-1)[..., 0]


def _column(mat, idx):
  """Column idx (...,) of each (..., 3, 3) matrix: (..., 3)."""
  return torch.take_along_dim(mat, idx[..., None, None].expand(
      idx.shape + (3, 1)), dim=-1)[..., 0]


def _one_hot(idx, dtype):
  return torch.nn.functional.one_hot(idx, 3).to(dtype)


# corner signs of a box in _plane_box's order (x slowest, z fastest)
_CORNERS = [(sx, sy, sz) for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
            for sz in (-1.0, 1.0)]


def plane_box_heights(p_pos, p_mat, b_pos, b_mat, b_size):
  """The box's 8 corners (..., 8, 3) and their heights over the plane
  (..., 8); `_plane_box` keeps the 4 lowest."""
  n = p_mat[..., :, 2]
  sign = torch.as_tensor(_CORNERS, dtype=b_pos.dtype, device=b_pos.device)
  local = sign * b_size[..., None, :]
  corners = b_pos[..., None, :] + torch.einsum('...ij,...kj->...ki', b_mat,
                                               local)
  heights = (n[..., None, :] * (corners - p_pos[..., None, :])).sum(-1)
  return corners, heights


def _plane_box(p_pos, p_mat, p_size, b_pos, b_mat, b_size):
  """The 4 deepest corners, deepest first (a stable sort: the lower
  corner index first among equal heights)."""
  n = p_mat[..., :, 2]
  corners, heights = plane_box_heights(p_pos, p_mat, b_pos, b_mat, b_size)
  idx = torch.argsort(heights, dim=-1, stable=True)[..., :4]
  dist = torch.gather(heights, -1, idx)
  pos = torch.gather(corners, -2, idx[..., None].expand(idx.shape + (3,)))
  pos = pos - n[..., None, :] * (dist / 2)[..., None]
  return dist, pos, n[..., None, :].expand(pos.shape)


def _sphere_box(s_pos, s_mat, s_size, b_pos, b_mat, b_size):
  """One contact: outside the box at the surface point nearest the
  center; with the center inside, out through the face of least depth."""
  r = s_size[..., 0]
  local = torch.einsum('...ij,...i->...j', b_mat, s_pos - b_pos)
  clamped = torch.maximum(torch.minimum(local, b_size), -b_size)
  inside = (local.abs() < b_size).all(-1)
  vec_out = local - clamped
  d_out = math.norm_safe(vec_out)
  n_out_l = vec_out / torch.clamp(d_out, min=1e-12)[..., None]
  depth = b_size - local.abs()
  axis = torch.argmin(depth, dim=-1)
  sgn = torch.sign(_take(local, axis))
  hot = _one_hot(axis, local.dtype)
  n_in_l = hot * sgn[..., None]
  d_in = -_take(depth, axis)
  surf_in = torch.where(hot > 0, sgn[..., None] * b_size, local)
  dist = torch.where(inside, d_in, d_out) - r
  n_l = torch.where(inside[..., None], n_in_l, n_out_l)
  surf_l = torch.where(inside[..., None], surf_in, clamped)
  n = torch.einsum('...ij,...j->...i', b_mat, -n_l)     # sphere -> box
  surf = b_pos + torch.einsum('...ij,...j->...i', b_mat, surf_l)
  pos = (surf + s_pos + n * r[..., None]) / 2
  return dist[..., None], pos[..., None, :], n[..., None, :]


def _capsule_box(c_pos, c_mat, c_size, b_pos, b_mat, b_size):
  """Two contacts: sphere-box at each end of the capsule's axis."""
  axis = c_mat[..., :, 2]
  hl = c_size[..., 1:2]
  outs = [_sphere_box(c_pos + t * hl * axis, c_mat, c_size, b_pos, b_mat,
                      b_size) for t in (-1.0, 1.0)]
  return (torch.cat([o[0] for o in outs], -1),
          torch.cat([o[1] for o in outs], -2),
          torch.cat([o[2] for o in outs], -2))


def _dir_radius(e_mat, e_size, n):
  """An ellipsoid's support radius along world direction n: 1 / |R' n /
  size|."""
  nl = torch.einsum('...ij,...i->...j', e_mat, n)
  return 1.0 / torch.clamp(math.norm_safe(nl / e_size), min=1e-12)


def _ellipsoid_as(sphere_fn, e_pos, e_mat, e_size, o_pos, o_mat, o_size):
  """One contact of an ellipsoid against another geom: the point-sphere
  collider `sphere_fn` at the ellipsoid's center, then the ellipsoid's
  support radius along that contact's normal taken off its distance (the
  JAX package's two-pass directional effective radius)."""
  d0, p0, n0 = sphere_fn(e_pos, e_mat, torch.zeros_like(e_size), o_pos,
                         o_mat, o_size)
  n = n0[..., 0, :]
  r = _dir_radius(e_mat, e_size, n)
  dist = d0[..., 0] - r
  pos = p0[..., 0, :] + n * (r / 2)[..., None]
  return dist[..., None], pos[..., None, :], n[..., None, :]


def _ellipsoid_cylinder(e_pos, e_mat, e_size, c_pos, c_mat, c_size):
  """Ellipsoid vs cylinder: sphere-cylinder at the ellipsoid's center,
  less its support radius along the normal."""
  return _ellipsoid_as(_sphere_cylinder, e_pos, e_mat, e_size, c_pos, c_mat,
                       c_size)


def _ellipsoid_box(e_pos, e_mat, e_size, b_pos, b_mat, b_size):
  """Ellipsoid vs box: sphere-box at the ellipsoid's center, less its
  support radius along the normal."""
  return _ellipsoid_as(_sphere_box, e_pos, e_mat, e_size, b_pos, b_mat,
                       b_size)


def _cylinder_box(c_pos, c_mat, c_size, b_pos, b_mat, b_size):
  """Cylinder vs box: capsule-box on the cylinder's axis and radius (its
  two contacts), padded with two empty slots (distance 1e10) to the four
  the pair type holds."""
  d2, p2, n2 = _capsule_box(c_pos, c_mat, c_size, b_pos, b_mat, b_size)
  return (torch.cat([d2, torch.full_like(d2, 1e10)], -1),
          torch.cat([p2, p2], -2), torch.cat([n2, n2], -2))


def _clip_polygon(pts, valid, n, c):
  """Sutherland-Hodgman clip of padded polygons against n . p <= c.

  pts (..., K, 2), valid (..., K), n (2,), c (...,): the clipped polygons
  padded to the same K, their points compacted in edge order (a stable
  sort, so the padding keeps its order too)."""
  K = pts.shape[-2]
  nv = valid.sum(-1, keepdim=True)
  idx = torch.arange(K, device=pts.device)
  nxt = torch.where(idx + 1 >= nv, 0, idx + 1)                   # (..., K)
  p0 = pts
  p1 = torch.gather(pts, -2, nxt[..., None].expand(pts.shape))
  d0 = (p0 * n).sum(-1) - c[..., None]
  d1 = (p1 * n).sum(-1) - c[..., None]
  in0, in1 = d0 <= 0, d1 <= 0
  denom = torch.where((d0 - d1).abs() < 1e-12, 1e-12, d0 - d1)
  s = d0 / denom
  inter = p0 + s[..., None] * (p1 - p0)
  edge_active = valid & (idx < nv)
  out_pts = torch.cat([p0, inter], -2)                         # (..., 2K, 2)
  out_ok = torch.cat([edge_active & in0, edge_active & (in0 ^ in1)], -1)
  key = torch.where(out_ok, torch.cat([2 * idx, 2 * idx + 1]), 10 * K)
  order = torch.argsort(key, dim=-1, stable=True)[..., :K]
  return (torch.gather(out_pts, -2, order[..., None].expand(
      order.shape + (2,))), torch.gather(out_ok, -1, order))


# the contact capacity of a box-box pair, and the edge axes' bias (face
# axes win within it, as in the reference)
_BOX_K = 8
_EDGE_BIAS = 1e-4


def box_box_axes(p1, R1, a, p2, R2, b):
  """The separating-axis test of `_box_box`: its frames (R = R1' R2, the
  offset t in A's frame and tB in B's), each face of A's, each face of
  B's and each edge pair's separation (..., 3), (..., 3), (..., 9), and the
  15 candidate values (..., 15) whose first largest is the axis the
  manifold is built on: A's faces, B's faces, then the edges less
  _EDGE_BIAS."""
  eps = 1e-10
  R = R1.transpose(-1, -2) @ R2                # columns: B's axes in A's frame
  t = torch.einsum('...ki,...k->...i', R1, p2 - p1)
  absR = R.abs() + eps
  tB = torch.einsum('...ij,...i->...j', R, t)
  sep_a = t.abs() - a - torch.einsum('...ij,...j->...i', absR, b)
  sep_b = tB.abs() - b - torch.einsum('...ij,...i->...j', absR, a)
  zero = torch.zeros_like(t[..., 0])
  seps = []
  for i in range(3):
    i1, i2 = (i + 1) % 3, (i + 2) % 3
    for j in range(3):
      comp = [zero] * 3
      comp[i1], comp[i2] = -R[..., i2, j], R[..., i1, j]
      L = torch.stack(comp, -1)
      norm = torch.sqrt(torch.clamp((L * L).sum(-1), min=eps))
      Ln = L / norm[..., None]
      ra = a[..., i1] * Ln[..., i1].abs() + a[..., i2] * Ln[..., i2].abs()
      j1, j2 = (j + 1) % 3, (j + 2) % 3
      rb = ((Ln * R[..., :, j1]).sum(-1).abs() * b[..., j1]
            + (Ln * R[..., :, j2]).sum(-1).abs() * b[..., j2])
      seps.append(torch.where(norm > 1e-5, (t * Ln).sum(-1).abs() - ra - rb,
                              -float('inf')))
  sep_e = torch.stack(seps, -1)
  cand = torch.cat([sep_a, sep_b, sep_e - _EDGE_BIAS], -1)
  return R, t, tB, sep_a, sep_b, sep_e, cand


def _box_face_manifold(ref_is_a, p1, R1, a, p2, R2, b, R, t, tB, axis_i):
  """Up to 8 contacts of the incident box's face clipped against the
  reference box's face `axis_i` (A's where ref_is_a, else B's)."""
  dtype = t.dtype
  eps = 1e-10
  if ref_is_a:
    r_half, i_half, Rri, c_inc = a, b, R, t
  else:
    r_half, i_half, Rri, c_inc = b, a, R.transpose(-1, -2), -tB
  sign = torch.sign(_take(c_inc, axis_i) + eps)
  normal_r = _one_hot(axis_i, dtype) * sign[..., None]
  proj = torch.einsum('...k,...kc->...c', normal_r, Rri)
  inc_axis = torch.argmax(proj.abs(), dim=-1)
  inc_col = _column(Rri, inc_axis)
  inc_sign = -torch.sign((normal_r * inc_col).sum(-1) + eps)
  inc_center = c_inc + (inc_sign * _take(i_half, inc_axis))[..., None] * inc_col
  e1_axis, e2_axis = (inc_axis + 1) % 3, (inc_axis + 2) % 3
  e1 = _column(Rri, e1_axis) * _take(i_half, e1_axis)[..., None]
  e2 = _column(Rri, e2_axis) * _take(i_half, e2_axis)[..., None]
  # the incident face's corners in ring order
  corners = torch.stack([inc_center + sx * e1 + sy * e2
                         for sx, sy in ((1.0, -1.0), (1.0, 1.0),
                                        (-1.0, 1.0), (-1.0, -1.0))], -2)
  # clip in the reference face's plane, axes u, v the other two
  u_axis, v_axis = (axis_i + 1) % 3, (axis_i + 2) % 3
  hot_u, hot_v = _one_hot(u_axis, dtype), _one_hot(v_axis, dtype)
  pts2 = torch.stack([(corners * hot_u[..., None, :]).sum(-1),
                      (corners * hot_v[..., None, :]).sum(-1)], -1)
  pts = torch.cat([pts2, torch.zeros_like(pts2)], -2)          # (..., 8, 2)
  valid = (torch.arange(_BOX_K, device=t.device) < 4).expand(pts.shape[:-1])
  hu, hv = (r_half * hot_u).sum(-1), (r_half * hot_v).sum(-1)
  for n2, c in (((1.0, 0.0), hu), ((-1.0, 0.0), hu), ((0.0, 1.0), hv),
                ((0.0, -1.0), hv)):
    pts, valid = _clip_polygon(
        pts, valid, torch.as_tensor(n2, dtype=dtype, device=t.device), c)
  # the clipped points' depth under the reference face, from the plane of
  # the incident face (its normal's axis_i component guarded)
  n_ax = _take(inc_col, axis_i)
  denom = torch.where(n_ax.abs() < 1e-8, 1e-8, n_ax)
  w = ((inc_col * inc_center).sum(-1)[..., None]
       - pts[..., 0] * _take(inc_col, u_axis)[..., None]
       - pts[..., 1] * _take(inc_col, v_axis)[..., None]) / denom[..., None]
  r_ax = _take(r_half, axis_i)
  depth = r_ax[..., None] - sign[..., None] * w
  pr = (pts[..., 0:1] * hot_u[..., None, :] + pts[..., 1:2] * hot_v[..., None, :]
        + (sign[..., None] * (r_ax[..., None] - depth / 2))[..., None]
        * normal_r.abs()[..., None, :])
  dist = torch.where(valid, -depth, 1e10)
  if ref_is_a:
    pw = p1[..., None, :] + pr @ R1.transpose(-1, -2)
    nw = torch.einsum('...ij,...j->...i', R1, normal_r)       # A's face, to B
  else:
    pw = p2[..., None, :] + pr @ R2.transpose(-1, -2)
    nw = -torch.einsum('...ij,...j->...i', R2, normal_r)      # B's face, to A
  return dist, pw, nw[..., None, :].expand(pw.shape)


def _box_box(pos1, mat1, size1, pos2, mat2, size2):
  """Box-box over any leading batch of pairs: the separating-axis test
  over A's 3 and B's 3 face axes and the 9 edge pairs (`box_box_axes`),
  and up to 8 contacts: the incident face clipped against the reference
  face where a face axis wins, the closest points of the two edges where
  an edge axis does (one contact).  Every candidate manifold is computed
  and the choice made branch-free (the JAX package's `_box_box_one`,
  vmapped there per pair)."""
  p1, R1, a, p2, R2, b = pos1, mat1, size1, pos2, mat2, size2
  dtype = p1.dtype
  eps = 1e-10
  R, t, tB, sep_a, sep_b, sep_e, _ = box_box_axes(p1, R1, a, p2, R2, b)
  face_a, face_b = torch.argmax(sep_a, -1), torch.argmax(sep_b, -1)
  best_edge = torch.argmax(sep_e, -1)
  s_a, s_b = _take(sep_a, face_a), _take(sep_b, face_b)
  s_e = _take(sep_e, best_edge) - _EDGE_BIAS
  d_a, p_a, n_a = _box_face_manifold(True, p1, R1, a, p2, R2, b, R, t, tB,
                                     face_a)
  d_b, p_b, n_b = _box_face_manifold(False, p1, R1, a, p2, R2, b, R, t, tB,
                                     face_b)

  # edge-edge: one contact between the closest points of the two edges
  ei, ej = best_edge // 3, best_edge % 3
  Ai = _one_hot(ei, dtype)
  Bj = _column(R, ej)
  L = math.cross(Ai, Bj)
  Ln = L / torch.sqrt(torch.clamp((L * L).sum(-1), min=eps))[..., None]
  Ln = Ln * torch.sign((Ln * t).sum(-1) + eps)[..., None]
  pa = torch.where(Ai > 0, 0.0, torch.sign(Ln) * a)  # A's support edge
  LnB = torch.einsum('...k,...kc->...c', Ln, R)
  pb_local = torch.where(_one_hot(ej, dtype) > 0, 0.0, -torch.sign(LnB) * b)
  pb = t + torch.einsum('...ij,...j->...i', R, pb_local)
  r12 = pb - pa
  d1d2 = (Ai * Bj).sum(-1)
  denom = torch.clamp(1.0 - d1d2 ** 2, min=eps)
  r1, r2 = (r12 * Ai).sum(-1), (r12 * Bj).sum(-1)
  s_par = (r1 - r2 * d1d2) / denom
  u_par = (r1 * d1d2 - r2) / denom
  a_ei, b_ej = _take(a, ei), _take(b, ej)
  cA = pa + torch.maximum(torch.minimum(s_par, a_ei), -a_ei)[..., None] * Ai
  cB = pb + torch.maximum(torch.minimum(u_par, b_ej), -b_ej)[..., None] * Bj
  edge_pos = p1 + torch.einsum('...ij,...j->...i', R1, (cA + cB) / 2)
  edge_n = torch.einsum('...ij,...j->...i', R1, Ln)
  d_e = torch.full_like(d_a, 1e10)
  d_e[..., 0] = s_e + _EDGE_BIAS
  p_e = edge_pos[..., None, :].expand(p_a.shape)
  n_e = edge_n[..., None, :].expand(n_a.shape)

  use_b = (s_b > s_a)[..., None]
  use_e = (s_e > torch.maximum(s_a, s_b))[..., None]
  dist = torch.where(use_e, d_e, torch.where(use_b, d_b, d_a))
  use_b, use_e = use_b[..., None], use_e[..., None]
  pos = torch.where(use_e, p_e, torch.where(use_b, p_b, p_a))
  nrm = torch.where(use_e, n_e, torch.where(use_b, n_b, n_a))
  return dist, pos, nrm


# ---------------------------------------------------------------------------
# Convex meshes (jaco): Frank-Wolfe distance over the decimated hull
# vertices, as the JAX package computes it (JAX colliders.py:689-823), each
# function over a batch of lanes and pairs.
# ---------------------------------------------------------------------------

_HULL_PAD = 64


def hull_table(m: Model) -> np.ndarray:
  """(nmesh, _HULL_PAD, 3) hull vertices, each hull padded by repeating
  its first vertex; cached on the model."""
  cached = m.__dict__.get('_hull_table')
  if cached is not None:
    return cached
  tab = np.zeros((max(len(m.mesh_hull or []), 1), _HULL_PAD, 3))
  for i, hv in enumerate(m.mesh_hull or []):
    n = min(len(hv), _HULL_PAD)
    tab[i, :n] = hv[:n]
    tab[i, n:] = hv[0]
  m.__dict__['_hull_table'] = tab
  return tab


def _hulls(m: Model, ref: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
  """The hull vertices (g.shape + (_HULL_PAD, 3)) of mesh geoms g."""
  tab = mirror(m, ref, hull_table(m))
  return tab[mirror(m, ref, m.geom_dataid)[g]]


def _to_world(pos, mat, verts):
  """Local vertices (..., k, 3) of frames (pos (..., 3), mat (..., 3, 3))
  in the world frame.  Elementwise, not a batched matmul: a lane's bits
  do not depend on the batch around it."""
  rot = (verts[..., 0:1] * mat[..., None, :, 0]
         + verts[..., 1:2] * mat[..., None, :, 1]
         + verts[..., 2:3] * mat[..., None, :, 2])
  return pos[..., None, :] + rot


def _fw_closest_point(p, verts, iters=24):
  """Closest point to p (..., 3) in conv(verts (..., k, 3)): Frank-Wolfe
  with an exact line search, `iters` steps from the first vertex; the
  support vertex is the first of the lowest scores.  The scores are summed
  over the vertices' coordinate planes (contiguous (..., k) each), which
  is the same sum as over the last axis and several times faster."""
  x = verts[..., 0, :]
  vx, vy, vz = (verts[..., i].contiguous() for i in range(3))
  for _ in range(iters):
    g = x - p
    scores = vx * g[..., 0:1] + vy * g[..., 1:2] + vz * g[..., 2:3]
    idx = scores.argmin(-1)
    s = torch.gather(verts, -2, idx[..., None, None].expand(
        idx.shape + (1, 3)))[..., 0, :]
    d = s - x
    denom = (d * d).sum(-1)
    gamma = torch.clamp(-(g * d).sum(-1) / torch.clamp(denom, min=1e-12),
                        0.0, 1.0)
    x = x + gamma[..., None] * d
  return x


def sphere_mesh_closest(s_pos, m_pos, m_mat, hulls):
  """(world hull vertices, the hull's point closest to the sphere's
  center) of sphere-mesh pairs."""
  world = _to_world(m_pos, m_mat, hulls)
  return world, _fw_closest_point(s_pos, world)


def _sphere_mesh(s_pos, s_mat, s_size, m_pos, m_mat, m_size, hulls):
  """Sphere vs convex hull (hulls (..., k, 3) in the mesh's frame); a
  center within 1e-9 of the hull takes the line to the hull's vertex mean
  as its normal."""
  world, closest = sphere_mesh_closest(s_pos, m_pos, m_mat, hulls)
  vec = closest - s_pos
  dist = math.norm_safe(vec) - s_size[..., 0]
  n = math.normalize(vec)
  inside = math.norm_safe(vec) < 1e-9
  ctr = world.mean(-2)
  n = torch.where(inside[..., None], math.normalize(ctr - s_pos), n)
  pos = s_pos + n * (s_size[..., 0:1] + dist[..., None] / 2)
  return dist[..., None], pos[..., None, :], n[..., None, :]


def mesh_witnesses(pos1, mat1, pos2, mat2, hulls1, hulls2):
  """(world vertices w1, w2, witness points c1, c2) of hull-hull pairs:
  alternating Frank-Wolfe projections, six of 8 steps each, from the
  hulls' vertex means."""
  w1 = _to_world(pos1, mat1, hulls1)
  w2 = _to_world(pos2, mat2, hulls2)
  c1 = w1.mean(-2)
  c2 = w2.mean(-2)
  for _ in range(6):
    c1 = _fw_closest_point(c2, w1, iters=8)
    c2 = _fw_closest_point(c1, w2, iters=8)
  return w1, w2, c1, c2


def _mesh_mesh(pos1, mat1, size1, pos2, mat2, size2, hulls1, hulls2):
  """Hull vs hull (`mesh_witnesses`): separated past 1e-7, the witnesses'
  distance, else minus the support overlap along the normal (the line
  between the hulls' vertex means where the witnesses meet)."""
  w1, w2, c1, c2 = mesh_witnesses(pos1, mat1, pos2, mat2, hulls1, hulls2)
  vec = c2 - c1
  sep = math.norm_safe(vec)
  n = math.normalize(vec)
  ctr_axis = math.normalize(w2.mean(-2) - w1.mean(-2))
  n = torch.where((sep < 1e-7)[..., None], ctr_axis, n)
  smax1 = (w1 * n[..., None, :]).sum(-1).amax(-1)
  smin2 = (w2 * n[..., None, :]).sum(-1).amin(-1)
  depth = smax1 - smin2
  dist = torch.where(sep > 1e-7, sep, -depth)
  pos = 0.5 * (c1 + c2)
  return dist[..., None], pos[..., None, :], n[..., None, :]


def _capsule_mesh(c_pos, c_mat, c_size, m_pos, m_mat, m_size, hulls):
  """Capsule vs hull: sphere-hull at both segment ends."""
  axis = c_mat[..., :, 2]
  hl = c_size[..., 1:2]
  outs = [_sphere_mesh(c_pos + s * hl * axis, c_mat, c_size, m_pos, m_mat,
                       m_size, hulls) for s in (1.0, -1.0)]
  return tuple(torch.cat(x, dim=-1 if i == 0 else -2)
               for i, x in enumerate(zip(*outs)))


_BOX_SIGNS = np.array([[sx, sy, sz] for sx in (-1., 1.) for sy in (-1., 1.)
                       for sz in (-1., 1.)])


def _box_mesh(b_pos, b_mat, b_size, m_pos, m_mat, m_size, hulls):
  """Box vs hull: the box as its 8-corner hull, hull vs hull."""
  corners = b_size[..., None, :] * torch.as_tensor(
      _BOX_SIGNS, dtype=b_size.dtype, device=b_size.device)
  return _mesh_mesh(b_pos, b_mat, b_size, m_pos, m_mat, m_size, corners,
                    hulls)


def plane_mesh_heights(p_pos, p_mat, m_pos, m_mat, hulls):
  """(world vertices (..., k, 3), their heights over the plane (..., k))
  of a hull against a plane."""
  n = p_mat[..., :, 2]
  world = _to_world(m_pos, m_mat, hulls)
  return world, ((world - p_pos[..., None, :]) * n[..., None, :]).sum(-1)


def _plane_mesh(p_pos, p_mat, p_size, m_pos, m_mat, m_size, hulls):
  """Plane vs hull: the three deepest hull vertices (a stable sort)."""
  n = p_mat[..., :, 2]
  world, h = plane_mesh_heights(p_pos, p_mat, m_pos, m_mat, hulls)
  idx = torch.argsort(h, dim=-1, stable=True)[..., :3]
  dist = torch.gather(h, -1, idx)
  pts = torch.gather(world, -2, idx[..., None].expand(idx.shape + (3,)))
  pts = pts - n[..., None, :] * (dist / 2)[..., None]
  return dist, pts, n[..., None, :].expand(pts.shape)


_COLLIDERS = {
    (GeomType.PLANE, GeomType.SPHERE): _plane_sphere,
    (GeomType.PLANE, GeomType.CAPSULE): _plane_capsule,
    (GeomType.PLANE, GeomType.ELLIPSOID): _plane_ellipsoid,
    (GeomType.PLANE, GeomType.CYLINDER): _plane_cylinder,
    (GeomType.SPHERE, GeomType.SPHERE): _sphere_sphere,
    (GeomType.SPHERE, GeomType.CAPSULE): _sphere_capsule,
    (GeomType.SPHERE, GeomType.ELLIPSOID): _sphere_ellipsoid,
    (GeomType.SPHERE, GeomType.CYLINDER): _sphere_cylinder,
    (GeomType.CAPSULE, GeomType.CAPSULE): _capsule_capsule,
    (GeomType.CAPSULE, GeomType.ELLIPSOID): _capsule_ellipsoid,
    (GeomType.CAPSULE, GeomType.CYLINDER): _capsule_cylinder,
    (GeomType.ELLIPSOID, GeomType.ELLIPSOID): _ellipsoid_ellipsoid,
    (GeomType.ELLIPSOID, GeomType.CYLINDER): _ellipsoid_cylinder,
    (GeomType.ELLIPSOID, GeomType.BOX): _ellipsoid_box,
    (GeomType.CYLINDER, GeomType.CYLINDER): _cylinder_cylinder,
    (GeomType.CYLINDER, GeomType.BOX): _cylinder_box,
    (GeomType.PLANE, GeomType.BOX): _plane_box,
    (GeomType.SPHERE, GeomType.BOX): _sphere_box,
    (GeomType.CAPSULE, GeomType.BOX): _capsule_box,
    (GeomType.BOX, GeomType.BOX): _box_box,
    # the mesh colliders take the mesh's hull vertices last (both hulls
    # for mesh-mesh)
    (GeomType.PLANE, GeomType.MESH): _plane_mesh,
    (GeomType.SPHERE, GeomType.MESH): _sphere_mesh,
    (GeomType.CAPSULE, GeomType.MESH): _capsule_mesh,
    (GeomType.BOX, GeomType.MESH): _box_mesh,
    (GeomType.MESH, GeomType.MESH): _mesh_mesh,
}


# ---------------------------------------------------------------------------
# Heightfield: each candidate point meets the tangent plane of the bilinear
# surface under it (the JAX package's local-surface-plane approximation).
# ---------------------------------------------------------------------------


def hfield_grid(m: Model, hid: int, xy: torch.Tensor):
  """Grid coordinates of local points xy (B, ..., 2) on hfield `hid`:
  ((B, ...) cell x0, y0 as int64, and the fractions tx, ty in [0, 1)),
  clamped into the grid as the reference clamps them.  The scale is one
  product by (n - 1) / (2 s), as XLA folds the JAX package's division and
  product: the floor of a point on a cell edge is then the same."""
  nrow, ncol = int(m.hfield_nrow[hid]), int(m.hfield_ncol[hid])
  sx, sy = [float(v) for v in m.hfield_size[hid][:2]]
  fx = (xy[..., 0] + sx) * ((ncol - 1) / (2 * sx))
  fy = (xy[..., 1] + sy) * ((nrow - 1) / (2 * sy))
  fx = torch.clamp(fx, 0.0, ncol - 1 - 1e-6)
  fy = torch.clamp(fy, 0.0, nrow - 1 - 1e-6)
  x0, y0 = torch.floor(fx), torch.floor(fy)
  return x0.long(), y0.long(), fx - x0, fy - y0


def hfield_height(m: Model, d: Data, hid: int, xy: torch.Tensor):
  """Bilinear height and its gradient ((B, ...) h, dh/dx, dh/dy) of
  hfield `hid` at local points xy (B, ..., 2).  The heights are
  `hfield_data`, each lane's own where `model_var` carries it."""
  from dm_control_tpu_torch._src import smooth
  nrow, ncol = int(m.hfield_nrow[hid]), int(m.hfield_ncol[hid])
  adr = int(m.hfield_adr[hid])
  sx, sy, sz = [float(v) for v in m.hfield_size[hid][:3]]
  B = xy.shape[0]
  data = smooth.mparam(m, d, 'hfield_data')
  data = data.expand((B,) + data.shape[-1:])[:, adr:adr + nrow * ncol]
  x0, y0, tx, ty = hfield_grid(m, hid, xy)

  def at(di, dj):
    # indices clamped into the grid as the JAX package's gather clamps
    # them: in float32 the clamp's ncol - 1 - 1e-6 rounds to ncol - 1
    flat = (torch.clamp(y0 + di, max=nrow - 1) * ncol
            + torch.clamp(x0 + dj, max=ncol - 1)).reshape(B, -1)
    return data.gather(1, flat).reshape(x0.shape) * sz

  h00, h01, h10, h11 = at(0, 0), at(0, 1), at(1, 0), at(1, 1)
  h = (h00 * (1 - tx) * (1 - ty) + h01 * tx * (1 - ty)
       + h10 * (1 - tx) * ty + h11 * tx * ty)
  dhdx = ((h01 - h00) * (1 - ty) + (h11 - h10) * ty) * ((ncol - 1) / (2 * sx))
  dhdy = ((h10 - h00) * (1 - tx) + (h11 - h01) * tx) * ((nrow - 1) / (2 * sy))
  return h, dhdx, dhdy


def _hfield_point(m, d, hid, h_pos, h_mat, pts, radius):
  """World points (B, K, 3) with radii (B, K) against hfield `hid` at
  poses h_pos (B, K, 3), h_mat (B, K, 3, 3): (dist, pos, world normal)."""
  local = torch.einsum('...ij,...i->...j', h_mat, pts - h_pos)
  h, dhdx, dhdy = hfield_height(m, d, hid, local[..., :2])
  n_local = math.normalize(torch.stack([-dhdx, -dhdy, torch.ones_like(h)],
                                       -1))
  surf = torch.stack([local[..., 0], local[..., 1], h], -1)
  dist = ((local - surf) * n_local).sum(-1) - radius
  n_world = torch.einsum('...ij,...j->...i', h_mat, n_local)
  pos = pts - n_world * (radius + dist / 2)[..., None]
  return dist, pos, n_world


def hfield_points(grp, h_mat, pos2, mat2, size2):
  """The points each pair of hfield group `grp` puts against the field,
  with their radii: [((B, K, 3) points, (B, K) radii)], one entry per
  contact of a pair.  A sphere's center; an ellipsoid's lowest point along
  the field's down axis (radius 0); a capsule's two axis ends; a
  cylinder's rim points at both ends, nearest and farthest from the field
  (radius 0)."""
  t2 = grp.t2
  zero = torch.zeros_like(size2[..., 0])
  if t2 == GeomType.SPHERE:
    return [(pos2, size2[..., 0])]
  if t2 == GeomType.ELLIPSOID:
    up = h_mat[..., :, 2]
    nl = torch.einsum('...ij,...i->...j', mat2, -up)
    sp_l = (size2 * size2 * nl) / torch.clamp(
        math.norm_safe(nl * size2), min=1e-12)[..., None]
    return [(pos2 + torch.einsum('...ij,...j->...i', mat2, sp_l), zero)]
  if t2 == GeomType.CAPSULE:
    axis = mat2[..., :, 2]
    hl = size2[..., 1:2]
    return [(pos2 + s * hl * axis, size2[..., 0]) for s in (1.0, -1.0)]
  if t2 == GeomType.CYLINDER:
    axis = mat2[..., :, 2]
    r, hl = size2[..., 0:1], size2[..., 1:2]
    up = h_mat[..., :, 2]
    proj = -up + axis * (up * axis).sum(-1, keepdim=True)
    radial = torch.where((math.norm_safe(proj) > 1e-8)[..., None],
                         math.normalize(proj), mat2[..., :, 0])
    return [(pos2 + se * hl * axis + sr * r * radial, zero)
            for se in (1.0, -1.0) for sr in (1.0, -1.0)]
  raise NotImplementedError(f'hfield vs {t2.name} is not ported yet')


def _collide_hfield(m: Model, d: Data, grp, h_pos, h_mat, pos2, mat2, size2):
  """Heightfield vs sphere, capsule, ellipsoid or cylinder: (dist (B, K,
  k), pos (B, K, k, 3), normal (B, K, k, 3)), k = `hfield_points`'
  points per pair."""
  hid = int(m.geom_dataid[grp.g1[0]])
  outs = [_hfield_point(m, d, hid, h_pos, h_mat, p, r)
          for p, r in hfield_points(grp, h_mat, pos2, mat2, size2)]
  return tuple(torch.stack([o[i] for o in outs], -1 if i == 0 else -2)
               for i in range(3))


def _broadphase_distance(m: Model, d: Data, grp) -> torch.Tensor:
  """(B, npairs) distance of each candidate pair of a group: exact for
  the plane, sphere and capsule pairs, of the bounding spheres (or a
  plane's half-space) otherwise."""
  ref = d.qpos
  g1, g2 = mirror(m, ref, grp.g1), mirror(m, ref, grp.g2)
  pos1, pos2 = d.geom_xpos[:, g1], d.geom_xpos[:, g2]
  size1 = mirror(m, ref, m.geom_size[grp.g1])
  size2 = mirror(m, ref, m.geom_size[grp.g2])

  def seg(pos, mat, size):
    axis = mat[..., :, 2]
    hl = size[:, 1:2]
    return pos - hl * axis, pos + hl * axis

  t1, t2 = grp.t1, grp.t2
  if t1 == GeomType.PLANE:
    n = d.geom_xmat[:, g1][..., :, 2]
    if t2 == GeomType.SPHERE:
      return (n * (pos2 - pos1)).sum(-1) - size2[:, 0]
    if t2 == GeomType.CAPSULE:
      a, b = seg(pos2, d.geom_xmat[:, g2], size2)
      ha = (n * (a - pos1)).sum(-1)
      hb = (n * (b - pos1)).sum(-1)
      return torch.minimum(ha, hb) - size2[:, 0]
    return (n * (pos2 - pos1)).sum(-1) - mirror(m, ref,
                                                m.geom_rbound[grp.g2])
  if (t1, t2) == (GeomType.SPHERE, GeomType.SPHERE):
    return math.norm_safe(pos2 - pos1) - size1[:, 0] - size2[:, 0]
  if (t1, t2) == (GeomType.SPHERE, GeomType.CAPSULE):
    a, b = seg(pos2, d.geom_xmat[:, g2], size2)
    c = math.closest_segment_point(a, b, pos1)
    return math.norm_safe(c - pos1) - size1[:, 0] - size2[:, 0]
  if (t1, t2) == (GeomType.CAPSULE, GeomType.CAPSULE):
    a1, b1 = seg(pos1, d.geom_xmat[:, g1], size1)
    a2, b2 = seg(pos2, d.geom_xmat[:, g2], size2)
    c1, c2 = math.closest_segment_to_segment_points(a1, b1, a2, b2)
    return math.norm_safe(c2 - c1) - size1[:, 0] - size2[:, 0]
  return (math.norm_safe(pos2 - pos1) - mirror(m, ref, m.geom_rbound[grp.g1])
          - mirror(m, ref, m.geom_rbound[grp.g2]))


def broadphase_select(m: Model, d: Data, grp):
  """A dynamic group's top-K selection: ((B, K) pair indices, (B, npairs)
  scores).  The score is the broadphase distance less (margin - gap); the
  K smallest are taken in ascending order, the lower index first among
  equal scores (a stable sort), which is `lax.top_k`'s order on the
  negated score."""
  score = _broadphase_distance(m, d, grp) - mirror(
      m, d.qpos, grp.margin - grp.gap)
  idx = torch.sort(score, dim=-1, stable=True).indices[:, :grp.K]
  return idx, score


def collide_all(m: Model, d: Data) -> Data:
  """Narrowphase for every group, concatenated in group order: a static
  group's pairs in its own order, a dynamic group's K selected pairs
  (`broadphase_select`) in the selection's order, each lane's own."""
  from dm_control_tpu_torch._src import collision as coll
  ref = d.qpos
  B = ref.shape[0]
  out = {k: [] for k in ('dist', 'pos', 'frame', 'includemargin', 'friction',
                         'solref', 'solimp', 'geom1', 'geom2', 'body1',
                         'body2', 'dim')}
  for grp in coll.groups(m):
    fn = _COLLIDERS.get((grp.t1, grp.t2))
    if fn is None and grp.t1 != GeomType.HFIELD:
      raise NotImplementedError(
          f'collider for ({grp.t1.name}, {grp.t2.name}) is not ported yet')
    k, K = grp.ncon_per_pair, grp.K
    n = K * k

    def rep(x):
      """Per-pair constant (K, ...) -> per-contact (B, K*k, ...)."""
      x = np.repeat(np.asarray(x), k, axis=0)
      t = mirror(m, ref, x)
      if t.dtype == torch.int64:
        t = t.to(torch.int32)
      return t.expand((B,) + t.shape)

    if not grp.dynamic:
      g1 = mirror(m, ref, grp.g1)
      g2 = mirror(m, ref, grp.g2)
      pos1, mat1 = d.geom_xpos[:, g1], d.geom_xmat[:, g1]
      pos2, mat2 = d.geom_xpos[:, g2], d.geom_xmat[:, g2]
      size1 = mirror(m, ref, m.geom_size[grp.g1])
      size2 = mirror(m, ref, m.geom_size[grp.g2])
      per_pair = {'includemargin': rep(grp.margin - grp.gap),
                  'solref': rep(grp.solref), 'solimp': rep(grp.solimp),
                  'geom1': rep(grp.g1), 'geom2': rep(grp.g2),
                  'body1': rep(m.geom_bodyid[grp.g1]),
                  'body2': rep(m.geom_bodyid[grp.g2])}
    else:
      # every per-pair field read at each lane's selected indices
      idx, _ = broadphase_select(m, d, grp)                  # (B, K)
      g1 = mirror(m, ref, grp.g1)[idx]
      g2 = mirror(m, ref, grp.g2)[idx]
      take = lambda x, g: torch.take_along_dim(
          x, g.reshape(g.shape + (1,) * (x.dim() - 2)), dim=1)
      pos1, mat1 = take(d.geom_xpos, g1), take(d.geom_xmat, g1)
      pos2, mat2 = take(d.geom_xpos, g2), take(d.geom_xmat, g2)
      size = mirror(m, ref, m.geom_size)
      size1, size2 = size[g1], size[g2]
      body = mirror(m, ref, m.geom_bodyid)
      per_k = lambda x: x.repeat_interleave(k, dim=1)
      per_pair = {
          'includemargin': per_k(mirror(m, ref, grp.margin - grp.gap)[idx]),
          'solref': per_k(mirror(m, ref, grp.solref)[idx]),
          'solimp': per_k(mirror(m, ref, grp.solimp)[idx]),
          'geom1': per_k(g1.to(torch.int32)),
          'geom2': per_k(g2.to(torch.int32)),
          'body1': per_k(body[g1].to(torch.int32)),
          'body2': per_k(body[g2].to(torch.int32))}
    if grp.t1 == GeomType.HFIELD:
      dist, pos, normal_or_frame = _collide_hfield(m, d, grp, pos1, mat1,
                                                   pos2, mat2, size2)
    elif grp.t2 == GeomType.MESH:
      hulls = [_hulls(m, ref, g) for g in (
          (g1, g2) if grp.t1 == GeomType.MESH else (g2,))]
      dist, pos, normal_or_frame = fn(pos1, mat1, size1, pos2, mat2, size2,
                                      *hulls)
    else:
      dist, pos, normal_or_frame = fn(pos1, mat1, size1, pos2, mat2, size2)
    if normal_or_frame.dim() == pos.dim() + 1:
      frame = normal_or_frame
    else:
      frame = make_frame(normal_or_frame)

    out['dist'].append(dist.reshape(B, n))
    out['pos'].append(pos.reshape(B, n, 3))
    out['frame'].append(frame.reshape(B, n, 3, 3))
    out['friction'].append(rep(np.broadcast_to(grp.friction, (K, 5))))
    out['dim'].append(rep(np.full(K, grp.condim)))
    for key, x in per_pair.items():
      out[key].append(x)
  contact = Contact(**{k: torch.cat(v, dim=1) for k, v in out.items()})
  return d.replace(contact=contact)
