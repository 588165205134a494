"""Ray casting against the geoms (the rangefinder's mj_ray).

The port of the ray-casting half of `dm_control_tpu/_src/render.py`:
`raycast` and the analytic ray hits of planes, spheres, capsules,
cylinders, boxes and ellipsoids, and the heightfield's march and
bisection.  Every ray of a call goes at once: rays are (B, S) (lanes by
sensors), and the geoms of one type are one batch (B, S, G).  Mesh geoms
trace their convex collision hulls (`_hull_tri_table`, Moller-Trumbore
over the hull's triangles), as the JAX package's do; the cameras,
`select` and pixel rendering are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from dm_control_tpu_torch._src import colliders
from dm_control_tpu_torch._src.types import Data, GeomType, Model, mirror

_BIG = 1e9
# the heightfield ray's march samples and bisection steps
_MARCH = 64
_BISECT = 12


# ---------------------------------------------------------------------------
# Ray-primitive intersections in the geom's frame: ol, dl (..., 3) ray
# origins and directions, sizes broadcast over the leading axes.  Each
# returns t (...) with _BIG for a miss.
# ---------------------------------------------------------------------------


def _quadratic(a, b, c):
  disc = b * b - 4 * a * c
  sq = torch.sqrt(torch.clamp(disc, min=0.0))
  t0 = (-b - sq) / (2 * a)
  t1 = (-b + sq) / (2 * a)
  t = torch.where(t0 > 1e-6, t0, t1)
  return torch.where((disc >= 0) & (t > 1e-6), t, _BIG)


def _sphere_hit(ol, dl, r):
  a = (dl * dl).sum(-1)
  b = 2 * (ol * dl).sum(-1)
  c = (ol * ol).sum(-1) - r * r
  return _quadratic(a, b, c)


def _side_hit(ol, dl, r, hl):
  """The infinite z-axis cylinder of radius r, hit within |z| <= hl."""
  a = dl[..., 0] ** 2 + dl[..., 1] ** 2
  b = 2 * (ol[..., 0] * dl[..., 0] + ol[..., 1] * dl[..., 1])
  c = ol[..., 0] ** 2 + ol[..., 1] ** 2 - r * r
  t = _quadratic(torch.clamp(a, min=1e-12), b, c)
  z = ol[..., 2] + t * dl[..., 2]
  return torch.where(z.abs() <= hl, t, _BIG)


def _capsule_hit(ol, dl, r, hl):
  shift = torch.zeros_like(ol)
  shift[..., 2] = 1.0
  shift = shift * hl[..., None]
  t_top = _sphere_hit(ol - shift, dl, r)
  t_bot = _sphere_hit(ol + shift, dl, r)
  return torch.minimum(_side_hit(ol, dl, r, hl), torch.minimum(t_top, t_bot))


def _cylinder_hit(ol, dl, r, hl):
  t_side = _side_hit(ol, dl, r, hl)
  dz = dl[..., 2]
  safe_dz = torch.where(dz.abs() < 1e-12, 1e-12, dz)
  t_cap = None
  for sign in (1.0, -1.0):
    t = (sign * hl - ol[..., 2]) / safe_dz
    px = ol[..., 0] + t * dl[..., 0]
    py = ol[..., 1] + t * dl[..., 1]
    t = torch.where((t > 1e-6) & (px ** 2 + py ** 2 <= r * r), t, _BIG)
    t_cap = t if t_cap is None else torch.minimum(t_cap, t)
  return torch.minimum(t_side, t_cap)


def _box_hit(ol, dl, size):
  safe = torch.where(dl.abs() < 1e-12, 1e-12, dl)
  t1 = (-size - ol) / safe
  t2 = (size - ol) / safe
  tmin = torch.minimum(t1, t2).amax(-1)
  tmax = torch.maximum(t1, t2).amin(-1)
  t = torch.where(tmin > 1e-6, tmin, tmax)
  return torch.where((tmax >= tmin) & (tmax > 1e-6), t, _BIG)


def _ellipsoid_hit(ol, dl, size):
  os_ = ol / size
  ds = dl / size
  a = (ds * ds).sum(-1)
  b = 2 * (os_ * ds).sum(-1)
  c = (os_ * os_).sum(-1) - 1.0
  return _quadratic(a, b, c)


def _hull_tri_table(m: Model) -> np.ndarray:
  """Per-mesh convex-hull triangles, oriented outward, padded to one
  (nmesh, T, 3, 3) array by repeating each hull's last triangle; cached
  on the model (the JAX package's render._hull_tri_table)."""
  cached = m.__dict__.get('_hull_tri_table')
  if cached is not None:
    return cached
  from scipy.spatial import ConvexHull
  tris = []
  for hv in (m.mesh_hull or []):
    hv = np.asarray(hv)
    try:
      hull = ConvexHull(hv)
      t = hv[hull.simplices]             # (T, 3, 3)
      cen = hv.mean(axis=0)
      n = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
      flip = np.einsum('ij,ij->i', n, t.mean(axis=1) - cen) < 0
      t[flip] = t[flip][:, ::-1]
    except Exception:                    # a flat or degenerate hull
      t = np.zeros((1, 3, 3))
    tris.append(t)
  tmax = max((t.shape[0] for t in tris), default=1)
  tab = np.zeros((max(len(tris), 1), tmax, 3, 3))
  for i, t in enumerate(tris):
    tab[i, :t.shape[0]] = t
    tab[i, t.shape[0]:] = t[-1] if t.shape[0] else 0.0
  m.__dict__['_hull_tri_table'] = tab
  return tab


def _mesh_hit(ol, dl, tris):
  """Moller-Trumbore against each geom's hull triangles: ol, dl (..., G,
  3) in the geoms' frames, tris (G, T, 3, 3); the nearest hit (..., G)."""
  v0, e1, e2 = tris[:, :, 0], tris[:, :, 1] - tris[:, :, 0], (
      tris[:, :, 2] - tris[:, :, 0])                           # (G, T, 3)
  d = dl[..., None, :].expand(dl.shape[:-1] + e2.shape[1:])
  h = torch.linalg.cross(d, e2.expand_as(d))                  # (..., G, T, 3)
  a = (e1 * h).sum(-1)
  f = torch.where(a.abs() < 1e-12, float('inf'), 1.0 / a)
  s = ol[..., None, :] - v0
  u = f * (s * h).sum(-1)
  q = torch.linalg.cross(s, e1.expand_as(s))
  v = f * (d * q).sum(-1)
  t = f * (e2 * q).sum(-1)
  ok = ((u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-9)
        & torch.isfinite(t))
  return torch.where(ok, t, _BIG).amin(-1)


def _plane_hit(ol, dl):
  dz = dl[..., 2]
  safe_dz = torch.where(dz.abs() < 1e-12, 1e-12, dz)
  t = -ol[..., 2] / safe_dz
  return torch.where(t > 1e-6, t, _BIG)


def hfield_march(m: Model, d: Data, hid: int, ol, dl):
  """The heightfield ray's march: _MARCH samples of local rays ol, dl
  (B, S, 3) from 0 to twice the field's half-diagonal; returns (ts (n,),
  the samples' heights z and the surface's h under them (B, S, n), and
  which samples lie under the surface, inside its x-y extent, past 0)."""
  sx, sy, sz = [float(v) for v in m.hfield_size[hid][:3]]
  tmax = 2.0 * float(np.sqrt(sx * sx + sy * sy + sz * sz))
  ts = torch.linspace(0.0, tmax, _MARCH, dtype=ol.dtype, device=ol.device)
  pts = ol[..., None, :] + ts[:, None] * dl[..., None, :]   # (B, S, n, 3)
  h, _, _ = colliders.hfield_height(m, d, hid, pts[..., :2])
  inside = (pts[..., 0].abs() <= sx) & (pts[..., 1].abs() <= sy)
  return ts, pts[..., 2], h, (pts[..., 2] < h) & inside & (ts > 1e-6)


def _hfield_ray(m: Model, d: Data, hid: int, ol, dl):
  """(B, S) distance along local rays ol, dl (B, S, 3) to heightfield
  `hid`: the first sample of `hfield_march` that lies under the surface,
  then _BISECT bisections between it and the sample before it."""
  ts, _, _, below = hfield_march(m, d, hid, ol, dl)
  first = torch.argmax(below.to(torch.int32), dim=-1)
  lo = ts[torch.clamp(first - 1, min=0)]
  hi = ts[first]
  for _ in range(_BISECT):
    mid = 0.5 * (lo + hi)
    p = ol + mid[..., None] * dl
    hm, _, _ = colliders.hfield_height(m, d, hid, p[..., :2])
    under = p[..., 2] < hm
    lo, hi = torch.where(under, lo, mid), torch.where(under, mid, hi)
  return torch.where(below.any(-1), 0.5 * (lo + hi), _BIG)


def raycast(m: Model, d: Data, origin: torch.Tensor, direction: torch.Tensor,
            exclude_body=None) -> torch.Tensor:
  """(B, S) distance along each ray to the nearest geom surface, -1 where
  none is hit (the reference's mj_ray, which the rangefinder reads).

  origin and direction are (B, S, 3) in the world frame; exclude_body
  (S,) names each ray's body whose geoms it does not see (-1: none)."""
  ref = d.qpos
  B, S = origin.shape[:2]
  excl = np.full(S, -1) if exclude_body is None else np.asarray(exclude_body)
  gtype = np.asarray(m.geom_type)
  best = ref.new_full((B, S), _BIG)
  for gt in sorted(set(int(t) for t in gtype)):
    gt = GeomType(gt)
    gids = np.flatnonzero(gtype == gt)
    pos = d.geom_xpos[:, mirror(m, ref, gids)]                 # (B, G, 3)
    mat = d.geom_xmat[:, mirror(m, ref, gids)]                 # (B, G, 3, 3)
    # the rays in each geom's frame: (B, S, G, 3)
    ol = torch.einsum('BSGi,BGij->BSGj', origin[:, :, None] - pos[:, None],
                      mat)
    dl = torch.einsum('BSi,BGij->BSGj', direction, mat)
    size = mirror(m, ref, m.geom_size[gids])                   # (G, 3)
    if gt == GeomType.PLANE:
      t = _plane_hit(ol, dl)
    elif gt == GeomType.SPHERE:
      t = _sphere_hit(ol, dl, size[:, 0])
    elif gt == GeomType.CAPSULE:
      t = _capsule_hit(ol, dl, size[:, 0], size[:, 1])
    elif gt == GeomType.CYLINDER:
      t = _cylinder_hit(ol, dl, size[:, 0], size[:, 1])
    elif gt == GeomType.BOX:
      t = _box_hit(ol, dl, size)
    elif gt == GeomType.ELLIPSOID:
      t = _ellipsoid_hit(ol, dl, size)
    elif gt == GeomType.MESH:
      tris = mirror(m, ref, _hull_tri_table(m))[
          mirror(m, ref, m.geom_dataid[gids])]                 # (G, T, 3, 3)
      t = _mesh_hit(ol, dl, tris)
    elif gt == GeomType.HFIELD:
      t = torch.stack([_hfield_ray(m, d, int(m.geom_dataid[g]),
                                   ol[:, :, i], dl[:, :, i])
                       for i, g in enumerate(gids)], -1)
    else:
      continue
    seen = m.geom_bodyid[gids][None, :] != excl[:, None]     # (S, G)
    t = torch.where(mirror(m, ref, seen), t, _BIG)
    best = torch.minimum(best, t.amin(-1))
  return torch.where(best > 0.5 * _BIG, -1.0, best)
