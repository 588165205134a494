"""Mesh assets: STL loading, exact mass properties, convex hulls.

The port's own copy of `dm_control_tpu/mjcf/meshes.py` (host numpy and
scipy).  It replaces the reference's native mesh pipeline (mj_loadXML's mesh compile:
volume/inertia integration and convex-hull extraction inside
libmujoco, reference dm_control/mujoco/wrapper/core.py:300-364 loads it).
All work happens at model-build time on the host; the compiled Model only
carries numpy vertex/face arrays (hull vertices for collision support
functions, full mesh for mass properties and ray tests).
"""

from __future__ import annotations

import os
import struct

import numpy as np


def load_mesh(path: str) -> tuple[np.ndarray, np.ndarray]:
  """Load a mesh by path, preferring the framework's own .npz
  (verts/faces) format over STL when both resolve."""
  base = os.path.splitext(path)[0]
  if os.path.isfile(base + '.npz'):
    z = np.load(base + '.npz')
    return z['verts'].astype(np.float64), z['faces'].astype(np.int32)
  if path.lower().endswith('.npz'):
    z = np.load(path)
    return z['verts'].astype(np.float64), z['faces'].astype(np.int32)
  return load_stl(path)


def load_stl(path: str) -> tuple[np.ndarray, np.ndarray]:
  """Load an STL file -> (verts (n,3) f8, faces (m,3) i4), deduplicated."""
  with open(path, 'rb') as f:
    head = f.read(80)
    data = f.read()
  if head[:5] == b'solid' and b'facet' in head + data[:200]:
    return _load_stl_ascii(path)
  (ntri,) = struct.unpack('<I', data[:4])
  raw = np.frombuffer(data[4:4 + ntri * 50], dtype=np.uint8)
  raw = raw.reshape(ntri, 50)
  tri = raw[:, 12:48].copy().view('<f4').reshape(ntri, 3, 3)
  return _dedup(tri.astype(np.float64))


def _load_stl_ascii(path: str):
  verts = []
  with open(path) as f:
    for line in f:
      parts = line.split()
      if parts and parts[0] == 'vertex':
        verts.append([float(x) for x in parts[1:4]])
  tri = np.asarray(verts, np.float64).reshape(-1, 3, 3)
  return _dedup(tri)


def _dedup(tri: np.ndarray):
  """Triangle soup -> unique verts + index faces."""
  flat = tri.reshape(-1, 3)
  uniq, inv = np.unique(flat.round(decimals=9), axis=0,
                        return_inverse=True)
  faces = inv.reshape(-1, 3).astype(np.int32)
  return uniq, faces


def mass_properties(verts: np.ndarray, faces: np.ndarray,
                    legacy: bool = True):
  """(volume, com (3,), inertia_full (3,3) about com) at unit density.

  legacy=True reproduces the reference compiler's default mesh-inertia
  algorithm, identified numerically against the oracle on the dog
  assets (mass AND CoM match to ~1e-15 / 6e-9 on BONEhumerus_L):
  tetrahedra are fanned with ABSOLUTE volumes (robust to non-watertight
  surfaces); the apex of the first pass is the area-weighted SURFACE
  centroid, whose fan yields the final CoM; the second pass fans from
  that CoM and yields the volume and inertia (about the CoM, which is
  its own apex).  legacy=False is the exact signed-tetrahedron integral
  (watertight meshes only)."""

  def fan(center, use_abs):
    a = verts[faces[:, 0]] - center
    b = verts[faces[:, 1]] - center
    c = verts[faces[:, 2]] - center
    vol = np.einsum('ij,ij->i', a, np.cross(b, c)) / 6.0
    if use_abs:
      vol = np.abs(vol)
    v = vol.sum()
    com = center + (vol[:, None] * (a + b + c) / 4.0).sum(axis=0) / v
    # second moment S = integral of x x' dV, per tet with apex at center:
    # S_tet = vol/20 * (s s' + a a' + b b' + c c'), s = a + b + c
    s = a + b + c
    S = np.einsum('i,ijk->jk', vol / 20.0,
                  (np.einsum('ij,ik->ijk', s, s)
                   + np.einsum('ij,ik->ijk', a, a)
                   + np.einsum('ij,ik->ijk', b, b)
                   + np.einsum('ij,ik->ijk', c, c)))
    inertia_center = np.trace(S) * np.eye(3) - S
    d = com - center
    inertia_com = inertia_center - v * (
        np.dot(d, d) * np.eye(3) - np.outer(d, d))
    return float(v), com, inertia_com, inertia_center

  if not legacy:
    v, com, inertia_com, _ = fan(np.zeros(3), use_abs=False)
    return v, com, inertia_com
  tri = verts[faces]
  area = 0.5 * np.linalg.norm(
      np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
  surf_cen = (area[:, None] * tri.mean(axis=1)).sum(axis=0) / area.sum()
  _, com, _, _ = fan(surf_cen, use_abs=True)
  # volume and inertia from the CoM-apex fan; the inertia is about the
  # apex itself (the oracle does not re-shift to the pass-2 centroid)
  vol, _, _, inertia_apex = fan(com, use_abs=True)
  return vol, com, inertia_apex


def convex_hull(verts: np.ndarray, max_verts: int = 64):
  """Hull vertices (k,3) for collision support functions, decimated to at
  most max_verts by greedy farthest-point selection."""
  from scipy.spatial import ConvexHull
  hull = ConvexHull(verts)
  pts = verts[hull.vertices]
  if len(pts) <= max_verts:
    return pts
  # farthest-point decimation keeps the extremal shape
  sel = [int(np.argmax(np.linalg.norm(pts - pts.mean(0), axis=1)))]
  d = np.linalg.norm(pts - pts[sel[0]], axis=1)
  for _ in range(max_verts - 1):
    nxt = int(np.argmax(d))
    sel.append(nxt)
    d = np.minimum(d, np.linalg.norm(pts - pts[nxt], axis=1))
  return pts[sel]


class MeshAsset:
  """One compiled mesh asset."""

  def __init__(self, name: str, path: str, scale=None):
    verts, faces = load_mesh(path)
    if scale is not None:
      verts = verts * np.asarray(scale)
      if np.prod(np.sign(scale)) < 0:  # odd reflection flips winding
        faces = faces[:, ::-1].copy()
    self.name = name
    self.verts = verts
    self.faces = faces
    self.volume, self.com, self.inertia = mass_properties(verts, faces)
    self.hull = convex_hull(verts)
    self.rbound = float(np.linalg.norm(verts, axis=1).max())


def _orient_hull(verts, hull):
  """Hull simplices oriented outward (positive volume)."""
  faces = hull.simplices.astype(np.int32)
  centroid = verts[hull.vertices].mean(axis=0)
  a = verts[faces[:, 0]] - centroid
  b = verts[faces[:, 1]] - centroid
  c = verts[faces[:, 2]] - centroid
  flip = np.einsum('ij,ij->i', a, np.cross(b, c)) < 0
  faces[flip] = faces[flip][:, ::-1]
  return verts, faces
