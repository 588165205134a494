"""The port's mesh pipeline against the JAX package, float64 on the CPU.

Mesh assets (the ten kinova meshes jaco's 7-DoF model names: load, the
legacy mass properties, the decimated convex hull, rbound), the compiled
jaco Model field for field, the Frank-Wolfe mesh colliders on seeded
poses (a sphere deep inside a hull, a sphere grazing it, two hulls 1e-7
apart, a box on a hull, a hull on a plane) and ray casting against the
hulls.  Everything the port computes the way the JAX package does is
held to 1e-12 scaled by max(1, |ref|): both are the same float64
arithmetic up to the order of a few sums.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dm_control_tpu._src import colliders as jcolliders
from dm_control_tpu._src import engine as jengine
from dm_control_tpu._src import forward as jforward
from dm_control_tpu._src import render as jrender
from dm_control_tpu.mjcf import meshes as jmeshes
from dm_control_tpu.suite import common as jcommon
from dm_control_tpu_torch._src import colliders
from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch._src import forward
from dm_control_tpu_torch._src import render
from dm_control_tpu_torch.mjcf import meshes
from dm_control_tpu_torch.suite import common
from test_torch_model import SETCONST_FIELDS, _assert_same

TOL = 1e-12
XML = 'jaco_j2s7s300_position.xml'
KINOVA = ('base', 'shoulder', 'arm_half_1', 'arm_half_2', 'forearm',
          'wrist_spherical_1', 'wrist_spherical_2', 'hand_3finger',
          'finger_proximal', 'finger_distal')


def _scaled(x, ref):
  x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
  assert x.shape == ref.shape, (x.shape, ref.shape)
  return float((np.abs(x - ref) / np.maximum(1.0, np.abs(ref))).max(
      initial=0.0))


@functools.lru_cache(maxsize=None)
def _models():
  """(JAX model, port model) of jaco's 7-DoF arm, compiled once."""
  return (jengine.load_model(jcommon.model_path(XML)),
          engine.load_model(common.model_path(XML), device='cpu'))


@pytest.mark.parametrize('name', KINOVA)
def test_mesh_asset_matches_jax(name):
  """Vertices and faces as loaded, volume, center of mass and inertia of
  the legacy two-pass fan, the hull (Qhull, then farthest-point
  decimation to 64 vertices) and rbound."""
  path = os.path.join(common.ASSETS_DIR, 'common', 'kinova_meshes',
                      name + '.stl')
  ref = jmeshes.MeshAsset(name, path.replace(common.ASSETS_DIR,
                                             jcommon._ASSETS_DIR))
  port = meshes.MeshAsset(name, path)
  np.testing.assert_array_equal(port.verts, ref.verts)
  np.testing.assert_array_equal(port.faces, ref.faces)
  for f in ('volume', 'com', 'inertia', 'hull', 'rbound'):
    err = _scaled(getattr(port, f), getattr(ref, f))
    assert err <= TOL, f'{name}.{f}: {err:.2e}'
  assert len(port.hull) <= colliders._HULL_PAD


def test_mesh_scale_reflects_winding_as_jax():
  """A scale with an odd number of negative axes flips the faces' winding
  and keeps the mass properties positive, as the JAX package's."""
  path = os.path.join(common.ASSETS_DIR, 'common', 'kinova_meshes',
                      'finger_distal.stl')
  scale = np.array([-1.0, 2.0, 0.5])
  ref = jmeshes.MeshAsset('f', path.replace(common.ASSETS_DIR,
                                            jcommon._ASSETS_DIR), scale)
  port = meshes.MeshAsset('f', path, scale)
  np.testing.assert_array_equal(port.faces, ref.faces)
  for f in ('volume', 'com', 'inertia', 'hull', 'rbound'):
    assert _scaled(getattr(port, f), getattr(ref, f)) <= TOL, f
  assert port.volume > 0


def test_jaco_model_matches_jax():
  """Every Model field of the compiled 7-DoF jaco (mesh geoms in their
  declared frames, geom_dataid, mesh_vert/face/hull, mesh rbound, the
  bodies' mesh mass and inertia) equals the JAX package's; set_const's
  outputs within 1e-12 scaled."""
  jm, m = _models()
  names = [f.name for f in dataclasses.fields(jm)]
  assert names == [f.name for f in dataclasses.fields(m)]
  for name in names:
    if name in SETCONST_FIELDS:
      err = _scaled(getattr(m, name), getattr(jm, name))
      assert err <= TOL, f'{name}: {err:.2e}'
    else:
      _assert_same(name, getattr(jm, name), getattr(m, name))
  assert (m.nv, len(m.mesh_hull)) == (13, 10)
  assert (m.geom_type == 7).sum() == 14                  # mesh geoms


def test_hull_table_matches_jax():
  jm, m = _models()
  np.testing.assert_array_equal(colliders.hull_table(m),
                                jcolliders.hull_table(jm))


def _poses(rng, n):
  """n random frames: positions in a 0.2 m cube, rotation matrices."""
  q = rng.randn(n, 4)
  q /= np.linalg.norm(q, axis=1, keepdims=True)
  w, x, y, z = q.T
  mat = np.stack([
      np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                2 * (x * z + w * y)], -1),
      np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                2 * (y * z - w * x)], -1),
      np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                1 - 2 * (x * x + y * y)], -1)], -2)
  return rng.uniform(-0.1, 0.1, (n, 3)), mat


def _hulls(jm, names):
  """Hull vertices of the named meshes (KINOVA is the XML's order)."""
  return jcolliders.hull_table(jm)[[KINOVA.index(n) for n in names]]


def _both(jax_fn, port_fn, *args):
  """The JAX collider vmapped over pairs and the port's batched one on
  the same numpy arguments (None passes through)."""
  ref = jax.jit(jax.vmap(jax_fn))(*[jnp.asarray(a) for a in args])
  out = port_fn(*[torch.tensor(a) for a in args])
  return [np.asarray(r) for r in ref], [o.numpy() for o in out]


def _check(name, ref, out):
  for what, r, o in zip(('dist', 'pos', 'normal'), ref, out):
    err = _scaled(o, r)
    print(f'{name} {what}: max scaled err {err:.2e}')
    assert err <= TOL, f'{name} {what}: {err:.2e}'


def test_fw_closest_point_matches_jax():
  jm, _ = _models()
  rng = np.random.RandomState(0)
  hulls = _hulls(jm, ['hand_3finger', 'forearm'] * 4)
  pos, mat = _poses(rng, 8)
  world = pos[:, None] + np.einsum('nij,nkj->nki', mat, hulls)
  p = rng.uniform(-0.3, 0.3, (8, 3))
  ref = jax.jit(jax.vmap(jcolliders._fw_closest_point))(jnp.asarray(p),
                                                         jnp.asarray(world))
  out = colliders._fw_closest_point(torch.tensor(p), torch.tensor(world))
  assert _scaled(out.numpy(), ref) <= TOL


def test_sphere_mesh_matches_jax():
  """Spheres around a hull, one grazing it, one with its center deep
  inside (the normal from the `inside` branch: toward the hull's vertex
  mean)."""
  jm, _ = _models()
  rng = np.random.RandomState(1)
  n = 8
  hulls = _hulls(jm, ['hand_3finger'] * n)
  m_pos, m_mat = _poses(rng, n)
  s_pos = m_pos + rng.uniform(-0.15, 0.15, (n, 3))
  world = m_pos[:, None] + np.einsum('nij,nkj->nki', m_mat, hulls)
  # deep inside: a fifth of the way from the vertex mean to a vertex
  s_pos[0] = 0.8 * world[0].mean(0) + 0.2 * world[0][0]
  s_size = np.tile([[0.05, 0.0, 0.0]], (n, 1))
  closest = np.asarray(jax.jit(jax.vmap(jcolliders._fw_closest_point))(
      jnp.asarray(s_pos), jnp.asarray(world)))
  s_pos[1] = closest[1] + 0.05 * (s_pos[1] - closest[1]) / np.linalg.norm(
      s_pos[1] - closest[1])                       # grazing
  s_mat = _poses(rng, n)[1]
  ref, out = _both(jcolliders._sphere_mesh, colliders._sphere_mesh, s_pos,
                   s_mat, s_size, m_pos, m_mat, s_size, hulls)
  _check('sphere-mesh', ref, out)
  inside = np.linalg.norm(closest - s_pos, axis=1) < 1e-9
  assert inside[0] and not inside[1:].any()
  assert abs(out[0][1, 0]) < 1e-6                  # grazing: dist ~0


def test_capsule_mesh_matches_jax():
  jm, _ = _models()
  rng = np.random.RandomState(2)
  n = 8
  hulls = _hulls(jm, ['forearm'] * n)
  m_pos, m_mat = _poses(rng, n)
  c_pos, c_mat = _poses(rng, n)
  c_size = np.tile([[0.03, 0.08, 0.0]], (n, 1))
  ref, out = _both(jcolliders._capsule_mesh, colliders._capsule_mesh, c_pos,
                   c_mat, c_size, m_pos, m_mat, c_size, hulls)
  _check('capsule-mesh', ref, out)
  assert (out[0] < 0).any() and (out[0] > 0).any()


def test_mesh_mesh_matches_jax():
  """Hull pairs overlapping and apart, and two copies of one hull set side
  by side 1e-7 apart along x (the witnesses, 6 x 8 Frank-Wolfe steps from
  the vertex means, stop short of the gap there)."""
  jm, _ = _models()
  rng = np.random.RandomState(3)
  n = 8
  hulls1 = _hulls(jm, ['finger_distal', 'shoulder'] * (n // 2))
  hulls2 = _hulls(jm, ['finger_proximal', 'wrist_spherical_1'] * (n // 2))
  pos1, mat1 = _poses(rng, n)
  pos2, mat2 = _poses(rng, n)
  pos2[1:4] = pos1[1:4] + rng.uniform(-0.01, 0.01, (3, 3))   # overlapping
  hulls2[0] = hulls1[0]
  mat1[0] = mat2[0] = np.eye(3)
  width = hulls1[0][:, 0].max() - hulls1[0][:, 0].min()
  pos2[0] = pos1[0] + [width + 1e-7, 0.0, 0.0]
  size = np.zeros((n, 3))
  ref, out = _both(jcolliders._mesh_mesh, colliders._mesh_mesh, pos1, mat1,
                   size, pos2, mat2, size, hulls1, hulls2)
  _check('mesh-mesh', ref, out)
  print(f'mesh-mesh dists {out[0][:, 0].tolist()}')
  assert np.isfinite(out[0]).all()


def test_box_and_plane_mesh_match_jax():
  """box-mesh (the box's 8 corners as a hull) and plane-mesh (the three
  deepest hull vertices, a stable sort) through the JAX package's
  `_collide_mesh` on jaco's link-2 mesh, against the port's dispatch
  table."""
  from dm_control_tpu._src.types import GeomType as JGeomType
  from dm_control_tpu_torch._src.types import GeomType
  jm, m = _models()
  rng = np.random.RandomState(4)
  n = 8
  g2 = np.full(n, jm.name2id('geom', 'jaco_link_2'))
  hulls = colliders.hull_table(m)[m.geom_dataid[g2]]
  m_pos, m_mat = _poses(rng, n)
  b_pos, b_mat = _poses(rng, n)
  b_pos[:4] = m_pos[:4] + rng.uniform(-0.03, 0.03, (4, 3))    # overlapping
  b_size = rng.uniform(0.02, 0.08, (n, 3))
  p_pos, p_mat = np.zeros((n, 3)), _poses(rng, n)[1]
  for t1, (pos1, mat1) in ((GeomType.BOX, (b_pos, b_mat)),
                           (GeomType.PLANE, (p_pos, p_mat))):
    grp = type('Group', (), dict(t1=JGeomType(int(t1)), t2=JGeomType.MESH))
    ref = jax.jit(jax.vmap(lambda g, *a: jcolliders._collide_mesh(
        jm, None, grp, None, g, *a)))(*map(jnp.asarray, (
            g2, pos1, mat1, b_size, m_pos, m_mat, b_size)))
    out = colliders._COLLIDERS[t1, GeomType.MESH](*map(torch.tensor, (
        pos1, mat1, b_size, m_pos, m_mat, b_size, hulls)))
    _check(f'{t1.name.lower()}-mesh', [np.asarray(r) for r in ref],
           [o.numpy() for o in out])
    if t1 == GeomType.PLANE:             # hulls across the plane and above
      assert (out[0] < 0).any() and (out[0] > 0).any()


def test_jaco_collide_matches_jax():
  """The jaco model's whole narrowphase (13 static sphere-mesh pairs, the
  top-K 20 of 79 mesh-mesh pairs) on arm poses near home: every contact's
  pair as the JAX package's, and every contact within ten margins of
  touching within 1e-12 in each field.  A pair further apart keeps its
  Frank-Wolfe iterate short of the closest points (6 x 8 steps), where a
  near tie of two vertices' support scores (~1e-16 apart) takes the two
  packages down different paths: its distance only within 1e-4 (it is
  50 margins from any force)."""
  jm, m = _models()
  rng = np.random.RandomState(5)
  n = 6
  home = np.array([4.92, 2.839, 0.0, .758, 4.6366, 4.493, 5.0249, 1.1, 0.1,
                   1.1, 0.1, 1.1, 0.1])
  qpos = home + 0.4 * rng.randn(n, jm.nq)
  d0 = jforward.make_data(jm)
  jd = jax.jit(jax.vmap(lambda q: jforward.forward(jm, d0.replace(qpos=q))))(
      jnp.asarray(qpos))
  d = forward.forward(m, forward.make_data(m, n, torch.float64, 'cpu').replace(
      qpos=torch.tensor(qpos)))
  for f in ('geom1', 'geom2'):
    np.testing.assert_array_equal(getattr(d.contact, f).numpy(),
                                  np.asarray(getattr(jd.contact, f)))
  ref_dist = np.asarray(jd.contact.dist)
  near = ref_dist < 10 * np.asarray(jd.contact.includemargin)
  for f in ('dist', 'pos', 'frame'):
    err = _scaled(getattr(d.contact, f).numpy()[near],
                  np.asarray(getattr(jd.contact, f))[near])
    assert err <= TOL, f'contact.{f}: {err:.2e}'
  far = np.abs(d.contact.dist.numpy() - ref_dist)[~near].max(initial=0.0)
  err = _scaled(d.qacc.numpy(), np.asarray(jd.qacc))
  print(f'jaco forward: {int(near.sum())} contacts near touching within '
        f'1e-12; the others\' dist within {far:.2e}; qacc {err:.2e}')
  assert near.sum() >= 3 and far <= 1e-4 and err <= 1e-9


def test_raycast_against_meshes_matches_jax():
  """Rays from outside the arm at each mesh geom of a jaco pose (and rays
  that miss): the port's batched `render.raycast` against the JAX
  package's, ray by ray, hull triangles included."""
  jm, m = _models()
  rng = np.random.RandomState(6)
  home = np.array([4.92, 2.839, 0.0, .758, 4.6366, 4.493, 5.0249, 1.1, 0.1,
                   1.1, 0.1, 1.1, 0.1])
  jd = jax.jit(lambda q: jforward.forward(jm, jforward.make_data(jm).replace(
      qpos=q)))(jnp.asarray(home))
  meshes_g = np.flatnonzero(jm.geom_type == 7)
  centers = np.asarray(jd.geom_xpos)[meshes_g]
  origin = centers + rng.randn(len(meshes_g), 3) * 0.5
  direction = centers - origin + 0.02 * rng.randn(len(meshes_g), 3)
  direction[-2:] = -direction[-2:]                 # two rays away
  direction /= np.linalg.norm(direction, axis=1, keepdims=True)
  ref = np.array([float(jrender.raycast(jm, jd, jnp.asarray(o), jnp.asarray(v)))
                  for o, v in zip(origin, direction)])
  d = forward.forward(m, forward.make_data(m, 1, torch.float64, 'cpu').replace(
      qpos=torch.tensor(home)[None]))
  out = render.raycast(m, d, torch.tensor(origin)[None],
                       torch.tensor(direction)[None])[0].numpy()
  print(f'raycast against meshes: {out.tolist()} (JAX {ref.tolist()})')
  assert (ref > 0).sum() >= len(meshes_g) // 2 and (ref == -1).any()
  assert _scaled(out, ref) <= TOL
  np.testing.assert_array_equal(render._hull_tri_table(m),
                                jrender._hull_tri_table(jm))
