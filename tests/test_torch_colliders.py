"""The port's new narrowphase colliders against the JAX package's.

Each collider of the finger path (plane-cylinder, capsule-capsule,
sphere-cylinder, capsule-cylinder, cylinder-cylinder), of ball_in_cup's
(plane-sphere, sphere-capsule), of humanoid's (sphere-sphere), of
quadruped's (plane-ellipsoid, sphere-ellipsoid, capsule-ellipsoid) and of
humanoid_CMU's (ellipsoid-ellipsoid) runs
on the same seeded numpy poses (64 per case, float64) in both packages:
generic overlapping poses, grazing ones (the surfaces about touching),
nearly parallel axes, for the cylinders poses that put the contact on a
rim, on a cap or deep inside, a sphere beyond a capsule's end, and a
sphere's center inside an ellipsoid.  dist, pos and the normal agree to
1e-9 (the two evaluate the same closed forms; they differ only in
rounding).  Then finger's and ball_in_cup's `collide_all` are held to the
JAX package's at seeded states.  The box colliders (plane-box, sphere-box,
capsule-box, box-box) are held the same way on their own poses and
degenerate cases, each pair's contacts compared as a set, and stack_2's
and insert_peg's `collide_all` at states with the props on the floor,
stacked or in the slot; a pair with no collider raises naming it.  dog's
three (ellipsoid-box, ellipsoid-cylinder, cylinder-box) are held the same
way on their own poses.
The heightfield (escape's terrain, a field of its own per lane in
`model_var`) is held the same way: its bilinear height and slope at
points across the grid, on cell edges and off it, and its contacts with
spheres, capsules, ellipsoids and cylinders placed about touching it.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dm_control_tpu._src import colliders as jcolliders
from dm_control_tpu._src import collision as jcollision
from dm_control_tpu._src import engine as jengine
from dm_control_tpu._src import forward as jforward
from dm_control_tpu._src import math as jmath
from dm_control_tpu._src import smooth as jsmooth
from dm_control_tpu.suite import common as jcommon
from dm_control_tpu_torch._src import colliders
from dm_control_tpu_torch._src import collision
from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch._src import forward
from dm_control_tpu_torch._src import math
from dm_control_tpu_torch._src import smooth
from dm_control_tpu_torch.suite import common

B = 64
TOL = 1e-9


def _rot(rng, n, tilt=None):
  """n random rotation matrices; with `tilt`, rotations by at most that
  angle about a random axis (near the identity)."""
  axis = rng.randn(n, 3)
  axis /= np.linalg.norm(axis, axis=1, keepdims=True)
  angle = (rng.uniform(0, tilt, n) if tilt is not None
           else rng.uniform(-np.pi, np.pi, n))
  K = np.zeros((n, 3, 3))
  K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -axis[:, 2], axis[:, 1], -axis[:, 0]
  K = K - K.transpose(0, 2, 1)
  s, c = np.sin(angle)[:, None, None], np.cos(angle)[:, None, None]
  return np.eye(3) + s * K + (1 - c) * K @ K


def _size(rng, n, r=(0.02, 0.1), h=(0.03, 0.2)):
  return np.stack([rng.uniform(*r, n), rng.uniform(*h, n),
                   np.zeros(n)], -1)


def _poses(kind, case, rng):
  """(pos1, mat1, size1, pos2, mat2, size2) numpy arrays for B pairs."""
  mat1 = _rot(rng, B)
  pos1 = rng.uniform(-0.1, 0.1, (B, 3))
  size1, size2 = _size(rng, B), _size(rng, B)
  if kind == 'plane_cylinder':
    size1 = np.tile([1.0, 1.0, 0.1], (B, 1))
    if case == 'near_parallel':      # cylinder axis ~ plane normal
      mat2 = mat1 @ _rot(rng, B, tilt=1e-3)
    else:
      mat2 = _rot(rng, B)
    n = mat1[:, :, 2]
    # height of the cylinder centre over the plane: deep, grazing
    lo, hi = (-0.05, 0.1) if case == 'generic' else (0.0, 0.25)
    pos2 = pos1 + rng.uniform(-0.2, 0.2, (B, 3))
    pos2 += n * (rng.uniform(lo, hi, B) - (n * (pos2 - pos1)).sum(1))[:, None]
    return pos1, mat1, size1, pos2, mat2, size2
  if kind == 'plane_sphere':
    size1 = np.tile([1.0, 1.0, 0.1], (B, 1))
    size2 = np.stack([rng.uniform(0.01, 0.05, B), np.zeros(B),
                      np.zeros(B)], -1)
    n = mat1[:, :, 2]
    # height of the sphere's centre over the plane: deep, or about r
    lo, hi = (-0.05, 0.1) if case == 'generic' else (-0.005, 0.005)
    h = rng.uniform(lo, hi, B) + (size2[:, 0] if case == 'grazing' else 0.0)
    pos2 = pos1 + rng.uniform(-0.2, 0.2, (B, 3))
    pos2 += n * (h - (n * (pos2 - pos1)).sum(1))[:, None]
    return pos1, mat1, size1, pos2, _rot(rng, B), size2
  if kind == 'sphere_capsule':
    size1 = np.stack([rng.uniform(0.01, 0.05, B), np.zeros(B),
                      np.zeros(B)], -1)
    mat2 = _rot(rng, B)
    pos2 = rng.uniform(-0.1, 0.1, (B, 3))
    axis, hl = mat2[:, :, 2], size2[:, 1:2]
    gap = (size1[:, 0] + size2[:, 0] + rng.uniform(-0.005, 0.005, B))[:, None]
    if case == 'grazing':  # beside the axis, about touching
      u = np.cross(axis, rng.randn(B, 3))
      u /= np.linalg.norm(u, axis=1, keepdims=True)
      pos1 = pos2 + axis * hl * rng.uniform(-1, 1, (B, 1)) + u * gap
    elif case == 'end':    # beyond an end of the axis, about touching
      pos1 = pos2 + axis * (hl + gap) * rng.choice([-1.0, 1.0], (B, 1))
    else:
      pos1 = pos2 + rng.uniform(-0.15, 0.15, (B, 3))
    return pos1, mat1, size1, pos2, mat2, size2
  if kind == 'sphere_sphere':
    size1, size2 = (np.stack([rng.uniform(0.01, 0.08, B), np.zeros(B),
                              np.zeros(B)], -1) for _ in range(2))
    if case == 'grazing':  # the surfaces about touching
      offset = rng.randn(B, 3)
      offset /= np.linalg.norm(offset, axis=1, keepdims=True)
      pos2 = pos1 + offset * (size1[:, 0] + size2[:, 0]
                              + rng.uniform(-0.005, 0.005, B))[:, None]
    else:
      pos2 = pos1 + rng.uniform(-0.12, 0.12, (B, 3))
    return pos1, mat1, size1, pos2, _rot(rng, B), size2
  if kind == 'ellipsoid_ellipsoid':
    size1, size2 = (rng.uniform(0.02, 0.1, (B, 3)) for _ in range(2))
    mat2 = _rot(rng, B)
    if case == 'grazing':  # the radii along the center line about touching
      n = rng.randn(B, 3)
      n /= np.linalg.norm(n, axis=1, keepdims=True)
      r1, r2 = (1.0 / np.linalg.norm(np.einsum('bij,bi->bj', m, n) / s,
                                     axis=1)
                for m, s in ((mat1, size1), (mat2, size2)))
      pos2 = pos1 + n * (r1 + r2 + rng.uniform(-0.005, 0.005, B))[:, None]
    else:
      pos2 = pos1 + rng.uniform(-0.15, 0.15, (B, 3))
    return pos1, mat1, size1, pos2, mat2, size2
  if kind.endswith('ellipsoid'):
    size2 = rng.uniform(0.02, 0.1, (B, 3))         # the semi-axes
    mat2 = _rot(rng, B)
    if kind == 'plane_ellipsoid':
      size1 = np.tile([1.0, 1.0, 0.1], (B, 1))
      n = mat1[:, :, 2]
      # the support radius along n: the center's height when touching
      reach = np.linalg.norm(size2 * np.einsum('bij,bi->bj', mat2, n),
                             axis=1)
      lo, hi = (-0.05, 0.1) if case == 'generic' else (-0.005, 0.005)
      h = rng.uniform(lo, hi, B) + (reach if case == 'grazing' else 0.0)
      pos2 = pos1 + rng.uniform(-0.2, 0.2, (B, 3))
      pos2 += n * (h - (n * (pos2 - pos1)).sum(1))[:, None]
      return pos1, mat1, size1, pos2, mat2, size2
    if kind == 'sphere_ellipsoid':
      size1 = np.stack([rng.uniform(0.01, 0.05, B), np.zeros(B),
                        np.zeros(B)], -1)
    pos2 = rng.uniform(-0.1, 0.1, (B, 3))
    if case == 'inside':   # the sphere's center within the ellipsoid
      u = rng.randn(B, 3)
      u /= np.linalg.norm(u, axis=1, keepdims=True)
      local = u * size2 * rng.uniform(0.1, 0.9, (B, 1))
      pos1 = pos2 + np.einsum('bij,bj->bi', mat2, local)
    else:
      pos1 = pos2 + rng.uniform(-0.15, 0.15, (B, 3))
    return pos1, mat1, size1, pos2, mat2, size2
  if case == 'near_parallel':
    mat2 = mat1 @ _rot(rng, B, tilt=1e-3)
  else:
    mat2 = _rot(rng, B)
  if kind == 'sphere_cylinder':
    size1 = np.stack([rng.uniform(0.01, 0.05, B), np.zeros(B),
                      np.zeros(B)], -1)
    R, hl = size2[:, 0], size2[:, 1]
    ang = rng.uniform(-np.pi, np.pi, B)
    u = np.stack([np.cos(ang), np.sin(ang), np.zeros(B)], -1)
    ez = np.array([0.0, 0.0, 1.0])
    sgn = rng.choice([-1.0, 1.0], B)[:, None]
    if case == 'rim':      # beyond the rim edge, diagonally outward
      local = (u * (R + rng.uniform(-0.01, 0.03, B))[:, None]
               + sgn * ez * (hl + rng.uniform(-0.01, 0.03, B))[:, None])
    elif case == 'cap':    # over a cap, inside the radius
      local = (u * (R * rng.uniform(0, 0.9, B))[:, None]
               + sgn * ez * (hl + rng.uniform(-0.03, 0.05, B))[:, None])
    elif case == 'inside':
      local = (u * (R * rng.uniform(0, 0.95, B))[:, None]
               + sgn * ez * (hl * rng.uniform(0, 0.95, B))[:, None])
    else:                  # side, grazing or generic
      local = (u * (R + rng.uniform(-0.02, 0.06, B))[:, None]
               + ez * (hl * rng.uniform(-0.9, 0.9, B))[:, None])
    pos1 = pos2 = rng.uniform(-0.1, 0.1, (B, 3))
    pos1 = pos2 + np.einsum('bij,bj->bi', mat2, local)
    return pos1, mat1, size1, pos2, mat2, size2
  # segment pairs: capsule-capsule, capsule-cylinder, cylinder-cylinder
  if case == 'grazing':
    # the axes' closest points about r1 + r2 apart
    offset = rng.randn(B, 3)
    offset /= np.linalg.norm(offset, axis=1, keepdims=True)
    pos2 = pos1 + offset * (size1[:, 0] + size2[:, 0]
                            + rng.uniform(-0.005, 0.005, B))[:, None]
  elif case == 'rim':      # cylinder 2 tilted over cylinder 1's cap edge
    mat2 = mat1 @ _rot(rng, B, tilt=0.6)
    side = mat1[:, :, 0]
    pos2 = (pos1 + mat1[:, :, 2] * (size1[:, 1] + size2[:, 1]
                                    + rng.uniform(-0.03, 0.0, B))[:, None]
            + side * size1[:, :1])
  elif case == 'cap':      # stacked on the cap, tilted a little
    mat2 = mat1 @ _rot(rng, B, tilt=0.05)
    pos2 = pos1 + mat1[:, :, 2] * (size1[:, 1] + size2[:, 1]
                                   + rng.uniform(-0.02, 0.01, B))[:, None]
  else:
    pos2 = pos1 + rng.uniform(-0.15, 0.15, (B, 3))
  return pos1, mat1, size1, pos2, mat2, size2


CASES = {
    'plane_cylinder': ('generic', 'grazing', 'near_parallel'),
    'capsule_capsule': ('generic', 'grazing', 'near_parallel'),
    'sphere_cylinder': ('generic', 'rim', 'cap', 'inside', 'near_parallel'),
    'capsule_cylinder': ('generic', 'grazing', 'near_parallel', 'cap'),
    'cylinder_cylinder': ('generic', 'grazing', 'near_parallel', 'rim',
                          'cap'),
    # ball_in_cup's ball against the floor and the cup
    'plane_sphere': ('generic', 'grazing'),
    'sphere_capsule': ('generic', 'grazing', 'end'),
    # humanoid's self-contacts and quadruped's feet and body
    'sphere_sphere': ('generic', 'grazing'),
    'plane_ellipsoid': ('generic', 'grazing'),
    'sphere_ellipsoid': ('generic', 'inside'),
    'capsule_ellipsoid': ('generic',),
    # humanoid_CMU's one ellipsoid pair
    'ellipsoid_ellipsoid': ('generic', 'grazing'),
}
PARAMS = [(k, c) for k, cases in CASES.items() for c in cases]


def _scaled(a, ref):
  return float((np.abs(a - ref) / np.maximum(1.0, np.abs(ref))).max())


@pytest.mark.parametrize('kind,case', PARAMS,
                         ids=[f'{k}-{c}' for k, c in PARAMS])
def test_collider_matches_jax(kind, case):
  seed = PARAMS.index((kind, case))
  args = _poses(kind, case, np.random.RandomState(seed))
  ref = getattr(jcolliders, '_' + kind)(*[jnp.asarray(a) for a in args])
  out = getattr(colliders, '_' + kind)(*[torch.tensor(a) for a in args])
  ref = [np.asarray(r) for r in ref]
  out = [o.numpy() for o in out]
  dist = ref[0][ref[0] < 1e9]
  print(f'{kind}/{case}: {int((dist < 0).sum())} of {dist.size} contacts '
        f'penetrating; max err', end='')
  for name, a, r in zip(('dist', 'pos', 'normal'), out, ref):
    assert a.shape == r.shape, (name, a.shape, r.shape)
    err = _scaled(a, r)
    print(f' {name} {err:.1e}', end='')
    assert err <= TOL, f'{kind}/{case} {name}: {err:.2e}'
  print()
  # every case reaches contacts, and none is all inside
  assert (dist < 0.01).any() and (dist > -0.5).all()


def test_segment_helpers_match_jax():
  rng = np.random.RandomState(3)
  pts = [rng.randn(B, 3) for _ in range(5)]
  pts[3] = pts[2] + 1e-3 * rng.randn(B, 3)          # short segments
  a = jmath.closest_segment_point(*map(jnp.asarray, pts[:3]))
  b = math.closest_segment_point(*map(torch.tensor, pts[:3]))
  assert _scaled(b.numpy(), np.asarray(a)) <= TOL
  for q2 in (pts[3], pts[4]):
    args = (pts[0], pts[1], pts[2], q2)
    ra = jmath.closest_segment_to_segment_points(*map(jnp.asarray, args))
    pa = math.closest_segment_to_segment_points(*map(torch.tensor, args))
    for x, y in zip(pa, ra):
      assert _scaled(x.numpy(), np.asarray(y)) <= TOL


def _finger_states(n, rng):
  m = jengine.load_model(jcommon.model_path('finger.xml'))
  qpos = np.zeros((n, m.nq))
  for j in range(m.njnt):
    a = m.jnt_qposadr[j]
    lo, hi = m.jnt_range[j] if m.jnt_limited[j] else (-np.pi, np.pi)
    qpos[:, a] = rng.uniform(lo, hi, n)
  return m, qpos


def test_finger_collide_all_matches_jax():
  """finger's 23 candidate pairs in 5 groups at seeded joint angles, with
  the lanes in contact first.  dist and every per-contact constant agree
  everywhere; pos and frame agree on the contacts that can touch.  The
  two decoration cylinders never do (they sit 0.4 apart on parallel axes,
  symmetric in y): their two deepest candidates tie in depth, and
  rounding picks either of the mirror-image points."""
  jm, qpos = _finger_states(1024, np.random.RandomState(0))

  def collide(q):
    d = jforward.make_data(jm).replace(qpos=q)
    return jcollision.collide(jm, jsmooth.kinematics(jm, d)).contact

  con = jax.jit(jax.vmap(collide))(jnp.asarray(qpos))
  hit = np.asarray((con.dist < con.includemargin).any(1))
  lanes = np.concatenate([np.nonzero(hit)[0][:12], np.nonzero(~hit)[0][:4]])
  pm = engine.load_model(common.model_path('finger.xml'), device='cpu')
  d = forward.make_data(pm, len(lanes), torch.float64, 'cpu')
  d = collision.collide(pm, smooth.kinematics(
      pm, d.replace(qpos=torch.tensor(qpos[lanes]))))
  assert [(g.t1.name, g.t2.name, g.K) for g in collision.groups(pm)] == [
      ('PLANE', 'CAPSULE', 4), ('PLANE', 'CYLINDER', 2),
      ('CAPSULE', 'CAPSULE', 4), ('CAPSULE', 'CYLINDER', 4),
      ('CYLINDER', 'CYLINDER', 1)]
  dist = np.asarray(con.dist)[lanes]
  near = dist < 0.1
  print(f'finger collide_all: {int(hit.sum())} of 1024 states in contact; '
        f'max err', end='')
  for f in ('dist', 'pos', 'frame', 'includemargin', 'friction', 'solref',
            'solimp', 'geom1', 'geom2', 'body1', 'body2', 'dim'):
    ref = np.asarray(getattr(con, f))[lanes]
    out = getattr(d.contact, f).numpy()
    assert out.shape == ref.shape, f
    if f in ('pos', 'frame'):
      ref, out = ref[near], out[near]
    err = _scaled(out, ref)
    print(f' {f} {err:.1e}', end='')
    assert err <= TOL, f'{f}: {err:.2e}'
  print()
  assert near[:12].sum() >= 12


def test_ball_in_cup_collide_all_matches_jax():
  """ball_in_cup's 11 candidate pairs in 3 groups (the ball on the floor,
  the cup on the floor, the ball on the cup) at seeded states: the ball
  in the cup, on the floor, or free.  Every contact field agrees within
  TOL, and each group touches on some lane."""
  jm = jengine.load_model(jcommon.model_path('ball_in_cup.xml'))
  rng = np.random.RandomState(5)
  n = 24
  # (cup_x, cup_z, ball_x, ball_z) per lane: a third each in the cup, on
  # the floor under a lowered cup, and anywhere near the cup
  qpos = np.zeros((n, jm.nq))
  third = n // 3
  qpos[:third, 2] = rng.uniform(-0.06, 0.06, third)
  qpos[:third, 3] = rng.uniform(0.25, 0.28, third)
  qpos[third:2 * third, 1] = rng.uniform(-0.6, -0.45, third)
  qpos[third:2 * third, 2] = rng.uniform(-0.1, 0.1, third)
  qpos[third:2 * third, 3] = rng.uniform(-0.18, -0.17, third)
  qpos[2 * third:] = rng.uniform([-.1, -.1, -.2, .1], [.1, .1, .2, .4],
                                 (n - 2 * third, 4))

  def collide(q):
    d = jforward.make_data(jm).replace(qpos=q)
    return jcollision.collide(jm, jsmooth.kinematics(jm, d)).contact

  con = jax.jit(jax.vmap(collide))(jnp.asarray(qpos))
  pm = engine.load_model(common.model_path('ball_in_cup.xml'), device='cpu')
  d = forward.make_data(pm, n, torch.float64, 'cpu')
  d = collision.collide(pm, smooth.kinematics(
      pm, d.replace(qpos=torch.tensor(qpos))))
  groups = collision.groups(pm)
  assert [(g.t1.name, g.t2.name, g.K) for g in groups] == [
      ('PLANE', 'SPHERE', 1), ('PLANE', 'CAPSULE', 5),
      ('SPHERE', 'CAPSULE', 5)]
  print('ball_in_cup collide_all: max err', end='')
  for f in ('dist', 'pos', 'frame', 'includemargin', 'friction', 'solref',
            'solimp', 'geom1', 'geom2', 'body1', 'body2', 'dim'):
    ref = np.asarray(getattr(con, f))
    out = getattr(d.contact, f).numpy()
    assert out.shape == ref.shape, f
    err = _scaled(out, ref)
    print(f' {f} {err:.1e}', end='')
    assert err <= TOL, f'{f}: {err:.2e}'
  print()
  on = (d.contact.dist < d.contact.includemargin).numpy()
  start = 0
  for g in groups:
    assert on[:, start:start + g.ncon].any(), (g.t1.name, g.t2.name)
    start += g.ncon


# -- the box colliders (manipulator's slot, stacker's boxes) ----------------


def _axis_rot(axis, angle):
  """(n, 3, 3) rotations by angle (n,) about the fixed axis 0, 1 or 2."""
  c, s = np.cos(angle), np.sin(angle)
  R = np.tile(np.eye(3), (len(angle), 1, 1))
  i, j = [(1, 2), (2, 0), (0, 1)][axis]
  R[:, i, i], R[:, i, j], R[:, j, i], R[:, j, j] = c, -s, s, c
  return R


def _box_poses(kind, case, rng):
  """(pos1, mat1, size1, pos2, mat2, size2) numpy arrays for B pairs of a
  box collider: generic overlapping poses, and its degenerate ones: a box
  flat on the plane (4 corners tied) or resting on an edge (tied in
  pairs); a sphere whose center is inside the box, or about touching a
  face; a capsule lying parallel to a face; boxes face to face (a small
  tilt, sizes apart) and boxes whose deepest axis is an edge pair."""
  mat1 = _rot(rng, B)
  pos1 = rng.uniform(-0.1, 0.1, (B, 3))
  box = rng.uniform(0.01, 0.1, (B, 3))
  if kind == 'plane_box':
    plane = np.tile([1.0, 1.0, 0.1], (B, 1))
    n = mat1[:, :, 2]
    yaw = _axis_rot(2, rng.uniform(-np.pi, np.pi, B))
    if case == 'flat':
      mat2 = mat1 @ yaw
      h = box[:, 2] + rng.uniform(-0.005, 0.005, B)
    elif case == 'edge':
      mat2 = mat1 @ yaw @ _axis_rot(0, np.full(B, np.pi / 4))
      h = np.sqrt(0.5) * (box[:, 1] + box[:, 2]) + rng.uniform(-0.005, 0.005,
                                                              B)
    else:
      mat2 = _rot(rng, B)
      h = rng.uniform(-0.05, 0.1, B)
    pos2 = pos1 + rng.uniform(-0.2, 0.2, (B, 3))
    pos2 += n * (h - (n * (pos2 - pos1)).sum(1))[:, None]
    return pos1, mat1, plane, pos2, mat2, box
  mat2 = _rot(rng, B)
  pos2 = rng.uniform(-0.1, 0.1, (B, 3))
  if kind == 'sphere_box':
    sphere = np.stack([rng.uniform(0.01, 0.05, B), np.zeros(B),
                       np.zeros(B)], -1)
    if case == 'inside':
      local = box * rng.uniform(-0.9, 0.9, (B, 3))
    elif case == 'grazing':     # over a face, about r from it
      local = box * rng.uniform(-0.9, 0.9, (B, 3))
      ax = rng.randint(3, size=B)
      sgn = rng.choice([-1.0, 1.0], B)
      local[np.arange(B), ax] = sgn * (box[np.arange(B), ax] + sphere[:, 0]
                                       + rng.uniform(-0.005, 0.005, B))
    else:
      local = rng.uniform(-0.15, 0.15, (B, 3))
    return (pos2 + np.einsum('bij,bj->bi', mat2, local), mat1, sphere, pos2,
            mat2, box)
  if kind == 'capsule_box':
    capsule = _size(rng, B)
    if case == 'parallel':      # lying on the box's top face along its x
      mat1 = mat2 @ _axis_rot(1, np.full(B, np.pi / 2))
      local = np.stack([rng.uniform(-0.5, 0.5, B) * box[:, 0],
                        rng.uniform(-0.5, 0.5, B) * box[:, 1],
                        box[:, 2] + capsule[:, 0]
                        + rng.uniform(-0.005, 0.005, B)], -1)
      pos1 = pos2 + np.einsum('bij,bj->bi', mat2, local)
    else:
      pos1 = pos2 + rng.uniform(-0.15, 0.15, (B, 3))
    return pos1, mat1, capsule, pos2, mat2, box
  if case == 'face':            # box 2 on box 1's top face, a little turned
    box2 = box * rng.uniform(0.5, 0.8, (B, 3))
    mat2 = mat1 @ _axis_rot(2, rng.uniform(-np.pi, np.pi, B)) @ _rot(
        rng, B, tilt=0.02)
    local = np.stack([rng.uniform(-0.3, 0.3, B) * box[:, 0],
                      rng.uniform(-0.3, 0.3, B) * box[:, 1],
                      box[:, 2] + box2[:, 2] + rng.uniform(-0.005, 0.001, B)],
                     -1)
    return (pos1, mat1, box, pos1 + np.einsum('bij,bj->bi', mat1, local),
            mat2, box2)
  if case == 'edge':            # kept where an edge pair's axis wins
    out = [[] for _ in range(6)]
    while len(out[0]) < B:
      args = [pos1, mat1, box, pos1 + rng.uniform(-0.1, 0.1, (B, 3)),
              _rot(rng, B), rng.uniform(0.01, 0.1, (B, 3))]
      cand = colliders.box_box_axes(*map(torch.tensor, args))[-1]
      dist = colliders._box_box(*map(torch.tensor, args))[0]
      keep = ((cand.argmax(-1) >= 6) & (dist[:, 0] < 0.005)).numpy()
      for o, a in zip(out, args):
        o.extend(a[keep])
    return tuple(np.asarray(o[:B]) for o in out)
  return (pos1, mat1, box, pos1 + rng.uniform(-0.12, 0.12, (B, 3)), mat2,
          rng.uniform(0.01, 0.1, (B, 3)))


BOX_CASES = {
    'plane_box': ('generic', 'flat', 'edge'),
    'sphere_box': ('generic', 'inside', 'grazing'),
    'capsule_box': ('generic', 'parallel'),
    'box_box': ('generic', 'face', 'edge'),
}
BOX_PARAMS = [(k, c) for k, cases in BOX_CASES.items() for c in cases]


def _as_sets(dist, pos, normal):
  """Each pair's contacts ordered by their position along a fixed generic
  direction, so that two colliders that order tied contacts their own
  way compare contact for contact."""
  key = pos @ np.array([0.6, 0.3, 0.742])
  order = np.argsort(np.where(dist < 1e9, key, np.inf), axis=-1,
                     kind='stable')
  take = lambda x: np.take_along_axis(x, order[..., None] if x.ndim == 3
                                      else order, axis=1)
  return take(dist), take(pos), take(normal)


@pytest.mark.parametrize('kind,case', BOX_PARAMS,
                         ids=[f'{k}-{c}' for k, c in BOX_PARAMS])
def test_box_collider_matches_jax(kind, case):
  """The box colliders on seeded numpy poses, float64, against the JAX
  package's: each pair's contacts compared as a set (`_as_sets`: a flat
  box's 4 corners, or an edge's 2, are tied in depth and each package's
  sort rounds the tie its own way), dist within 1e-9 scaled on every slot
  and pos and normal on the slots that hold a contact (dist < 1e9; the
  others are the clipping's padding).  The face case builds manifolds of
  3 or more contacts, the edge case one contact per pair."""
  seed = 100 + BOX_PARAMS.index((kind, case))
  args = _box_poses(kind, case, np.random.RandomState(seed))
  ref = getattr(jcolliders, '_' + kind)(*[jnp.asarray(a) for a in args])
  out = getattr(colliders, '_' + kind)(*[torch.tensor(a) for a in args])
  ref = _as_sets(*[np.asarray(r) for r in ref])
  out = _as_sets(*[o.numpy() for o in out])
  has = ref[0] < 1e9
  np.testing.assert_array_equal(out[0] < 1e9, has)
  print(f'{kind}/{case}: {int((ref[0] < 0).sum())} of {int(has.sum())} '
        f'contacts penetrating; max err', end='')
  for name, a, r in zip(('dist', 'pos', 'normal'), out, ref):
    assert a.shape == r.shape, (name, a.shape, r.shape)
    err = _scaled(a[has], r[has]) if name != 'dist' else _scaled(a, r)
    print(f' {name} {err:.1e}', end='')
    assert err <= TOL, f'{kind}/{case} {name}: {err:.2e}'
  print()
  assert (ref[0] < 0.01).any() and (ref[0] > -0.5).all()
  per_pair = has.sum(-1)
  if case == 'face':
    assert (per_pair >= 3).mean() >= 0.5, per_pair
  if case == 'edge' and kind == 'box_box':
    assert (per_pair == 1).all(), per_pair


def _dog_poses(kind, case, rng):
  """(pos1, mat1, size1, pos2, mat2, size2) numpy arrays for B pairs of
  the twelfth slice's colliders (dog's): an ellipsoid against a box or a
  cylinder, a cylinder against a box.  Generic poses; an ellipsoid's
  center over a face of the box, or beside the cylinder's side, about its
  support radius along the face's normal away (grazing); its center inside
  the box; over the cylinder's cap; a cylinder lying on the box's top
  face, its axis along the face."""
  box = rng.uniform(0.01, 0.1, (B, 3))
  mat2 = _rot(rng, B)
  pos2 = rng.uniform(-0.1, 0.1, (B, 3))
  if kind.startswith('ellipsoid'):
    ell = rng.uniform(0.02, 0.1, (B, 3))
    mat1 = _rot(rng, B)
    size2 = box if kind == 'ellipsoid_box' else _size(rng, B)

    def reach(n_local):
      """The ellipsoid's support radius along mat2 @ n_local."""
      n = np.einsum('bij,bj->bi', mat2, n_local)
      return np.linalg.norm(ell * np.einsum('bij,bi->bj', mat1, n), axis=1)

    if kind == 'ellipsoid_box' and case == 'grazing':
      local = box * rng.uniform(-0.9, 0.9, (B, 3))
      ax = rng.randint(3, size=B)
      sgn = rng.choice([-1.0, 1.0], B)
      n_local = np.zeros((B, 3))
      n_local[np.arange(B), ax] = sgn
      local[np.arange(B), ax] = sgn * (box[np.arange(B), ax] + reach(n_local)
                                       + rng.uniform(-0.005, 0.005, B))
    elif case == 'inside':
      local = box * rng.uniform(-0.9, 0.9, (B, 3))
    elif case in ('side', 'cap'):
      R, hl = size2[:, 0], size2[:, 1]
      ang = rng.uniform(-np.pi, np.pi, B)
      u = np.stack([np.cos(ang), np.sin(ang), np.zeros(B)], -1)
      ez = np.tile([0.0, 0.0, 1.0], (B, 1))
      if case == 'side':
        local = (u * (R + reach(u) + rng.uniform(-0.005, 0.005, B))[:, None]
                 + ez * (hl * rng.uniform(-0.9, 0.9, B))[:, None])
      else:
        sgn = rng.choice([-1.0, 1.0], B)[:, None]
        local = (u * (R * rng.uniform(0, 0.9, B))[:, None]
                 + sgn * ez * (hl + reach(sgn * ez)
                               + rng.uniform(-0.005, 0.005, B))[:, None])
    else:
      local = rng.uniform(-0.15, 0.15, (B, 3))
    return (pos2 + np.einsum('bij,bj->bi', mat2, local), mat1, ell, pos2,
            mat2, size2)
  cyl = _size(rng, B)
  if case == 'parallel':
    # the axis's ends over the face
    cyl[:, 1] = box[:, 0] * rng.uniform(0.3, 0.9, B)
    mat1 = mat2 @ _axis_rot(1, np.full(B, np.pi / 2))
    local = np.stack([rng.uniform(-0.1, 0.1, B) * box[:, 0],
                      rng.uniform(-0.5, 0.5, B) * box[:, 1],
                      box[:, 2] + cyl[:, 0] + rng.uniform(-0.005, 0.005, B)],
                     -1)
    return (pos2 + np.einsum('bij,bj->bi', mat2, local), mat1, cyl, pos2,
            mat2, box)
  return pos2 + rng.uniform(-0.15, 0.15, (B, 3)), _rot(rng, B), cyl, pos2, \
      mat2, box


DOG_CASES = {
    'ellipsoid_box': ('generic', 'grazing', 'inside'),
    'ellipsoid_cylinder': ('generic', 'side', 'cap'),
    'cylinder_box': ('generic', 'parallel'),
}
DOG_PARAMS = [(k, c) for k, cases in DOG_CASES.items() for c in cases]


@pytest.mark.parametrize('kind,case', DOG_PARAMS,
                         ids=[f'{k}-{c}' for k, c in DOG_PARAMS])
def test_dog_collider_matches_jax(kind, case):
  """dog's three colliders (ellipsoid-box, ellipsoid-cylinder: one contact
  from the point collider at the ellipsoid's center less its support
  radius along the normal; cylinder-box: capsule-box's two contacts and
  two empty slots) on seeded numpy poses, float64, against the JAX
  package's: each pair's contacts compared as a set (`_as_sets`), dist
  within 1e-9 scaled on every slot, pos and normal on the slots that hold
  a contact."""
  seed = 200 + DOG_PARAMS.index((kind, case))
  args = _dog_poses(kind, case, np.random.RandomState(seed))
  ref = getattr(jcolliders, '_' + kind)(*[jnp.asarray(a) for a in args])
  out = getattr(colliders, '_' + kind)(*[torch.tensor(a) for a in args])
  ref = _as_sets(*[np.asarray(r) for r in ref])
  out = _as_sets(*[o.numpy() for o in out])
  has = ref[0] < 1e9
  np.testing.assert_array_equal(out[0] < 1e9, has)
  print(f'{kind}/{case}: {int((ref[0] < 0).sum())} of {int(has.sum())} '
        f'contacts penetrating; max err', end='')
  for name, a, r in zip(('dist', 'pos', 'normal'), out, ref):
    assert a.shape == r.shape, (name, a.shape, r.shape)
    err = _scaled(a[has], r[has]) if name != 'dist' else _scaled(a, r)
    print(f' {name} {err:.1e}', end='')
    assert err <= TOL, f'{kind}/{case} {name}: {err:.2e}'
  print()
  assert (ref[0] < 0.01).any() and (ref[0][has] > -0.5).all()
  if case in ('grazing', 'side', 'cap', 'parallel'):
    # about touching: both signs of the distance on some pairs
    near = ref[0][has]
    assert (near < 0).any() and (near > 0).any() and (
        np.abs(near) < 0.01).mean() >= 0.5, near


def test_stacker_collide_all_matches_jax():
  """stack_2's and insert_peg's candidate pairs, their box groups (plane-
  box, sphere-box, capsule-box, box-box) among them, at seeded states with
  the props on the floor, stacked or in the slot: dist and every
  per-contact constant agree on every slot of a static group, pos and
  frame on the box groups' contacts within 0.1, the plane-box pairs' 4 contacts as sets (flat
  boxes' corners tie); stack_2's box groups, and insert_peg's capsule-box
  (the peg in its slot), touch on some lane."""
  from dm_control_tpu import suite as jsuite
  from dm_control_tpu_torch import suite
  from test_torch_domains import prop_states
  for domain, task in (('stacker', 'stack_2'), ('manipulator', 'insert_peg')):
    jm = jsuite.build_task(domain, task).model
    pm = suite.build_task(domain, task, device='cpu').model
    qpos, _ = prop_states(jm, np.random.RandomState(9), 12)

    def collide(q):
      d = jforward.make_data(jm).replace(qpos=q)
      return jcollision.collide(jm, jsmooth.kinematics(jm, d)).contact

    con = jax.jit(jax.vmap(collide))(jnp.asarray(qpos))
    d = forward.make_data(pm, len(qpos), torch.float64, 'cpu')
    d = collision.collide(pm, smooth.kinematics(
        pm, d.replace(qpos=torch.tensor(qpos))))
    ref = {f: np.array(getattr(con, f)) for f in (
        'dist', 'pos', 'frame', 'includemargin', 'friction', 'solref',
        'solimp', 'geom1', 'geom2', 'body1', 'body2', 'dim')}
    out = {f: getattr(d.contact, f).numpy() for f in ref}
    slot = 0
    for g in collision.groups(pm):
      if (g.t1.name, g.t2.name) == ('PLANE', 'BOX'):
        for p in range(g.npairs):
          s = slice(slot + 4 * p, slot + 4 * p + 4)
          for x in (ref, out):
            dist, pos, frame = _as_sets(x['dist'][:, s], x['pos'][:, s],
                                        x['frame'][:, s].reshape(-1, 4, 9))
            x['dist'][:, s], x['pos'][:, s] = dist, pos
            x['frame'][:, s] = frame.reshape(-1, 4, 3, 3)
      slot += g.ncon
    # pos and frame of the box groups' contacts within 0.1 (the arm's
    # parallel finger capsules have no single closest point: their pos is
    # rounding's)
    box = np.concatenate([np.full(g.ncon, 'BOX' in (g.t1.name, g.t2.name))
                          for g in collision.groups(pm)])
    near = (ref['dist'] < 0.1) & box
    # the top-K groups' slots follow each package's order of tied scores
    # (tests/test_torch_broadphase.py holds them by pair)
    static = np.concatenate([np.full(g.ncon, not g.dynamic)
                             for g in collision.groups(pm)])
    print(f'{domain}-{task} collide_all: max err', end='')
    for f in ref:
      assert out[f].shape == ref[f].shape, f
      a, r = (out[f][near], ref[f][near]) if f in ('pos', 'frame') else (
          out[f][:, static], ref[f][:, static])
      err = _scaled(a, r)
      print(f' {f} {err:.1e}', end='')
      assert err <= TOL, f'{domain}-{task} {f}: {err:.2e}'
    print()
    on = out['dist'] < out['includemargin']
    slot = 0
    for g in collision.groups(pm):
      if 'BOX' in (g.t1.name, g.t2.name) and (domain == 'stacker'
                                              or g.t1.name == 'CAPSULE'):
        assert on[:, slot:slot + g.ncon].any(), (g.t1.name, g.t2.name)
      slot += g.ncon


def test_unported_pair_raises_naming_it():
  """A geom pair with no collider in the port (heightfield-box) raises
  NotImplementedError naming the pair when its model is compiled (its
  collision groups are built)."""
  import xml.etree.ElementTree as ET
  root = ET.fromstring(
      '<mujoco><asset><hfield name="h" nrow="3" ncol="3" size="1 1 .1 .1"/>'
      '</asset><worldbody><geom type="hfield" hfield="h"/>'
      '<body pos="0 0 1"><joint type="free"/>'
      '<geom type="box" size=".1 .1 .1"/></body>'
      '</worldbody></mujoco>')
  with pytest.raises(NotImplementedError, match=r'\(HFIELD, BOX\)'):
    engine.model_from_root(root, device='cpu')


@functools.lru_cache(maxsize=None)
def _escape_models():
  from dm_control_tpu import suite as jsuite
  from dm_control_tpu_torch import suite
  return (jsuite.build_task('quadruped', 'escape').model,
          suite.build_task('quadruped', 'escape', device='cpu').model)


def _fields(jm, n, rng):
  """(n, nrow * ncol) heightfields in [0, 1]: random cells smoothed a
  little, so the slopes vary."""
  nrow, ncol = int(jm.hfield_nrow[0]), int(jm.hfield_ncol[0])
  f = rng.uniform(0, 1, (n, nrow, ncol))
  f = (f + np.roll(f, 1, 1) + np.roll(f, 1, 2)) / 3
  return f.reshape(n, -1)


def test_hfield_height_matches_jax():
  """hfield_height on 16 lanes' own fields at points anywhere on the grid,
  on cell edges and corners (the floor of the grid coordinate is exact
  there) and past the field's edge (clamped): h and its slopes agree."""
  jm, m = _escape_models()
  rng = np.random.RandomState(20)
  n, k = 16, 32
  data = _fields(jm, n, rng)
  sx, sy = jm.hfield_size[0, :2]
  res = int(jm.hfield_ncol[0])
  xy = rng.uniform(-sx, sx, (n, k, 2))
  xy[:, :8] = (rng.randint(0, res, (n, 8, 2)) / (res - 1) * 2 - 1) * [sx, sy]
  xy[:, 8:12] = rng.uniform(1.0, 1.5, (n, 4, 2)) * rng.choice(
      [-1.0, 1.0], (n, 4, 2)) * [sx, sy]
  d0 = jforward.make_data(jm)
  ref = jax.jit(jax.vmap(lambda hd, p: jcolliders.hfield_height(
      jm, d0.replace(model_var={'hfield_data': hd}), 0, p)))(
          jnp.asarray(data), jnp.asarray(xy))
  d = forward.make_data(m, n, torch.float64, 'cpu').replace(
      model_var={'hfield_data': torch.tensor(data)})
  out = colliders.hfield_height(m, d, 0, torch.tensor(xy))
  errs = [_scaled(o.numpy(), np.asarray(r)) for o, r in zip(out, ref)]
  print(f'hfield_height: max err h {errs[0]:.1e} dh/dx {errs[1]:.1e} '
        f'dh/dy {errs[2]:.1e}')
  assert max(errs) <= TOL


@pytest.mark.parametrize('partner', ['SPHERE', 'CAPSULE', 'ELLIPSOID',
                                     'CYLINDER'])
def test_hfield_collider_matches_jax(partner):
  """escape's heightfield against each partner type's group, 16 lanes each
  with a field of its own (model_var) and random partner poses whose
  lowest point is within 5 cm of the surface under it: dist, pos and the
  normal of every contact point agree, and some points touch."""
  jm, m = _escape_models()
  grp = next(g for g in collision.groups(m)
             if (g.t1.name, g.t2.name) == ('HFIELD', partner))
  jgrp = next(g for g in jcollision.groups(jm)
              if (g.t1.name, g.t2.name) == ('HFIELD', partner))
  rng = np.random.RandomState(21 + len(partner))
  n, K = 16, grp.K
  data = _fields(jm, n, rng)
  g1 = int(grp.g1[0])
  h_pos = np.tile(jm.geom_pos[g1], (n, K, 1))
  h_mat = np.tile(np.eye(3), (n, K, 1, 1))
  size2 = np.tile(jm.geom_size[grp.g2], (n, 1, 1))
  mat2 = _rot(rng, n * K).reshape(n, K, 3, 3)
  pos2 = np.concatenate([rng.uniform(-20, 20, (n, K, 2)),
                         np.zeros((n, K, 1))], -1)
  # the surface under each partner, from the field's own bilinear form
  d = forward.make_data(m, n, torch.float64, 'cpu').replace(
      model_var={'hfield_data': torch.tensor(data)})
  h = colliders.hfield_height(m, d, 0, torch.tensor(pos2[..., :2]))[0]
  reach = np.linalg.norm(size2, axis=-1)
  pos2[..., 2] = (h.numpy() + h_pos[..., 2] + reach * rng.uniform(0.3, 1.0)
                  + rng.uniform(-0.05, 0.05, (n, K)))
  d0 = jforward.make_data(jm)

  def one(hd, hp, hm, p, mt, sz2):
    jd = d0.replace(model_var={'hfield_data': hd},
                    geom_xpos=d0.geom_xpos.at[g1].set(hp[0]),
                    geom_xmat=d0.geom_xmat.at[g1].set(hm[0]))
    return jcolliders._collide_hfield(jm, jd, jgrp, jnp.asarray(jgrp.g1),
                                      p, mt, sz2)

  ref = jax.jit(jax.vmap(one))(*[jnp.asarray(a) for a in (
      data, h_pos, h_mat, pos2, mat2, size2)])
  out = colliders._collide_hfield(m, d, grp, *[torch.tensor(a) for a in (
      h_pos, h_mat, pos2, mat2, size2)])
  print(f'hfield-{partner.lower()}: {int((out[0] < 0).sum())} of '
        f'{out[0].numel()} points touching; max err', end='')
  for name, a, r in zip(('dist', 'pos', 'normal'), out, ref):
    r = np.asarray(r)
    assert a.shape == r.shape, (name, a.shape, r.shape)
    err = _scaled(a.numpy(), r)
    print(f' {name} {err:.1e}', end='')
    assert err <= TOL, f'hfield-{partner} {name}: {err:.2e}'
  print()
  assert (out[0] < 0).any() and (out[0] > 0).any()
