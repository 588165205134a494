"""The port's new narrowphase colliders against the JAX package's.

Each collider of the finger path (plane-cylinder, capsule-capsule,
sphere-cylinder, capsule-cylinder, cylinder-cylinder), of ball_in_cup's
(plane-sphere, sphere-capsule), of humanoid's (sphere-sphere) and of
quadruped's (plane-ellipsoid, sphere-ellipsoid, capsule-ellipsoid) runs
on the same seeded numpy poses (64 per case, float64) in both packages:
generic overlapping poses, grazing ones (the surfaces about touching),
nearly parallel axes, for the cylinders poses that put the contact on a
rim, on a cap or deep inside, a sphere beyond a capsule's end, and a
sphere's center inside an ellipsoid.  dist, pos and the normal agree to
1e-9 (the two evaluate the same closed forms; they differ only in
rounding).  Then finger's and ball_in_cup's `collide_all` are held to the
JAX package's at seeded states.
"""

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
