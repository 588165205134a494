"""The port's top-K broadphase against the JAX package's, float64 on the
CPU.

humanoid and quadruped-walk take their self-collision sets (sphere-capsule,
capsule-capsule) and their plane-capsule floor sets through the top-K
broadphase: each step every lane narrowphases only the K candidates of
smallest score, the broadphase distance less (margin - gap).  Here the
groups (pairs, K, which are dynamic, contact capacity) equal the JAX
package's; `_broadphase_distance` of every group agrees on seeded states;
and `collide_all` agrees slot for slot, the selected pairs' geoms and
bodies per lane included, on 8 states of each model whose roots are
lowered and limbs drawn anywhere in range, so that every dynamic group's
(K+1)-th candidate on every lane lies within REACH, a body length: the
selection cuts through candidates that matter.  The selection's order is
`lax.top_k`'s: ascending score, the lower index first among equal
scores, on constructed ties too; and a lane selects what it selects
whatever the other lanes of its batch.

Many candidates of these models tie by construction: two capsules joined
at a hinge keep one distance in every pose, and mirror-image limbs give
equal distances in symmetric poses.  Such scores are equal in each
package but not between them: each package's kinematics rounds them
its own way at float64, so the two can order tied candidates
differently.  The slot-for-slot comparison therefore first orders each
run of scores equal within TIE (relative) by pair index, on both sides;
every other slot keeps the selection's order, and a tie across the K
boundary (which would let the two select different pairs) fails.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dm_control_tpu import suite as jsuite
from dm_control_tpu._src import colliders as jcolliders
from dm_control_tpu._src import collision as jcollision
from dm_control_tpu._src import forward as jforward
from dm_control_tpu._src import smooth as jsmooth
from dm_control_tpu_torch import suite
from dm_control_tpu_torch._src import colliders
from dm_control_tpu_torch._src import collision
from dm_control_tpu_torch._src import forward
from dm_control_tpu_torch._src import smooth

B = 8
TOL = 1e-9
# a body length (m)
REACH = 1.0
# scores within TIE of each other (relative, at least 1) tie up to rounding
TIE = 1e-12
TASKS = (('humanoid', 'run'), ('quadruped', 'walk'))
CONTACT_FIELDS = ('dist', 'pos', 'frame', 'includemargin', 'friction',
                  'solref', 'solimp', 'geom1', 'geom2', 'body1', 'body2',
                  'dim')


def _scaled(a, ref):
  a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
  return float((np.abs(a - ref) / np.maximum(1.0, np.abs(ref))).max(
      initial=0.0))


def _states(m, rng, n=B):
  """n poses: every hinge anywhere in its range, the free root at a random
  orientation, its center 0 to 0.25 above the floor."""
  qpos = np.tile(m.qpos0, (n, 1))
  for j in range(1, m.njnt):
    qpos[:, m.jnt_qposadr[j]] = rng.uniform(*m.jnt_range[j], n)
  quat = rng.randn(n, 4)
  qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
  qpos[:, :2] = rng.uniform(-0.5, 0.5, (n, 2))
  qpos[:, 2] = rng.uniform(0.0, 0.25, n)
  return qpos


@pytest.fixture(scope='module', params=TASKS, ids=lambda t: t[0])
def model_states(request):
  """(JAX model, port model, qpos (B, nq), the port's kinematics Data, the
  JAX package's vmapped kinematics Data, the domain)."""
  jm = jsuite.build_task(*request.param).model
  m = suite.build_task(*request.param, device='cpu').model
  qpos = _states(jm, np.random.RandomState(11))
  d = smooth.kinematics(m, forward.make_data(m, B, torch.float64, 'cpu')
                        .replace(qpos=torch.tensor(qpos)))
  jd = jax.jit(jax.vmap(lambda q: jsmooth.kinematics(
      jm, jforward.make_data(jm).replace(qpos=q))))(jnp.asarray(qpos))
  return jm, m, qpos, d, jd, request.param[0]


def test_groups_match_jax(model_states):
  jm, m, _, _, _, _ = model_states
  ours, theirs = collision.groups(m), jcollision.groups(jm)
  assert len(ours) == len(theirs)
  for g, jg in zip(ours, theirs):
    assert (g.t1, g.t2, g.condim, g.npairs, g.K, g.dynamic, g.ncon) == (
        jg.t1, jg.t2, jg.condim, jg.npairs, jg.K, jg.dynamic, jg.ncon)
    np.testing.assert_array_equal(g.g1, jg.g1)
    np.testing.assert_array_equal(g.g2, jg.g2)
    for f in ('friction', 'solref', 'solimp', 'margin', 'gap'):
      np.testing.assert_array_equal(getattr(g, f), getattr(jg, f))
  assert collision.count_max_contacts(m) == jcollision.count_max_contacts(jm)
  assert sum(g.dynamic for g in ours) == 3


def test_broadphase_distance_matches_jax(model_states):
  """Every group's score, dynamic or not; and each dynamic group's
  (K+1)-th smallest score is within REACH on every lane."""
  jm, m, _, d, jd, domain = model_states
  for g, jg in zip(collision.groups(m), jcollision.groups(jm)):
    ref = jax.vmap(lambda dd: jcolliders._broadphase_distance(
        jm, dd, jg, jnp.float64))(jd)
    out = colliders._broadphase_distance(m, d, g)
    assert out.shape == (B, g.npairs)
    err = _scaled(out.numpy(), ref)
    print(f'{g.t1.name}-{g.t2.name}: K {g.K} of {g.npairs}, max err '
          f'{err:.1e}')
    assert err <= TOL
    if g.dynamic:
      assert bool((out.sort(dim=1).values[:, g.K] < REACH).all())


def _tie_order(idx, score):
  """(B, K) permutation of a selection (pair indices `idx` in selection
  order, ascending `score`) that orders each run of scores equal within
  TIE by pair index; asserts no run crosses the K boundary (`score` has
  K + 1 columns, the last the first unselected candidate's)."""
  idx, score = np.asarray(idx), np.asarray(score)
  K = idx.shape[1]
  gap = np.diff(score, axis=1) > TIE * np.maximum(1.0, np.abs(score[:, 1:]))
  assert gap[:, K - 1].all(), 'a tie across the K boundary'
  run = np.concatenate([np.zeros((len(idx), 1), int),
                        np.cumsum(gap[:, :K - 1], axis=1)], axis=1)
  return np.argsort(run * (idx.max() + 1) + idx, axis=1, kind='stable')


def _canonical(fields, groups, order):
  """Contact fields (numpy, (B, ncon, ...)) with each dynamic group's
  slots permuted by `order[group index]` (per pair, its k contacts
  together)."""
  out = {f: x.copy() for f, x in fields.items()}
  start = 0
  for gi, g in enumerate(groups):
    if g.dynamic:
      k = g.ncon_per_pair
      slots = (order[gi][:, :, None] * k + np.arange(k)).reshape(
          len(order[gi]), -1) + start
      for f, x in out.items():
        x[:, start:start + g.ncon] = np.take_along_axis(
            fields[f], slots.reshape(slots.shape + (1,) * (x.ndim - 2)),
            axis=1)
    start += g.ncon
  return out


def test_collide_all_matches_jax(model_states):
  """collide_all slot for slot (runs of tied scores ordered by pair
  index): every contact field, the selected pairs' geoms and bodies per
  lane bit for bit; the lanes select different pairs; contacts are active
  in the floor groups, and in humanoid's self-collision groups too (the
  quadruped's limbs drawn at random do not touch each other)."""
  jm, m, _, d, jd, domain = model_states
  con = jax.vmap(lambda dd: jcollision.collide(jm, dd).contact)(jd)
  out = collision.collide(m, d).contact
  groups = collision.groups(m)
  orders = {}
  for gi, (g, jg) in enumerate(zip(groups, jcollision.groups(jm))):
    if g.dynamic:
      jscore = jax.vmap(lambda dd: jcolliders._broadphase_distance(
          jm, dd, jg, jnp.float64))(jd) - jnp.asarray(jg.margin - jg.gap)
      jval, jidx = jax.lax.top_k(-jscore, g.K + 1)
      idx, score = colliders.broadphase_select(m, d, g)
      full = torch.sort(score, dim=1, stable=True).values[:, :g.K + 1]
      orders[gi] = (_tie_order(idx, full),
                    _tie_order(np.asarray(jidx)[:, :g.K], -np.asarray(jval)))
  ours = _canonical({f: getattr(out, f).numpy() for f in CONTACT_FIELDS},
                    groups, {gi: o[0] for gi, o in orders.items()})
  theirs = _canonical({f: np.asarray(getattr(con, f))
                       for f in CONTACT_FIELDS},
                      groups, {gi: o[1] for gi, o in orders.items()})
  errs = {}
  for f in CONTACT_FIELDS:
    ref, x = theirs[f], ours[f]
    assert x.shape == ref.shape, f
    if f in ('geom1', 'geom2', 'body1', 'body2', 'dim'):
      np.testing.assert_array_equal(x, ref, err_msg=f)
    errs[f] = _scaled(x, ref)
  print(f'{jm.nbody} bodies: collide_all max err ' + ', '.join(
      f'{f} {e:.1e}' for f, e in errs.items()))
  assert max(errs.values()) <= TOL
  on = (out.dist < out.includemargin).numpy()
  start = 0
  for g in collision.groups(m):
    if g.dynamic:
      active = int(on[:, start:start + g.ncon].sum())
      print(f'{g.t1.name}-{g.t2.name}: active contacts {active}')
      assert active or (domain == 'quadruped' and g.t1 != 0)
      # the lanes' selections differ
      step = slice(start, start + g.ncon, g.ncon_per_pair)
      sel = out.geom1[:, step] * m.ngeom + out.geom2[:, step]
      assert len({tuple(s) for s in sel.tolist()}) > 1
    start += g.ncon


def test_selection_order_is_lax_top_k():
  """Scores with ties (and ties across the K boundary): the port's
  selection is `lax.top_k`'s of the negated score, order included."""
  rng = np.random.RandomState(3)
  score = rng.choice([-0.3, -0.1, 0.0, 0.2, 0.5], (64, 40)).astype(
      np.float64)
  for K in (1, 8, 12, 39):
    _, ref = jax.lax.top_k(-jnp.asarray(score), K)
    idx = torch.sort(torch.tensor(score), dim=-1, stable=True).indices[:, :K]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref))


def test_constructed_tie_selects_the_lower_index_first(model_states):
  """Two plane-capsule candidates made to tie exactly (both capsules moved
  to one pose under the floor): both are selected, the lower index first,
  in the port and the JAX package alike."""
  jm, m, _, d, jd, domain = model_states
  gi, g = next((i, g) for i, g in enumerate(collision.groups(m))
               if g.dynamic and g.t1 == 0)
  jg = jcollision.groups(jm)[gi]
  # two candidates whose capsules are of one size (mirror-image limbs)
  i, j = next((i, j) for i in range(g.npairs) for j in range(i + 1, g.npairs)
              if (m.geom_size[g.g2[i]] == m.geom_size[g.g2[j]]).all())
  xpos, xmat = d.geom_xpos.clone(), d.geom_xmat.clone()
  xpos[:, g.g2[i]] = xpos[:, g.g2[j]] = torch.tensor([0.0, 0.0, -5.0],
                                                     dtype=torch.float64)
  xmat[:, g.g2[i]] = xmat[:, g.g2[j]]
  d = d.replace(geom_xpos=xpos, geom_xmat=xmat)
  jd = jd.replace(geom_xpos=jnp.asarray(xpos.numpy()),
                  geom_xmat=jnp.asarray(xmat.numpy()))
  idx, score = colliders.broadphase_select(m, d, g)
  assert bool((score[:, i] == score[:, j]).all())
  jscore = jax.vmap(lambda dd: jcolliders._broadphase_distance(
      jm, dd, jg, jnp.float64))(jd) - jnp.asarray(jg.margin - jg.gap)
  _, ref = jax.lax.top_k(-jscore, g.K)
  np.testing.assert_array_equal(idx.numpy(), np.asarray(ref))
  for lane in idx.tolist():
    assert lane[:2] == [i, j]


def test_lanes_select_alone_what_they_select_in_the_batch(model_states):
  """Lanes 0-4 alone: the same selection and contacts, bit for bit, as
  within the batch of 8."""
  _, m, _, d, _, _ = model_states
  full = collision.collide(m, d).contact
  part = collision.collide(m, d.replace(**{
      f: getattr(d, f)[:5] for f in ('qpos', 'geom_xpos', 'geom_xmat')
  })).contact
  for f in CONTACT_FIELDS:
    assert torch.equal(getattr(part, f), getattr(full, f)[:5]), f


def test_contact_slots_are_static_only_outside_top_k(model_states):
  """`collision.contact_slots`: a static group's pair has the JAX
  package's slots; a pair of a dynamic group raises (its slots change
  from lane to lane); a pair that never collides has none."""
  jm, m, _, _, _, _ = model_states
  for g in collision.groups(m):
    ga, gb = int(g.g1[0]), int(g.g2[0])
    if g.dynamic:
      with pytest.raises(ValueError, match='top-K'):
        collision.contact_slots(m, ga, gb)
      with pytest.raises(ValueError):
        jcollision.contact_slots(jm, ga, gb)
    else:
      slots = collision.contact_slots(m, ga, gb)
      assert len(slots) == g.ncon_per_pair
      np.testing.assert_array_equal(slots,
                                    jcollision.contact_slots(jm, ga, gb))
  assert collision.contact_slots(m, 0, 0).size == 0
