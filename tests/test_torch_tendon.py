"""The port's tendons against the JAX package's, float64 on the CPU.

Seeded numpy states go through both packages' stages: `smooth.tendon` on
point_mass's two fixed tendons (the model's joint coefficients and a
per-lane `wrap_prm` in model_var, as point_mass-hard draws them) and on
ball_in_cup's spatial string (a two-site chain); `smooth.transmission`
through tendons (point_mass's motors, fish's fins_flap position
actuator beside its joint actuators); the tendon limit row (ball_in_cup's
string, slack and taut) and tendon friction-loss rows (point_mass with a
friction loss set on both tendons) and the tendon equality rows
(quadruped's four couplings, one of them edited into a polynomial in a
second tendon's length) in `constraint.make_constraint`; the
tendon spring, with an unset spring length (fish's fins_sym, its length
at qpos0) and with a deadband, and the tendon damper in
`forward.passive`; and `setconst`'s tendon_length0 and
tendon_invweight0.  Everything agrees to TOL = 1e-10 scaled by max(1,
|ref|): both evaluate the same sums in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dm_control_tpu._src import constraint as jconstraint
from dm_control_tpu._src import engine as jengine
from dm_control_tpu._src import forward as jforward
from dm_control_tpu._src import smooth as jsmooth
from dm_control_tpu.suite import common as jcommon
from dm_control_tpu_torch._src import constraint
from dm_control_tpu_torch._src import efc
from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch._src import forward
from dm_control_tpu_torch._src import smooth
from dm_control_tpu_torch.suite import common

B = 16
TOL = 1e-10


def _scaled(x, ref):
  x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
  assert x.shape == ref.shape, (x.shape, ref.shape)
  return float((np.abs(x - ref) / np.maximum(1.0, np.abs(ref))).max(
      initial=0.0))


def _models(name, edit=None):
  """Fresh JAX and port models of an asset (edited alike by `edit`)."""
  jm = jengine.load_model(jcommon.model_path(name))
  m = engine.load_model(common.model_path(name), device='cpu')
  if edit is not None:
    edit(jm)
    edit(m)
  return jm, m


def _states(name, m, rng):
  """(qpos, qvel) of B lanes: joints uniform in range (slides of
  point_mass across their limits); ball_in_cup's lanes alternate a slack
  and a taut string (the ball 0.2-0.35 from the cup's site); fish's root
  at random orientations."""
  qpos = np.tile(m.qpos0, (B, 1))
  qvel = rng.randn(B, m.nv)
  if name == 'ball_in_cup.xml':
    qpos[:, :2] = rng.uniform(-0.05, 0.05, (B, 2))
    reach = np.where(np.arange(B) % 2, rng.uniform(0.31, 0.35, B),
                     rng.uniform(0.2, 0.29, B))
    ang = rng.uniform(-0.6, 0.6, B)
    # the cup's site sits 0.292 above the ball's body origin at qpos0
    qpos[:, 2] = qpos[:, 0] + reach * np.sin(ang)
    qpos[:, 3] = qpos[:, 1] + 0.292 - reach * np.cos(ang)
  elif name == 'fish.xml':
    quat = rng.randn(B, 4)
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qpos[:, :3] = rng.uniform(-0.3, 0.3, (B, 3))
    qpos[:, 7:] = rng.uniform(-0.4, 0.4, (B, m.nq - 7))
  else:
    lo, hi = m.jnt_range.T
    qpos[:] = rng.uniform(1.2 * lo, 1.2 * hi, (B, m.nq))
  return qpos, qvel


def _run(jm, m, qpos, qvel, jfn, fn, model_var=None):
  """jfn on the JAX package's vmapped Data, fn on the port's, from the
  same states; the port's Data goes through kinematics and com_pos first,
  the JAX package's too."""
  model_var = model_var or {}
  d0 = jforward.make_data(jm)

  def one(q, v, mv):
    d = d0.replace(qpos=q, qvel=v, model_var=mv)
    return jfn(jsmooth.com_pos(jm, jsmooth.kinematics(jm, d)))

  ref = jax.jit(jax.vmap(one))(jnp.asarray(qpos), jnp.asarray(qvel),
                               {k: jnp.asarray(x)
                                for k, x in model_var.items()})
  d = forward.make_data(m, B, torch.float64, 'cpu').replace(
      qpos=torch.tensor(qpos), qvel=torch.tensor(qvel),
      model_var={k: torch.tensor(x) for k, x in model_var.items()})
  return ref, fn(smooth.com_pos(m, smooth.kinematics(m, d)))


def _wrap_prm(rng):
  d = rng.randn(B, 2, 2)
  return (d / np.linalg.norm(d, axis=-1, keepdims=True)).reshape(B, 4)


@pytest.mark.parametrize('case', ['point_mass', 'point_mass-wrap_prm',
                                  'ball_in_cup'])
def test_tendon_matches_jax(case):
  """ten_length, ten_J and ten_velocity of fixed (point_mass, with and
  without a per-lane wrap_prm) and spatial (ball_in_cup) tendons."""
  name = case.split('-')[0] + '.xml'
  jm, m = _models(name)
  rng = np.random.RandomState(1)
  qpos, qvel = _states(name, m, rng)
  mv = {'wrap_prm': _wrap_prm(rng)} if case.endswith('wrap_prm') else {}
  ref, d = _run(jm, m, qpos, qvel, lambda d: jsmooth.tendon(jm, d),
                lambda d: smooth.tendon(m, d), mv)
  errs = {f: _scaled(getattr(d, f).numpy(), getattr(ref, f))
          for f in ('ten_length', 'ten_J', 'ten_velocity')}
  print(f'{case}: max scaled err {errs}')
  assert all(e <= TOL for e in errs.values()), errs
  if mv:
    # the coefficients are the lane's own
    np.testing.assert_allclose(d.ten_J.numpy()[:, 0, :],
                               mv['wrap_prm'][:, :2], rtol=0, atol=1e-15)


@pytest.mark.parametrize('name', ['point_mass.xml', 'fish.xml'])
def test_transmission_matches_jax(name):
  """actuator_length and actuator_moment through tendon (and, for fish,
  joint) transmissions."""
  jm, m = _models(name)
  qpos, qvel = _states(name, m, np.random.RandomState(2))

  def jfn(d):
    return jsmooth.transmission(jm, jsmooth.tendon(jm, d))

  ref, d = _run(jm, m, qpos, qvel, jfn,
                lambda d: smooth.transmission(m, smooth.tendon(m, d)))
  errs = {f: _scaled(getattr(d, f).numpy(), getattr(ref, f))
          for f in ('actuator_length', 'actuator_moment')}
  print(f'{name}: max scaled err {errs}')
  assert all(e <= TOL for e in errs.values()), errs
  assert np.abs(d.actuator_moment.numpy()).max() > 0


def _set_tendon_friction(m):
  """A friction loss on both tendons, with the default solref / solimp
  (the compiler reads neither for tendons)."""
  m.tendon_frictionloss = np.array([0.1, 0.2])
  m.tendon_solref_fri = np.tile([0.02, 1.0], (2, 1))
  m.tendon_solimp_fri = np.tile([0.9, 0.95, 0.001, 0.5, 2.0], (2, 1))


@pytest.mark.parametrize('case', ['ball_in_cup-limit',
                                  'point_mass-friction'])
def test_tendon_rows_match_jax(case):
  """Every efc row of ball_in_cup (its string's limit row first, then the
  contacts) and of point_mass with a tendon friction loss (its two
  friction-loss rows, then the joint limits): J, pos, margin, D, aref,
  frictionloss and activity.  ball_in_cup's limit row is active on the
  taut lanes only, with J's sign from the nearer side."""
  name = case.split('-')[0] + '.xml'
  jm, m = _models(name, _set_tendon_friction if 'friction' in case else None)
  lay = efc.layout(m)
  if 'friction' in case:
    assert list(lay.fric_ten) == [0, 1]
  else:
    assert list(lay.lim_ten) == [0] and lay.n_noncontact == 1
  qpos, qvel = _states(name, m, np.random.RandomState(3))

  def jfn(d):
    from dm_control_tpu._src import collision as jcollision
    d = jsmooth.transmission(jm, jcollision.collide(
        jm, jsmooth.tendon(jm, jsmooth.factor_m(jm, jsmooth.crb(jm, d)))))
    return jconstraint.make_constraint(jm, d)

  def fn(d):
    from dm_control_tpu_torch._src import collision
    d = smooth.transmission(m, collision.collide(
        m, smooth.tendon(m, smooth.factor_m(m, smooth.crb(m, d)))))
    return constraint.make_constraint(m, d)

  ref, d = _run(jm, m, qpos, qvel, jfn, fn)
  errs = {f: _scaled(getattr(d, f).numpy(), getattr(ref, f))
          for f in ('efc_J', 'efc_pos', 'efc_margin', 'efc_D', 'efc_aref',
                    'efc_frictionloss')}
  print(f'{case}: max scaled err {errs}')
  assert all(e <= TOL for e in errs.values()), errs
  np.testing.assert_array_equal(d.efc_active.numpy(),
                                np.asarray(ref.efc_active))
  if 'limit' in case:
    taut = np.arange(B) % 2 == 1
    np.testing.assert_array_equal(d.efc_active[:, 0].numpy(), taut)
    assert (d.efc_J[taut, 0] != 0).any()
  else:
    assert bool(d.efc_active[:, :2].all())
    np.testing.assert_array_equal(d.efc_frictionloss[0, :2].numpy(),
                                  [0.1, 0.2])


def _deadband(m):
  m.tendon_lengthspring = m.tendon_lengthspring.copy()
  m.tendon_lengthspring[1] = [0.01, 0.05]
  m.tendon_damping = np.array([3e-5, 1e-5])


@pytest.mark.parametrize('case', ['unset', 'deadband'])
def test_tendon_spring_damper_match_jax(case):
  """fish's passive forces (its fluid forces included): fins_sym's spring
  about its length at qpos0 (its spring length is unset), or in a
  deadband [0.01, 0.05] with dampers on both tendons; fins' roll angles
  put the tendon below, inside and above the deadband."""
  jm, m = _models('fish.xml', _deadband if case == 'deadband' else None)
  assert m.tendon_lengthspring[1, 0] == (0.01 if case == 'deadband' else -1)
  qpos, qvel = _states('fish.xml', m, np.random.RandomState(4))

  def jfn(d):
    d = jsmooth.tendon(jm, jsmooth.crb(jm, d))
    return jforward.passive(jm, jsmooth.rne(jm, jsmooth.com_vel(jm, d)))

  def fn(d):
    d = smooth.tendon(m, smooth.crb(m, d))
    return forward.passive(m, smooth.rne(m, smooth.com_vel(m, d)))

  ref, d = _run(jm, m, qpos, qvel, jfn, fn)
  errs = {f: _scaled(getattr(d, f).numpy(), getattr(ref, f))
          for f in ('qfrc_spring', 'qfrc_damper', 'qfrc_fluid',
                    'qfrc_passive')}
  print(f'fish tendon spring ({case}): max scaled err {errs}')
  assert all(e <= TOL for e in errs.values()), errs
  length = d.ten_length[:, 1].numpy()
  if case == 'deadband':
    assert (length < 0.01).any() and (length > 0.05).any()
    assert ((length > 0.01) & (length < 0.05)).any()
    assert np.abs(d.qfrc_damper.numpy()).max() > 0
  assert np.abs(d.qfrc_spring.numpy()).max() > 0


@pytest.mark.parametrize('name', ['point_mass.xml', 'ball_in_cup.xml',
                                  'fish.xml'])
def test_tendon_setconst_matches_jax(name):
  """tendon_length0 and tendon_invweight0 = ten_J M^-1 ten_J' at qpos0."""
  jm, m = _models(name)
  for f in ('tendon_length0', 'tendon_invweight0'):
    err = _scaled(getattr(m, f), getattr(jm, f))
    print(f'{name} {f}: {getattr(m, f)} (max scaled err {err:.1e})')
    assert err <= TOL, (f, getattr(m, f), getattr(jm, f))
  assert (m.tendon_invweight0 > 0).all()


@pytest.mark.parametrize('case', ['coupling', 'polynomial'])
def test_tendon_equality_rows_match_jax(case):
  """quadruped's four tendon equalities (each a tendon held at its qpos0
  length) come first in the layout: their J, pos, D and aref, and those
  of every row before the contacts, agree with the JAX package's (the
  contacts' rows follow the top-K selection's order, which ties of
  structural distances leave to each package's rounding;
  tests/test_torch_broadphase.py holds them).  'polynomial' makes the first
  one a quartic in a second tendon's length (tendon2, eq_data[:5]).  A
  CONNECT equality raises, naming itself."""
  from dm_control_tpu.suite import quadruped as jquadruped
  from dm_control_tpu_torch._src.types import EqType
  from dm_control_tpu_torch.suite import quadruped
  jm = jquadruped._model.__wrapped__(floor_size=10.0)
  m = engine.model_from_root(quadruped.arena(10.0), 'cpu',
                             **quadruped.BROADPHASE)
  assert m.neq == 4 and (m.eq_type == int(EqType.TENDON)).all()
  assert (m.eq_obj2id == -1).all()
  if case == 'polynomial':
    for mm in (jm, m):
      mm.eq_obj2id[0] = 4
      mm.eq_data[0, :5] = [0.01, 0.5, -0.3, 0.2, 0.1]
  lay = efc.layout(m)
  assert list(lay.types[:4]) == [efc.EQUALITY] * 4
  rng = np.random.RandomState(6)
  qpos = np.tile(m.qpos0, (B, 1))
  for j in range(1, m.njnt):
    qpos[:, m.jnt_qposadr[j]] = rng.uniform(*m.jnt_range[j], B)
  qpos[:, 2] = rng.uniform(0.2, 0.5, B)
  qvel = rng.randn(B, m.nv)
  ref, d = _run(jm, m, qpos, qvel,
                lambda d: jforward.step1(jm, d, skipsensor=True),
                lambda d: forward.step1(m, d, skipsensor=True))
  n = lay.n_noncontact
  errs = {f: (_scaled(getattr(d, f)[:, :4].numpy(),
                      np.asarray(getattr(ref, f))[:, :4]),
              _scaled(getattr(d, f)[:, :n].numpy(),
                      np.asarray(getattr(ref, f))[:, :n]))
          for f in ('efc_J', 'efc_pos', 'efc_D', 'efc_aref')}
  print(f'quadruped tendon equality ({case}): max scaled err (equality '
        f'rows, the {n} rows before the contacts) {errs}')
  assert all(e <= TOL for pair in errs.values() for e in pair), errs
  assert bool(d.efc_active[:, :4].all())
  assert float(d.efc_pos[:, :4].abs().min()) > 0
  if case == 'polynomial':
    m.eq_type[1] = int(EqType.CONNECT)
    with pytest.raises(NotImplementedError, match='CONNECT'):
      constraint.make_constraint(m, d)
