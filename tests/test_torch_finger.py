"""The port's finger-spin against the JAX package's, float64 on the CPU.

States in contact are drawn with numpy: joint angles uniform in range
(the task's own randomizer, 9% of whose draws touch), kept where the JAX
package's `has_contacts` is true, with random joint velocities (so that
contacts slide) and the spinner's hinge velocity around the task's
-15 rad/s reward threshold.  Both packages then run the same forward pass
and the same BatchedEnv steps.  Constraint rows, the 12 sensors, qpos,
qvel, reward and observations agree to 1e-6 scaled by max(1, |ref|): the
solve stops at opt.tolerance, and its ~1e-9 differences pass into
everything after it.  The collision-free init and the reset pool are held
to the JAX package's on the same candidates.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dm_control_tpu import suite as jsuite
from dm_control_tpu._src import forward as jforward
from dm_control_tpu.parallel import runner as jrunner
from dm_control_tpu.suite import base as jbase
from dm_control_tpu_torch import bridge
from dm_control_tpu_torch import suite
from dm_control_tpu_torch._src import efc
from dm_control_tpu_torch._src import forward
from dm_control_tpu_torch.parallel import runner
from dm_control_tpu_torch.suite import base

BATCH = 8
STEPS = 5
TOL = 1e-6


def _fields(d):
  """Flat numpy dict of a (batched) JAX Data, keyed as the bridge keys it."""
  out = {f.name: np.asarray(getattr(d, f.name))
         for f in dataclasses.fields(d)
         if f.name not in ('contact', 'model_var')}
  out.update({'contact.' + f.name: np.asarray(getattr(d.contact, f.name))
              for f in dataclasses.fields(d.contact)})
  return out


def _scaled(x, ref):
  x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
  return float((np.abs(x - ref) / np.maximum(1.0, np.abs(ref))).max(
      initial=0.0))


def _draw_qpos(m, n, rng):
  """n joint configurations drawn as the task's randomizer draws them."""
  qpos = np.tile(m.qpos0, (n, 1))
  for j in range(m.njnt):
    a = m.jnt_qposadr[j]
    lo, hi = m.jnt_range[j] if m.jnt_limited[j] else (-np.pi, np.pi)
    qpos[:, a] = rng.uniform(lo, hi, n)
  return qpos


@pytest.fixture(scope='module')
def models():
  jtask = jsuite.build_task('finger', 'spin')
  task = suite.build_task('finger', 'spin', device='cpu')
  return jtask, task


@pytest.fixture(scope='module')
def contact_states(models):
  """16 in-contact (qpos, qvel, ctrl) and the JAX contact predicate on
  the 512 draws they came from."""
  jtask, _ = models
  jm = jtask.model
  rng = np.random.RandomState(0)
  qpos = _draw_qpos(jm, 512, rng)
  bad = np.asarray(jax.jit(jax.vmap(
      lambda q: jbase.has_contacts(jm, jforward.make_data(jm).replace(
          qpos=q))))(jnp.asarray(qpos)))
  q = qpos[bad][:16]
  v = rng.randn(16, jm.nv) * 2
  v[:, jm.jnt_dofadr[jm.name2id('joint', 'hinge')]] = rng.uniform(
      -20, -10, 16)
  u = rng.uniform(-1, 1, (16, jm.nu))
  return qpos, bad, q, v, u


@pytest.fixture(scope='module')
def forwards(models, contact_states):
  """The JAX and port forward passes from the in-contact states."""
  jtask, task = models
  jm, pm = jtask.model, task.model
  _, _, q, v, u = contact_states
  ref = jax.jit(jax.vmap(lambda q, v, u: jforward.forward(
      jm, jforward.make_data(jm).replace(qpos=q, qvel=v, ctrl=u))))(
          jnp.asarray(q), jnp.asarray(v), jnp.asarray(u))
  d = forward.make_data(pm, len(q), torch.float64, 'cpu').replace(
      qpos=torch.tensor(q), qvel=torch.tensor(v), ctrl=torch.tensor(u))
  return _fields(ref), bridge.data_to_numpy(forward.forward(pm, d))


def test_layout_is_finger_spin(models):
  _, task = models
  m = task.model
  lay = efc.layout(m)
  assert (m.nv, lay.nefc) == (3, 105)
  assert np.bincount(lay.types).tolist() == [0, 1, 2, 102]
  assert {k: v[0].shape for k, v in lay.ell_groups.items()} == {3: (34, 3)}
  assert task.n_sub_steps() == 2 and task.expensive_init


def test_constraint_rows_match_jax(models, forwards):
  """Friction-loss, limit and elliptic rows.  J and aref are compared on
  the rows of contacts that can touch (dist < 0.1): the two decoration
  cylinders, 0.4 apart, have tied candidates whose mirror-image frames
  rounding picks either way (tests/test_torch_colliders.py)."""
  _, task = models
  lay = efc.layout(task.model)
  c = lay.contact
  ref, port = forwards
  near_con = ref['contact.dist'] < 0.1                   # (B, ncon)
  row_con = np.full(lay.nefc, -1)
  for ci, (r0, k) in enumerate(zip(c.row_start, c.condim)):
    row_con[r0:r0 + k] = ci
  near = np.ones_like(ref['efc_D'], bool)
  near[:, row_con >= 0] = near_con[:, row_con[row_con >= 0]]
  active = ref['efc_active']
  ell_active = active[:, lay.n_noncontact:].reshape(len(active), -1, 3)
  assert ell_active.any(2).any(1).all()                 # every lane
  assert active[:, 0].all()              # the hinge's friction-loss row
  for f in ('efc_J', 'efc_D', 'efc_aref', 'efc_frictionloss', 'efc_active'):
    a, b = port[f], ref[f]
    assert a.shape == b.shape, f
    if f in ('efc_J', 'efc_aref'):
      a, b = a[near], b[near]
    if b.dtype == bool:
      np.testing.assert_array_equal(a, b, err_msg=f)
      continue
    err = _scaled(a, b)
    print(f'{f}: max scaled err {err:.2e}')
    assert err <= TOL, f'{f}: {err:.2e}'


def test_sensors_match_jax(models, forwards):
  """All 12 sensors after a forward pass in contact, touch included."""
  jtask, _ = models
  m = jtask.model
  ref, port = forwards
  assert m.nsensor == 12
  for s in range(m.nsensor):
    adr, dim = int(m.sensor_adr[s]), int(m.sensor_dim[s])
    err = _scaled(port['sensordata'][:, adr:adr + dim],
                  ref['sensordata'][:, adr:adr + dim])
    name = m.id2name('sensor', s)
    print(f'sensor {name}: max scaled err {err:.2e}')
    assert err <= TOL, f'{name}: {err:.2e}'
  touch = m.sensor_adr[m.name2id('sensor', 'touchtop')]
  touched = ref['sensordata'][:, touch:touch + 2] > 0
  assert touched.any(), 'no lane presses a touch site'
  for f in ('qacc', 'efc_force'):
    print(f'{f}: max scaled err {_scaled(port[f], ref[f]):.2e}')
    assert _scaled(port[f], ref[f]) <= TOL


def test_has_contacts_matches_jax(models, contact_states):
  _, task = models
  qpos, bad, _, _, _ = contact_states
  pm = task.model
  d = forward.make_data(pm, len(qpos), torch.float64, 'cpu')
  out = base.has_contacts(pm, d.replace(qpos=torch.tensor(qpos))).numpy()
  print(f'has_contacts: {int(bad.sum())} of {len(bad)} draws in contact')
  np.testing.assert_array_equal(out, bad)
  assert 0.05 < bad.mean() < 0.15


def test_collision_free_selection_matches_jax(models):
  """20 candidates per lane: lanes 0-1 with no free candidate (the last
  one is kept), lanes 2-3 whose first 3 and 7 candidates touch, the
  rest drawn as they come."""
  jtask, task = models
  jm, pm = jtask.model, task.model
  rng = np.random.RandomState(1)
  A = 20
  cands = _draw_qpos(jm, A * BATCH, rng).reshape(A, BATCH, jm.nq)
  # lanes 0-1: every candidate in contact, from the in-contact pool
  pool = _draw_qpos(jm, 2048, rng)
  hit = np.asarray(jax.jit(jax.vmap(
      lambda q: jbase.has_contacts(jm, jforward.make_data(jm).replace(
          qpos=q))))(jnp.asarray(pool)))
  touching = pool[hit]
  cands[:, :2] = touching[:2 * A].reshape(A, 2, jm.nq)
  cands[:3, 2] = touching[2 * A:2 * A + 3]
  cands[:7, 3] = touching[2 * A + 3:2 * A + 10]
  keys = jax.random.split(jax.random.PRNGKey(0), A)

  def select_one(b):
    def sample(d, k):      # the candidate whose key this is
      i = jnp.argmax(jnp.all(jax.random.key_data(keys)
                             == jax.random.key_data(k), axis=1))
      return d.replace(qpos=jnp.asarray(cands)[i, b])
    return jbase.collision_free_init(sample, jm, jforward.make_data(jm),
                                     jax.random.PRNGKey(0),
                                     max_attempts=A).qpos

  ref = np.asarray(jax.jit(jax.vmap(select_one))(jnp.arange(BATCH)))
  d = forward.make_data(pm, BATCH, torch.float64, 'cpu')
  out = base.select_collision_free(
      pm, [d.replace(qpos=torch.tensor(c)) for c in cands]).qpos.numpy()
  np.testing.assert_array_equal(out, ref)
  np.testing.assert_array_equal(out[:2], cands[-1, :2])
  assert (out[2] == cands[3, 2]).all() and (out[3] == cands[7, 3]).all()


@pytest.fixture(scope='module')
def trajectories(models, contact_states):
  """8 lanes x 5 control steps from a JAX state in contact; the episode
  limit of 3 control steps sends every lane to the reset pool once."""
  jtask, task = models
  _, _, q, v, _ = contact_states
  jenv = jrunner.BatchedEnv(jtask, BATCH, time_limit=0.06)
  jstate = jenv.reset(jax.random.PRNGKey(3))
  jstate = jstate.replace(data=jstate.data.replace(
      qpos=jnp.asarray(q[:BATCH]), qvel=jnp.asarray(v[:BATCH])))
  env = runner.BatchedEnv(task, BATCH, time_limit=0.06, dtype=torch.float64)
  data = bridge.data_from_numpy(_fields(jstate.data), device='cpu',
                                dtype=torch.float64)
  pool = {f: torch.tensor(np.asarray(jstate.reset_pool[f]))
          for f in forward.state_of(data) if f != 'model_var'}
  pool['model_var'] = {k: torch.tensor(np.asarray(x)) for k, x in
                       jstate.reset_pool['model_var'].items()}
  state = runner.RunnerState(
      data=data, step_count=torch.zeros(BATCH, dtype=torch.int32),
      episode_id=torch.zeros(BATCH, dtype=torch.int32), reset_pool=pool)
  actions = np.random.RandomState(11).uniform(-1, 1, (STEPS, BATCH, 2))
  jstep = jax.jit(jenv.step)
  ref, out = [], []
  for t in range(STEPS):
    jstate, (jobs, jrew, jdone, _) = jstep(jstate, jnp.asarray(actions[t]))
    state, (obs, rew, done, _) = env.step(state, torch.tensor(actions[t]))
    ref.append(dict(qpos=np.asarray(jstate.data.qpos),
                    qvel=np.asarray(jstate.data.qvel),
                    reward=np.asarray(jrew), done=np.asarray(jdone),
                    episode_id=np.asarray(jstate.episode_id),
                    **{'obs.' + k: np.asarray(x) for k, x in jobs.items()}))
    out.append(dict(qpos=state.data.qpos.numpy(),
                    qvel=state.data.qvel.numpy(), reward=rew.numpy(),
                    done=done.numpy(), episode_id=state.episode_id.numpy(),
                    **{'obs.' + k: x.numpy() for k, x in obs.items()}))
  pool_qpos = np.asarray(pool['qpos'])
  return ref, out, pool_qpos, env


def test_rollout_matches_jax(trajectories):
  ref, out, _, env = trajectories
  assert env.reset_calls == 0                # the pool served the resets
  assert ref[2]['done'].all() and not ref[1]['done'].any()
  for t in range(STEPS):
    assert ref[t].keys() == out[t].keys()
    for k in ref[t]:
      a, b = out[t][k], ref[t][k]
      assert a.shape == b.shape, (t, k)
      if k in ('done', 'episode_id'):
        np.testing.assert_array_equal(a, b, err_msg=f'step {t} {k}')
        continue
      err = _scaled(a, b)
      print(f'step {t} {k}: max scaled err {err:.2e}')
      assert err <= TOL, f'step {t} {k}: {err:.2e}'
  # the lanes slide and spin: some reward, some contact
  assert max(r['reward'].max() for r in ref) == 1.0


def test_reset_pool_lane_index_matches_jax(trajectories):
  """The pool entry each lane took at its reset, read off the JAX run,
  is the port's pool_index."""
  ref, _, pool_qpos, _ = trajectories
  qpos = ref[2]['qpos']                         # right after the reset
  taken = np.array([np.nonzero((pool_qpos == q).all(1))[0][0] for q in qpos])
  lanes = torch.arange(BATCH)
  idx = runner.pool_index(torch.zeros(BATCH, dtype=torch.int32), lanes, BATCH)
  np.testing.assert_array_equal(idx.numpy(), taken)
  # later episodes: the uint32 wrap-around against numpy's uint32
  eid = torch.tensor([0, 1, 2, 7, 1000, 2 ** 20, 2 ** 31 - 2, 123456789])
  want = (((eid.numpy().astype(np.uint32) + np.uint32(1))
           * np.uint32(2654435761) + lanes.numpy().astype(np.uint32))
          % np.uint32(BATCH))
  np.testing.assert_array_equal(
      runner.pool_index(eid, lanes, BATCH).numpy(), want)
