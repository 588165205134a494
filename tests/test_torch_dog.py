"""dog (stand, walk, trot, run, fetch): the port against the JAX package,
float64 on the CPU.

Each of dog's two models (stand, walk, trot and run share one, 79 dofs;
fetch adds the ball, 85) is compiled once by each package: every body's
mass, inertia and inertial frame (the bone meshes' mass properties), the
sizes nv, nq, na and nu, and the collision groups and efc layout (18 and
27 groups, nefc 1912 and 3822) agree.  BATCH = 4 lanes drawn with numpy
(`dog_states`: standing with the feet pressed into the floor, or lying at
random orientations; fetch's ball beside the head, in the mouth or on the
target) start from the same state in both packages (the JAX Data carried
across by the bridge, `act` and fetch's second free joint included); the
same numpy actions drive the JAX package's `substeps` and the port's
BatchedEnv for STEPS = 2 control steps (6 physics steps, each through the
Newton core past the kernel's 64 dofs, noslip and dog's colliders):
qpos, qvel, act, reward and every observation key within
`test_torch_domains.TOL` at every step.  walk's, trot's and run's rewards
and observations are held at stand's states of each step (the JAX tasks
made on stand's model: they differ only in the floor's size, which no
reward, observation or contact reads).  The port's episode init is held
by its draws' ranges.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dm_control_tpu import suite as jsuite
from dm_control_tpu._src import forward as jforward
from dm_control_tpu.suite import dog as jdog
from dm_control_tpu_torch import bridge
from dm_control_tpu_torch import suite
from dm_control_tpu_torch._src import forward
from dm_control_tpu_torch._src import smooth
from dm_control_tpu_torch.ops import newton_kernel as nk
from dm_control_tpu_torch.parallel import runner
from test_torch_domains import (TOL, _check_layout, _fields, _jax_batch,
                                _jax_substeps, _scaled)

BATCH = 4
STEPS = 2


def dog_states(m, rng, n):
  """n dog states in numpy (qpos (n, nq), qvel (n, nv), act (n, na)) for
  model m (the JAX package's or the port's; fetch's where it has a ball):
  on even lanes standing at qpos0, every hinge within 0.3 of it, at a
  random yaw, the feet 0 to 3 cm into the floor; on odd lanes lying, the
  root 0.15 to 0.3 m up at a random orientation; each 0.6 to 1 m from the
  origin.  fetch's ball, still: on the floor beside the head (lanes 0 mod
  4), in the mouth between the bite sites (1 mod 4), on the target at the
  origin (2 mod 4) or over the body (3 mod 4).  Slow joint velocities,
  activations anywhere in the control range."""
  from dm_control_tpu_torch._src.types import JointType
  qpos = np.tile(np.asarray(m.qpos0, np.float64), (n, 1))
  even = np.arange(n) % 2 == 0
  for j in range(m.njnt):
    if m.jnt_type[j] == JointType.HINGE:
      q = m.jnt_qposadr[j]
      qpos[:, q] = np.clip(qpos[:, q] + rng.uniform(-0.3, 0.3, n),
                           *m.jnt_range[j])
  root = m.jnt_qposadr[m.name2id('joint', 'root')]
  yaw = rng.uniform(-np.pi, np.pi, n)
  quat = rng.randn(n, 4)
  quat /= np.linalg.norm(quat, axis=1, keepdims=True)
  qpos[:, root + 3:root + 7] = np.where(
      even[:, None], np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw,
                               np.sin(yaw / 2)], -1), quat)
  # 0.6 to 1 m from the target, which the JAX package's cylinder-box
  # collider takes for a sphere of its radius (a hand on it diverges in
  # both packages)
  away = rng.uniform(-np.pi, np.pi, n)
  qpos[:, root:root + 2] = rng.uniform(0.6, 1.0, (n, 1)) * np.stack(
      [np.cos(away), np.sin(away)], -1)
  qpos[:, root + 2] = np.where(even, m.qpos0[root + 2]
                               - rng.uniform(0.0, 0.03, n),
                               rng.uniform(0.15, 0.3, n))
  qvel = 0.3 * rng.randn(n, m.nv)
  act = rng.uniform(-1, 1, (n, m.na))
  if 'ball_root' in m.names['joint']:
    pm = suite.build_task('dog', 'fetch', device='cpu').model
    kin = smooth.kinematics(pm, forward.make_data(pm, n, torch.float64,
                                                  'cpu').replace(
        qpos=torch.tensor(qpos)))
    head = kin.site_xpos[:, pm.name2id('site', 'head')].numpy()
    mouth = 0.5 * (kin.site_xpos[:, pm.name2id('site', 'upper_bite')]
                   + kin.site_xpos[:, pm.name2id('site', 'lower_bite')])
    torso = kin.xpos[:, pm.name2id('body', 'torso')].numpy()
    r = float(m.geom_size[m.name2id('geom', 'ball'), 0])
    ang = rng.uniform(-np.pi, np.pi, n)
    beside = np.concatenate([head[:, :2] + 0.15 * np.stack(
        [np.cos(ang), np.sin(ang)], -1), r - rng.uniform(0, 1e-3, (n, 1))],
        -1)
    on_target = np.stack([rng.uniform(-0.05, 0.05, n),
                          rng.uniform(-0.05, 0.05, n),
                          0.004 + r - rng.uniform(0, 1e-3, n)], -1)
    over = torso + [0.0, 0.0, 0.3]
    kind = (np.arange(n) % 4)[:, None]
    ball = m.jnt_qposadr[m.name2id('joint', 'ball_root')]
    qpos[:, ball:ball + 3] = np.where(
        kind == 0, beside, np.where(kind == 1, mouth.numpy(),
                                    np.where(kind == 2, on_target, over)))
    qpos[:, ball + 3:ball + 7] = [1.0, 0.0, 0.0, 0.0]
    qvel[:, m.jnt_dofadr[m.name2id('joint', 'ball_root')]:][:, :6] = 0.0
  return qpos, qvel, act


@functools.lru_cache(maxsize=None)
def _jax_task(task_name):
  return jsuite.build_task('dog', task_name)


def _jax_move_tasks(jtask, monkeypatch):
  """The JAX package's walk, trot and run tasks on stand's model and
  parts (trot's and run's own models differ from it only in the floor's
  size), made without caching them."""
  parts = jtask.init_episode.__self__
  monkeypatch.setattr(jdog, '_model', lambda floor_size, remove_ball:
                      jtask.model)
  monkeypatch.setattr(jdog, '_Parts', lambda m: parts)
  return {name: jdog._make_move_task.__wrapped__(float(speed))
          for name, speed in (('walk', jdog._WALK_SPEED),
                              ('trot', jdog._TROT_SPEED),
                              ('run', jdog._RUN_SPEED))}


def _check_model(jm, m):
  """Body masses, inertias and inertial frames, and the sizes, against
  the JAX package's Model."""
  assert (m.nv, m.nq, m.na, m.nu, m.nbody) == (jm.nv, jm.nq, jm.na, jm.nu,
                                               jm.nbody)
  for f in ('body_mass', 'body_inertia', 'body_ipos', 'body_iquat',
            'body_subtreemass'):
    err = _scaled(getattr(m, f), getattr(jm, f))
    assert err <= 1e-12, (f, err)
  assert int(m.opt.noslip_iterations) == int(jm.opt.noslip_iterations) == 4


@pytest.mark.parametrize('task_name,nv,nefc,ngroups', [
    ('stand', 79, 1912, 18), ('fetch', 85, 3822, 27)])
def test_dog_matches_jax(task_name, nv, nefc, ngroups, monkeypatch):
  """The model, its groups and layout; then STEPS control steps of BATCH
  lanes, the JAX package's substeps, reward and observations against the
  port's BatchedEnv from the same states: every lane's qpos, qvel, act,
  reward and observations within TOL at every step (for stand, also
  walk's, trot's and run's rewards and observations at its states); the
  solve went through the core, contacts live on every lane."""
  from dm_control_tpu_torch._src import collision
  jtask = _jax_task(task_name)
  task = suite.build_task('dog', task_name, device='cpu')
  jm, m = jtask.model, task.model
  _check_model(jm, m)
  m_, lay = _check_layout('dog', task_name)
  assert (m_.nv, lay.nefc, len(collision.groups(m_))) == (nv, nefc, ngroups)
  assert lay.ell_groups == {} and nv > nk.MAX_NV
  rng = np.random.RandomState(11)
  qpos, qvel, act = dog_states(jm, rng, BATCH)
  actions = rng.uniform(-1, 1, (STEPS, BATCH, m.nu))
  n_sub = task.n_sub_steps()
  assert n_sub == 3
  d0 = jforward.make_data(jm)
  jsub = _jax_substeps(jm, n_sub)
  moves = _jax_move_tasks(jtask, monkeypatch) if task_name == 'stand' else {}
  outs = {name: _jax_batch(lambda d, t=t: (t.get_reward(jm, d),
                                           t.get_observation(jm, d)))
          for name, t in dict(moves, **{task_name: jtask}).items()}
  port_tasks = {name: suite.build_task('dog', name, device='cpu')
                for name in outs}
  jd = _jax_batch(lambda q, v, a: d0.replace(qpos=q, qvel=v, act=a))(
      jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(act))
  env = runner.BatchedEnv(task, BATCH, dtype=torch.float64)
  state = runner.RunnerState(
      data=bridge.data_from_numpy(_fields(jd), device='cpu',
                                  dtype=torch.float64),
      step_count=torch.zeros(BATCH, dtype=torch.int32),
      episode_id=torch.zeros(BATCH, dtype=torch.int32))
  errs = {}
  nk.reset_launches()
  for t in range(STEPS):
    jd = jsub(jd, jnp.asarray(actions[t]))
    state, (obs, rew, done, _) = env.step(state, torch.tensor(actions[t]))
    assert not done.any()
    ref = dict(qpos=jd.qpos, qvel=jd.qvel, act=jd.act)
    out = dict(qpos=state.data.qpos, qvel=state.data.qvel,
               act=state.data.act)
    for name, fn in outs.items():
      jrew, jobs = fn(jd)
      if name == task_name:
        prew, pobs = rew, obs
      else:
        pt = port_tasks[name]
        prew, pobs = pt.get_reward(pt.model, state.data), pt.get_observation(
            pt.model, state.data)
      ref[f'{name} reward'] = jrew
      out[f'{name} reward'] = prew
      assert pobs.keys() == jobs.keys(), name
      ref.update({f'{name} obs.{k}': x for k, x in jobs.items()})
      out.update({f'{name} obs.{k}': x for k, x in pobs.items()})
    for k in ref:
      assert np.shape(out[k]) == np.shape(ref[k]), (k, t)
      errs[k] = max(errs.get(k, 0.0), _scaled(out[k].numpy(), ref[k]))
  print(f'dog-{task_name}: max scaled err over {STEPS} control steps: '
        + ', '.join(f'{k} {e:.2e}' for k, e in errs.items()))
  assert all(e <= TOL for e in errs.values()), {
      k: e for k, e in errs.items() if e > TOL}
  assert nk.CORE_LOOPS['calls'] == STEPS * n_sub
  assert sum(nk.LAUNCHES.values()) == 0
  con = state.data.contact
  assert (con.dist < con.includemargin).any(1).all()


def test_dog_init_episode_draws():
  """The port's episode init on 256 lanes of each task: the root at qpos0's
  position with a yaw-only quaternion, horizontal root velocities and a
  yaw rate (the other three 0), activations within the control range;
  fetch's ball thrown from 0.75 of the floor's half size towards the
  middle, 5 cm up, no faster than its draws allow."""
  n = 256
  for name in ('stand', 'fetch'):
    task = suite.build_task('dog', name, device='cpu')
    m = task.model
    g = torch.Generator()
    g.manual_seed(0)
    d = task.init_episode(m, forward.make_data(m, n, torch.float64, 'cpu'), g)
    q, v, a = d.qpos.numpy(), d.qvel.numpy(), d.act.numpy()
    np.testing.assert_array_equal(q[:, :3], np.tile(m.qpos0[:3], (n, 1)))
    np.testing.assert_allclose(np.linalg.norm(q[:, 3:7], axis=1), 1.0)
    assert (q[:, 4:6] == 0).all() and (v[:, 2:5] == 0).all()
    assert (v[:, [0, 1, 5]] != 0).all()
    lo, hi = m.actuator_ctrlrange.T
    assert ((a >= lo) & (a <= hi)).all() and a.std(0).min() > 0.3
    if name == 'fetch':
      b = m.jnt_qposadr[m.name2id('joint', 'ball_root')]
      bd = m.jnt_dofadr[m.name2id('joint', 'ball_root')]
      floor = float(m.geom_size[m.name2id('geom', 'floor'), 0])
      np.testing.assert_allclose(np.linalg.norm(q[:, b:b + 2], axis=1),
                                 0.75 * floor)
      assert (q[:, b + 2] == 0.05).all()
      inward = -(q[:, b:b + 2] * v[:, bd:bd + 2]).sum(1)
      assert (inward > 0).mean() > 0.9
      assert (v[:, bd + 2] >= 0).all() and (
          v[:, bd + 2] <= np.sqrt(2 * 9.81 * 3) + 1e-9).all()
