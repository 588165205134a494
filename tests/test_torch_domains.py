"""The port's cheetah, hopper, pendulum, reacher, cartpole, acrobot,
finger-turn, point_mass, ball_in_cup, swimmer, fish, humanoid,
humanoid_CMU, quadruped (walk, escape, fetch), manipulator and stacker
against the JAX package's, float64 on the CPU.

For each task numpy draws 8 lanes' joint positions and velocities (where
the task would start out of contact, positions that touch or press a
limit; ball_in_cup's balls in the cup, on the floor or with the string
about taut; fish's free root at random orientations; manipulator's and
stacker's props on the floor, stacked or in the slot, `prop_states`, from
the JAX package's collision-free episode init; quadruped's on the floor,
escape's on its terrain, fetch's ball on the floor by the body or against
a wall; reacher's, finger-turn's, point_mass-hard's, swimmer's,
fish-swim's, manipulator's and stacker's per-lane `model_var` comes from
that init, escape's terrain from `jax.image.resize` of numpy bumps), and
the port takes the same states through the bridge.
The same numpy actions then drive the JAX package's `substeps` and the
port's BatchedEnv for 5 control steps.  qpos, qvel, reward and
every observation key agree to 1e-6 scaled by max(1, |ref|) at every
step, the rollout tests' bound: the solves stop at opt.tolerance and their
differences pass into everything after them.  The RK4 step alone, the
n <= 1 branch of `substeps`, `settle` and quadruped's settle (the lowest
contact-free height of 200) are held to the JAX package's functions as
well, the six manipulation models' and the tenth slice's collision groups
and efc layouts to the JAX package's, and escape's terrain resize to
`jax.image.resize`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dm_control_tpu import suite as jsuite
from dm_control_tpu._src import forward as jforward
from dm_control_tpu.suite import base as jbase
from dm_control_tpu_torch import bridge
from dm_control_tpu_torch import suite
from dm_control_tpu_torch._src import forward
from dm_control_tpu_torch.parallel import runner
from dm_control_tpu_torch.suite import base

BATCH = 8
STEPS = 5
TOL = 1e-6


def _fields(d):
  """Flat numpy dict of a batched JAX Data, keyed as the bridge keys it
  (`model_var` included)."""
  out = {f.name: np.asarray(getattr(d, f.name))
         for f in dataclasses.fields(d)
         if f.name not in ('contact', 'model_var')}
  out.update({'contact.' + f.name: np.asarray(getattr(d.contact, f.name))
              for f in dataclasses.fields(d.contact)})
  out.update({'model_var.' + k: np.asarray(x)
              for k, x in (d.model_var or {}).items()})
  return out


def _scaled(x, ref):
  x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
  return float((np.abs(x - ref) / np.maximum(1.0, np.abs(ref))).max(
      initial=0.0))


def _jax_batch(fn):
  return jax.jit(jax.vmap(fn))


_JAX_SUBSTEPS = {}


def _jax_substeps(jm, n_sub):
  """The JAX package's batched substeps of a model, compiled once per
  (model, n): humanoid_CMU's stand and run share one model and its ~1 min
  compile."""
  key = (id(jm), n_sub)
  if key not in _JAX_SUBSTEPS:
    _JAX_SUBSTEPS[key] = (jm, _jax_batch(
        lambda d, u: jforward.substeps(jm, d.replace(ctrl=u), n_sub)))
  return _JAX_SUBSTEPS[key][1]


def escape_terrain(jm, bumps):
  """escape's (n, 201 * 201) hfield_data from (n, 30, 30) numpy bumps, as
  the JAX package's episode init makes it: its bowl times the bumps'
  `jax.image.resize(..., 'bicubic')`."""
  res = int(jm.hfield_nrow[0])
  row_grid, col_grid = np.ogrid[-1:1:res * 1j, -1:1:res * 1j]
  radius = np.clip(np.sqrt(col_grid ** 2 + row_grid ** 2), .04, 1)
  bowl = .5 - np.cos(2 * np.pi * radius) / 2
  smooth = np.stack([np.asarray(jax.image.resize(jnp.asarray(b), (res, res),
                                                 'bicubic'))
                     for b in bumps])
  return (bowl * smooth).reshape(len(bumps), -1)


def terrain_height(jm, hdata, xy):
  """(n,) world height of escape's terrain (n, 201 * 201) at (n, 2)
  points, bilinear in numpy (the geom sits 0.01 below the origin)."""
  g = jm.name2id('geom', 'terrain')
  res, (sx, sy, sz) = int(jm.hfield_nrow[0]), jm.hfield_size[0, :3]
  f = (xy + [sx, sy]) / (2 * np.array([sx, sy])) * (res - 1)
  x0, y0 = np.floor(f).astype(int).T
  tx, ty = (f - np.floor(f)).T
  grid = hdata.reshape(-1, res, res) * sz
  n = np.arange(len(xy))
  h = (grid[n, y0, x0] * (1 - tx) * (1 - ty) + grid[n, y0, x0 + 1] * tx
       * (1 - ty) + grid[n, y0 + 1, x0] * (1 - tx) * ty
       + grid[n, y0 + 1, x0 + 1] * tx * ty)
  return h + jm.geom_pos[g, 2]


def ball_states(jm, rng, qpos):
  """fetch's ball in qpos (n, nq), in place: still and upright, on the
  floor beside the body (lanes 0, 2, ...) or against the wall at x = -15.7
  (tilted 45 degrees, lanes 1, 3, ...), 0 to 1 mm into each."""
  n = len(qpos)
  q = jm.jnt_qposadr[jm.name2id('joint', 'ball_root')]
  r = float(jm.geom_size[jm.name2id('geom', 'ball'), 0])
  z = r - rng.uniform(0, 1e-3, n)
  ang = rng.uniform(-np.pi, np.pi, n)
  by_body = qpos[:, :2] + 0.45 * np.stack([np.cos(ang), np.sin(ang)], -1)
  wall = jm.name2id('geom', 'wall_px')
  x_wall = ((r - rng.uniform(0, 1e-3, n)) * np.sqrt(2)
            + jm.geom_pos[wall, 0] - (z - jm.geom_pos[wall, 2]))
  at_wall = np.stack([x_wall, rng.uniform(-5, 5, n)], -1)
  qpos[:, q:q + 2] = np.where((np.arange(n) % 2 == 0)[:, None], by_body,
                              at_wall)
  qpos[:, q + 2] = z
  qpos[:, q + 3:q + 7] = [1.0, 0.0, 0.0, 0.0]


def prop_states(jm, rng, n, model_var=None, base=None):
  """n manipulator or stacker states in numpy, slow, with the props in
  contact on two lanes of three: the ball on the floor; the peg standing
  on its tip, or by turns in its slot (insert: at the slot's pose, from
  `model_var`'s body_pos and body_quat where given); box 0 on the floor,
  box 1 on box 0 and boxes 2 and 3 on the floor beside them, each turned
  by up to 0.05 or, on every fourth lane, exactly flat (their corners and
  faces tied).  The arm, and the third lanes' props, come from `base`
  (n, nq) where given (the task's collision-free init: the planar arm's
  links do not cross there, where two coplanar capsules' axes meet and
  their normal is rounding's), else the arm anywhere in range and those
  props anywhere in the air."""
  adr = lambda name: jm.jnt_qposadr[jm.name2id('joint', name)]
  names = jm.names['joint']
  if base is not None:
    qpos = np.array(base, np.float64)
  else:
    qpos = np.tile(jm.qpos0, (n, 1))
    for name in ('arm_root', 'arm_shoulder', 'arm_elbow', 'arm_wrist',
                 'thumb', 'thumbtip', 'fingertip'):
      j = jm.name2id('joint', name)
      lo, hi = jm.jnt_range[j] if jm.jnt_limited[j] else (-np.pi, np.pi)
      qpos[:, jm.jnt_qposadr[j]] = rng.uniform(lo, hi, n)
    qpos[:, adr('finger')] = qpos[:, adr('thumb')]
  on = np.arange(n) % 3 < 2
  sink = rng.uniform(0.0, 1e-3, n)
  tilt = np.where(np.arange(n) % 4 == 0, 0.0, rng.uniform(-0.05, 0.05, n))
  placed = {}
  if 'ball_x' in names:
    placed['ball_x'] = rng.uniform(-0.3, 0.3, n)
    placed['ball_z'] = np.where(on, 0.022 - sink, rng.uniform(0.1, 0.5, n))
  if 'peg_x' in names:
    x, z, angle = rng.uniform(-0.3, 0.3, n), 0.118 - sink, tilt
    if 'slot' in jm.names['body']:
      b = jm.name2id('body', 'slot')
      pos = np.tile(jm.body_pos[b], (n, 1))
      quat = np.tile(jm.body_quat[b], (n, 1))
      if model_var:
        pos, quat = model_var['body_pos'][:, b], model_var['body_quat'][:, b]
      into = np.arange(n) % 3 == 1
      x = np.where(into, pos[:, 0] + rng.uniform(-1e-3, 1e-3, n), x)
      z = np.where(into, pos[:, 2] + rng.uniform(-1e-3, 1e-3, n), z)
      angle = np.where(into, 2 * np.arctan2(quat[:, 2], quat[:, 0]), angle)
    placed['peg_x'] = x
    placed['peg_z'] = np.where(on, z, rng.uniform(0.2, 0.5, n))
    placed['peg_y'] = angle
  for i, x0 in enumerate((0.1, 0.1, -0.1, 0.25)):
    if f'box{i}_x' not in names:
      break
    placed[f'box{i}_x'] = x0 + rng.uniform(-0.01, 0.01, n)
    placed[f'box{i}_z'] = np.where(
        on, (0.066 if i == 1 else 0.022) - sink * (1 + (i == 1)),
        rng.uniform(0.1, 0.6, n))
    placed[f'box{i}_y'] = tilt * (1 - 2 * (i % 2))
  keep = on if base is not None else np.ones(n, bool)
  for name, value in placed.items():
    qpos[keep, adr(name)] = value[keep]
  return qpos, 0.3 * rng.randn(n, jm.nv)


def _states(what, jtask, rng):
  """The 8 lanes' starting (qpos, qvel, model_var) in numpy: joint
  positions uniform in range ([-pi, pi] where unlimited), placed where the
  task would start out of contact, random velocities; reacher's and
  finger-turn's targets (`model_var`) from the JAX package's own episode
  init."""
  jm = jtask.model
  qpos = np.tile(jm.qpos0, (BATCH, 1))
  for j in range(jm.njnt):
    lo, hi = jm.jnt_range[j] if jm.jnt_limited[j] else (-np.pi, np.pi)
    qpos[:, jm.jnt_qposadr[j]] = rng.uniform(lo, hi, BATCH)
  qvel = rng.randn(BATCH, jm.nv)
  adr = lambda name: jm.jnt_qposadr[jm.name2id('joint', name)]
  half = np.arange(BATCH) < BATCH // 2
  side = np.where(np.arange(BATCH) % 2, 1.0, -1.0)
  if what in ('cheetah-run', 'hopper-hop'):
    # low enough that the feet or legs touch the floor, near upright
    qpos[:, adr('rootx')] = 0.0
    qpos[:, adr('rootz')] = rng.uniform(-0.3, -0.05, BATCH)
    qpos[:, adr('rooty')] = rng.uniform(-0.5, 0.5, BATCH)
  if what.startswith('cartpole'):
    # half the carts at the slider's limit, moving into it: its row
    qpos[half, adr('slider')] = 1.78 * side[half]
    qvel[half, 0] = 2.0 * side[half]
  if what.startswith('reacher'):
    # half the wrists at their limit, moving into it: its row
    j = int(np.flatnonzero(jm.jnt_limited)[0])
    qpos[half, jm.jnt_qposadr[j]] = np.where(
        side[half] > 0, jm.jnt_range[j, 1] - 0.01, jm.jnt_range[j, 0] + 0.01)
    qvel[half, jm.jnt_dofadr[j]] = 3.0 * side[half]
  if what.startswith('point_mass'):
    # half the masses at a wall, moving into it: its limit row
    qpos[half, 0] = 0.28 * side[half]
    qvel[half, 0] = 0.5 * side[half]
  if what == 'ball_in_cup-catch':
    # cups near their rest, balls alternately in the cup, below it with
    # the string about taut, and on the floor under a lowered cup
    qpos[:, :2] = rng.uniform(-0.05, 0.05, (BATCH, 2))
    qpos[:, 2] = qpos[:, 0] + rng.uniform(-0.03, 0.03, BATCH)
    kind = np.arange(BATCH) % 3
    qpos[:, 3] = np.where(kind == 0, qpos[:, 1] + 0.2675,
                          rng.uniform(-0.015, 0.0, BATCH))
    qpos[kind == 2, 1] = -0.45
    qpos[kind == 2, 3] = -0.176
    qvel *= 0.3
  if what == 'swimmer-swimmer6':
    # half the first joints at their limit, moving into it; slow, as the
    # light segments' quadratic drag makes explicit steps of fast ones
    # diverge
    j = jm.name2id('joint', 'joint_0')
    qpos[half, jm.jnt_qposadr[j]] = np.where(
        side[half] > 0, jm.jnt_range[j, 1] - 0.01, jm.jnt_range[j, 0] + 0.01)
    qvel *= 0.3
    qvel[half, jm.jnt_dofadr[j]] = side[half]
  if what.startswith('fish'):
    # the free root at random orientations and positions; slow, as the
    # light fins' quadratic drag makes explicit steps of fast ones diverge
    quat = rng.randn(BATCH, 4)
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qpos[:, :3] = rng.uniform(-0.3, 0.3, (BATCH, 3))
    qvel *= 0.1
  if what.split('-')[0] in ('humanoid', 'humanoid_CMU', 'quadruped'):
    # the free root low, at random orientations: lying or standing on
    # the floor, limbs touching it and each other
    quat = rng.randn(BATCH, 4)
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qpos[:, :2] = rng.uniform(-0.5, 0.5, (BATCH, 2))
    qpos[:, 2] = rng.uniform(0.1, 0.4, BATCH)
    qvel *= 0.3
  model_var = {}
  if what == 'quadruped-escape':
    # a terrain per lane; half the bodies out on its slope, as low over it
    model_var['hfield_data'] = escape_terrain(
        jm, rng.uniform(0.15, 1.0, (BATCH, 30, 30)))
    ang = rng.uniform(-np.pi, np.pi, BATCH)
    out = np.where(half, rng.uniform(2.0, 6.0, BATCH), 0.0)
    qpos[:, :2] += out[:, None] * np.stack([np.cos(ang), np.sin(ang)], -1)
    qpos[:, 2] += np.maximum(terrain_height(jm, model_var['hfield_data'],
                                            qpos[:, :2]), 0.0)
  if what == 'quadruped-fetch':
    ball_states(jm, rng, qpos)
    qvel[:, -6:] = 0.0
  if (what.split('-')[0] in ('reacher', 'finger', 'swimmer', 'manipulator',
                             'stacker')
      or what in ('point_mass-hard', 'fish-swim')):
    d0 = jforward.make_data(jm)
    init = _jax_batch(lambda k: jtask.init_episode(jm, d0, k))(
        jax.random.split(jax.random.PRNGKey(3), BATCH))
    model_var = {k: np.asarray(x) for k, x in init.model_var.items()}
  if what.split('-')[0] in ('manipulator', 'stacker'):
    qpos, qvel = prop_states(jm, rng, BATCH, model_var, base=init.qpos)
  return qpos, qvel, model_var


CASES = ['cheetah-run', 'hopper-hop', 'pendulum-swingup', 'reacher-easy',
         'cartpole-swingup', 'cartpole-two_poles', 'acrobot-swingup',
         'finger-turn_easy', 'point_mass-easy', 'point_mass-hard',
         'ball_in_cup-catch', 'swimmer-swimmer6', 'fish-swim',
         'humanoid-run', 'quadruped-walk', 'manipulator-bring_ball',
         'manipulator-insert_peg', 'stacker-stack_2', 'humanoid_CMU-stand',
         'humanoid_CMU-run', 'quadruped-escape', 'quadruped-fetch']


@pytest.mark.parametrize('what', CASES)
def test_domain_matches_jax(what):
  """5 control steps of 8 lanes, the JAX package's substeps, reward and
  observations against the port's BatchedEnv from the same states (their
  model_var through the bridge): every lane's qpos, qvel, reward and
  observations within TOL at every step; the lanes' model_var arrives per
  lane and stays; the task's rows (if it has any) are active on some
  lane."""
  domain, task_name = what.split('-')
  jtask = jsuite.build_task(domain, task_name)
  task = suite.build_task(domain, task_name, device='cpu')
  jm, m = jtask.model, task.model
  rng = np.random.RandomState(7)
  qpos, qvel, model_var = _states(what, jtask, rng)
  lo, hi = m.actuator_ctrlrange.T
  actions = rng.uniform(lo, hi, (STEPS, BATCH, m.nu))
  # quadruped's filter activations start anywhere in the control range
  act = rng.uniform(-1, 1, (BATCH, m.na))
  n_sub = task.n_sub_steps()
  d0 = jforward.make_data(jm)
  jsub = _jax_substeps(jm, n_sub)
  jout = _jax_batch(lambda d: (jtask.get_reward(jm, d),
                               jtask.get_observation(jm, d)))

  def jstep(d, u):
    d = jsub(d, u)
    return (d,) + jout(d)

  jd = _jax_batch(lambda q, v, a, mv: d0.replace(qpos=q, qvel=v, act=a,
                                                 model_var=mv))(
      jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(act),
      {k: jnp.asarray(x) for k, x in model_var.items()})
  env = runner.BatchedEnv(task, BATCH, dtype=torch.float64)
  data = bridge.data_from_numpy(_fields(jd), device='cpu',
                                dtype=torch.float64)
  assert data.model_var.keys() == model_var.keys()
  for k, x in data.model_var.items():
    assert x.shape[0] == BATCH and not torch.equal(x[0], x[1]), k
  state = runner.RunnerState(
      data=data, step_count=torch.zeros(BATCH, dtype=torch.int32),
      episode_id=torch.zeros(BATCH, dtype=torch.int32))
  errs, rows = {}, np.zeros(BATCH, bool)
  for t in range(STEPS):
    jd, jrew, jobs = jstep(jd, jnp.asarray(actions[t]))
    state, (obs, rew, done, _) = env.step(state, torch.tensor(actions[t]))
    ref = dict(qpos=jd.qpos, qvel=jd.qvel, act=jd.act, reward=jrew,
               **{'obs.' + k: x for k, x in jobs.items()})
    out = dict(qpos=state.data.qpos, qvel=state.data.qvel,
               act=state.data.act, reward=rew,
               **{'obs.' + k: x for k, x in obs.items()})
    assert out.keys() == ref.keys()
    for k in ref:
      assert np.shape(out[k]) == np.shape(ref[k]), (k, t)
      errs[k] = max(errs.get(k, 0.0), _scaled(out[k].numpy(), ref[k]))
    assert not done.any()
    rows |= state.data.efc_active.any(dim=1).numpy()
  for k, x in state.data.model_var.items():
    np.testing.assert_array_equal(x.numpy(), model_var[k])
  print(f'{what}: max scaled err over {STEPS} control steps: '
        + ', '.join(f'{k} {e:.2e}' for k, e in errs.items()))
  assert all(e <= TOL for e in errs.values()), errs
  if state.data.efc_active.shape[1]:
    assert rows.any(), f'{what}: no constraint row was active'


@pytest.mark.parametrize('what', ['cartpole-swingup', 'acrobot-swingup'])
def test_rk4_step_matches_jax(what):
  """One RK4 step (after the acc stage of a forward-synced state) of
  numpy-drawn states: qpos and qvel within 1e-9; cartpole's first four
  lanes start past the slider limit, so its row is active."""
  domain, task_name = what.split('-')
  jm = jsuite.build_task(domain, task_name).model
  m = suite.build_task(domain, task_name, device='cpu').model
  rng = np.random.RandomState(2)
  qpos = np.tile(jm.qpos0, (BATCH, 1)) + rng.uniform(-3, 3, (BATCH, jm.nq))
  qvel = 2 * rng.randn(BATCH, jm.nv)
  ctrl = rng.uniform(-1, 1, (BATCH, jm.nu))
  if domain == 'cartpole':
    qpos[:4, 0], qvel[:4, 0] = 1.81, 3.0
  d0 = jforward.make_data(jm)

  def one(q, v, u):
    d = jforward.forward(jm, d0.replace(qpos=q, qvel=v, ctrl=u))
    d = jforward.rk4(jm, d)
    return d.qpos, d.qvel

  jq, jv = _jax_batch(one)(*map(jnp.asarray, (qpos, qvel, ctrl)))
  d = forward.make_data(m, BATCH, torch.float64, 'cpu').replace(
      qpos=torch.tensor(qpos), qvel=torch.tensor(qvel),
      ctrl=torch.tensor(ctrl))
  d = forward.forward(m, d)
  if domain == 'cartpole':
    assert bool(d.efc_active[:4].all())
  d = forward.rk4(m, d)
  err = max(_scaled(d.qpos.numpy(), jq), _scaled(d.qvel.numpy(), jv))
  print(f'{what}: one RK4 step, max scaled err {err:.2e}')
  assert err <= 1e-9


def test_substeps_single_step_self_syncs():
  """`substeps` with n = 1 (reacher's n_sub, and cheetah's) on Data whose
  derived fields belong to other states (what auto-reset lanes give it):
  the same bits as on the synced Data, and the JAX package's result
  within 1e-9 (its per-lane target geom_pos included)."""
  jtask = jsuite.build_task('reacher', 'easy')
  jm = jtask.model
  m = suite.build_task('reacher', 'easy', device='cpu').model
  assert suite.build_task('reacher', 'easy', device='cpu').n_sub_steps() == 1
  rng = np.random.RandomState(4)
  qpos = rng.uniform(-3, 3, (BATCH, jm.nq))
  qvel = 3 * rng.randn(BATCH, jm.nv)
  ctrl = rng.uniform(-1, 1, (BATCH, jm.nu))
  geom_pos = np.tile(jm.geom_pos, (BATCH, 1, 1))
  geom_pos[:, jm.name2id('geom', 'target'), :2] = rng.uniform(
      -.2, .2, (BATCH, 2))
  d0 = jforward.make_data(jm)

  def one(q, v, u, gp):
    d = d0.replace(qpos=q, qvel=v, ctrl=u, model_var={'geom_pos': gp})
    d = jforward.substeps(jm, d, 1)
    return d.qpos, d.qvel

  jq, jv = _jax_batch(one)(*map(jnp.asarray, (qpos, qvel, ctrl, geom_pos)))
  t = lambda x: torch.tensor(x)
  mv = {'geom_pos': t(geom_pos)}
  fresh = forward.make_data(m, BATCH, torch.float64, 'cpu')
  synced = forward.forward(m, fresh.replace(qpos=t(qpos), qvel=t(qvel),
                                            model_var=mv))
  # derived fields of the lanes in reverse order
  stale = forward.forward(m, fresh.replace(
      qpos=t(qpos[::-1].copy()), qvel=t(qvel[::-1].copy()),
      model_var={'geom_pos': t(geom_pos[::-1].copy())}))
  stale = stale.replace(**forward.state_of(synced))
  outs = [forward.substeps(m, d.replace(ctrl=t(ctrl)), 1)
          for d in (synced, stale)]
  for f in ('qpos', 'qvel', 'qacc', 'xpos', 'efc_force'):
    assert torch.equal(getattr(outs[0], f), getattr(outs[1], f)), f
  err = max(_scaled(outs[1].qpos.numpy(), jq),
            _scaled(outs[1].qvel.numpy(), jv))
  print(f'substeps(n=1) on stale Data vs JAX: max scaled err {err:.2e}')
  assert err <= 1e-9


def test_settle_matches_jax():
  """`base.settle` of cheetah over 20 steps from numpy-drawn joint angles
  against the JAX package's: qpos and qvel within 1e-6, time back at 0."""
  jm = jsuite.build_task('cheetah', 'run').model
  m = suite.build_task('cheetah', 'run', device='cpu').model
  rng = np.random.RandomState(6)
  qpos = np.tile(jm.qpos0, (4, 1))
  lim = jm.jnt_limited.astype(bool)
  qpos[:, jm.jnt_qposadr[lim]] = rng.uniform(*jm.jnt_range[lim].T, (4,
                                                                   lim.sum()))
  d0 = jforward.make_data(jm)
  settle = _jax_batch(lambda q: jbase.settle(jm, d0.replace(qpos=q), 20))
  jd = settle(jnp.asarray(qpos))
  d = base.settle(m, forward.make_data(m, 4, torch.float64, 'cpu').replace(
      qpos=torch.tensor(qpos)), 20)
  err = max(_scaled(d.qpos.numpy(), jd.qpos), _scaled(d.qvel.numpy(),
                                                       jd.qvel))
  print(f'settle(20) vs JAX: max scaled err {err:.2e}')
  assert err <= TOL
  assert bool((d.time == 0).all()) and bool(d.efc_active.any())


TASKS = [('cheetah', 'run'), ('hopper', 'stand'), ('hopper', 'hop'),
         ('pendulum', 'swingup'), ('reacher', 'easy'), ('reacher', 'hard'),
         ('cartpole', 'balance'), ('cartpole', 'balance_sparse'),
         ('cartpole', 'swingup'), ('cartpole', 'swingup_sparse'),
         ('cartpole', 'two_poles'), ('cartpole', 'three_poles'),
         ('acrobot', 'swingup'), ('acrobot', 'swingup_sparse'),
         ('finger', 'turn_easy'), ('finger', 'turn_hard'),
         ('point_mass', 'easy'), ('point_mass', 'hard'),
         ('ball_in_cup', 'catch'), ('swimmer', 'swimmer6'),
         ('swimmer', 'swimmer15'), ('fish', 'upright'), ('fish', 'swim'),
         ('humanoid', 'stand'), ('humanoid', 'walk'), ('humanoid', 'run'),
         ('humanoid', 'run_pure_state'), ('quadruped', 'walk'),
         ('quadruped', 'run'), ('quadruped', 'escape'),
         ('quadruped', 'fetch'), ('humanoid_CMU', 'stand'),
         ('humanoid_CMU', 'run'), ('manipulator', 'bring_ball'),
         ('manipulator', 'bring_peg'), ('manipulator', 'insert_ball'),
         ('manipulator', 'insert_peg'), ('stacker', 'stack_2'),
         ('stacker', 'stack_4')]


@pytest.mark.parametrize('domain,task_name', TASKS)
def test_every_task_builds_and_steps(domain, task_name):
  """Each task of the slice builds on the CPU when asked, resets 2 lanes
  and takes 2 control steps with finite states and rewards in [0, 1];
  without a CUDA device and without device='cpu', build_task raises."""
  task = suite.build_task(domain, task_name, device='cpu')
  env = runner.BatchedEnv(task, 2, dtype=torch.float64)
  gen = torch.Generator()
  gen.manual_seed(0)
  state, rewards = env.rollout_fn(2)(env.reset(seed=0), gen)
  for f, x in forward.state_items(forward.state_of(state.data)):
    assert x.dtype == torch.bool or bool(torch.isfinite(x).all()), f
  assert bool(((rewards >= 0) & (rewards <= 1)).all())
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='device="cpu"'):
      suite.build_task(domain, task_name)


def test_quadruped_settle_matches_jax():
  """quadruped's settle at 8 random orientations (numpy draws, the hinges
  at qpos0): each lane's torso height, and so its qpos, equal to the JAX
  package's, and the settled lanes touch nothing."""
  from dm_control_tpu.suite import quadruped as jquadruped
  from dm_control_tpu_torch.suite import quadruped
  jtask = jsuite.build_task('quadruped', 'walk')
  jm = jtask.model
  m = suite.build_task('quadruped', 'walk', device='cpu').model
  quat = np.random.RandomState(8).randn(BATCH, 4)
  quat /= np.linalg.norm(quat, axis=1, keepdims=True)
  d0 = jforward.make_data(jm)
  jp = jquadruped._Parts(jm)
  jq = _jax_batch(lambda q: jp.settle(jm, d0, q).qpos)(jnp.asarray(quat))
  d = quadruped._Parts(m).settle(
      m, forward.make_data(m, BATCH, torch.float64, 'cpu'), torch.tensor(quat))
  print(f'quadruped settle: heights {d.qpos[:, 2].tolist()}')
  np.testing.assert_array_equal(d.qpos.numpy(), np.asarray(jq))
  assert bool((d.qpos[:, 2] > 0).all())
  assert not bool(base.has_contacts(m, d).any())


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32],
                         ids=['float64', 'float32'])
def test_escape_terrain_resize_matches_jax(dtype):
  """escape's upsampling of 4 lanes' numpy bumps (30 x 30 -> 201 x 201)
  equals `jax.image.resize(..., 'bicubic')` of the same bumps to
  rounding (torch's own bicubic interpolate is another kernel: it is off
  by far more), and the bowl times it is the hfield_data the JAX package's
  init makes."""
  from dm_control_tpu_torch.suite import quadruped
  m = suite.build_task('quadruped', 'escape', device='cpu').model
  bumps = np.random.RandomState(12).uniform(0.15, 1.0, (4, 30, 30))
  ref = np.stack([np.asarray(jax.image.resize(jnp.asarray(b), (201, 201),
                                              'bicubic')) for b in bumps])
  out = quadruped.bicubic_resize(m, torch.tensor(bumps, dtype=dtype), 201)
  err = np.abs(out.double().numpy() - ref).max()
  other = torch.nn.functional.interpolate(
      torch.tensor(bumps)[:, None], size=(201, 201), mode='bicubic',
      align_corners=False)[:, 0].numpy()
  print(f'terrain resize {dtype}: max err {err:.2e} (torch bicubic '
        f'{np.abs(other - ref).max():.2e})')
  assert err <= (1e-12 if dtype == torch.float64 else 1e-6)
  assert np.abs(other - ref).max() > 1e-3


MANIPULATION = [('manipulator', 'bring_ball'), ('manipulator', 'bring_peg'),
                ('manipulator', 'insert_ball'), ('manipulator', 'insert_peg'),
                ('stacker', 'stack_2'), ('stacker', 'stack_4')]


def _check_layout(domain, task_name):
  """The task's collision groups (geom types, condim, friction, pairs, K)
  and efc layout (nefc, row types, the elliptic groups' rows, mu and
  scales) equal the JAX package's; returns (model, layout)."""
  from dm_control_tpu._src import collision as jcollision
  from dm_control_tpu._src import efc as jefc
  from dm_control_tpu_torch._src import collision
  from dm_control_tpu_torch._src import efc
  jm = jsuite.build_task(domain, task_name).model
  m = suite.build_task(domain, task_name, device='cpu').model
  jg, g = jcollision.groups(jm), collision.groups(m)
  assert len(g) == len(jg)
  for a, b in zip(g, jg):
    assert (int(a.t1), int(a.t2), a.condim, a.npairs, a.K) == (
        int(b.t1), int(b.t2), b.condim, b.npairs, b.K)
    np.testing.assert_array_equal(a.g1, b.g1)
    np.testing.assert_array_equal(a.g2, b.g2)
    np.testing.assert_array_equal(a.friction, b.friction)
  jlay, lay = jefc.layout(jm), efc.layout(m)
  assert lay.nefc == jlay.nefc
  np.testing.assert_array_equal(lay.types, jlay.types)
  assert lay.ell_groups.keys() == jlay.ell_groups.keys()
  for k in lay.ell_groups:
    for x, y in zip(lay.ell_groups[k], jlay.ell_groups[k]):
      np.testing.assert_array_equal(x, y)
  print(f'{domain}-{task_name}: nv {m.nv} nefc {lay.nefc}; groups '
        f'{[(a.t1.name, a.t2.name, a.condim, a.npairs, a.K) for a in g]}')
  return m, lay


@pytest.mark.parametrize('domain,task_name', MANIPULATION)
def test_manipulation_layout_matches_jax(domain, task_name):
  """Each manipulation model's groups and layout equal the JAX package's
  (`_check_layout`): the props each task prunes, and the box groups among
  them, give the same rows, with condim-3 elliptic cones."""
  _, lay = _check_layout(domain, task_name)
  assert lay.ell_groups.keys() == {3}


@pytest.mark.parametrize('what,nv,nefc', [
    ('humanoid_CMU-run', 62, 880), ('quadruped-escape', 22, 378),
    ('quadruped-fetch', 28, 598)])
def test_slice_layout_matches_jax(what, nv, nefc):
  """humanoid_CMU's (its ellipsoid pair and three top-K groups), escape's
  (the heightfield against four partner types) and fetch's (the condim-6
  ball against the floor, the walls and the body) groups and layouts
  equal the JAX package's: pyramidal, at the nv and nefc K2 takes."""
  m, lay = _check_layout(*what.split('-'))
  assert (m.nv, lay.nefc, lay.ell_groups) == (nv, nefc, {})


# -- the eleventh slice: the cone model, jaco, lqr ---------------------------


def test_cone_model_matches_jax():
  """The cone model (`chip_smoke.cones_xml`: elliptic cones of condim 6,
  4 and 3 on free bodies) through `engine.load_model_from_string` on both
  sides: its layout equals the JAX package's, and 5 physics steps of 8
  lanes of `chip_smoke.cone_states` (bodies on the floor, stacked, the rod
  against the box) keep qpos and qvel within TOL of the JAX package's
  substeps, step by step, with live cones of every condim."""
  import chip_smoke
  from dm_control_tpu._src import efc as jefc
  from dm_control_tpu._src import engine as jengine
  from dm_control_tpu_torch._src import efc
  from dm_control_tpu_torch._src import engine
  xml = chip_smoke.cones_xml(1)
  jm = jengine.load_model_from_string(xml)
  m = engine.load_model_from_string(xml, device='cpu')
  jlay, lay = jefc.layout(jm), efc.layout(m)
  assert (m.nv, lay.nefc) == (jm.nv, jlay.nefc) == (18, 48)
  np.testing.assert_array_equal(lay.types, jlay.types)
  assert lay.ell_groups.keys() == jlay.ell_groups.keys() == {3, 4, 6}
  for k in lay.ell_groups:
    for a, b in zip(lay.ell_groups[k], jlay.ell_groups[k]):
      np.testing.assert_array_equal(a, b)
  qpos, qvel = chip_smoke.cone_states(jm, BATCH, np.random.RandomState(8))
  jd = _jax_batch(lambda q, v: jforward.make_data(jm).replace(qpos=q, qvel=v))(
      jnp.asarray(qpos), jnp.asarray(qvel))
  ctrl = jnp.zeros((BATCH, 0))
  jsub = _jax_substeps(jm, 1)
  d = forward.make_data(m, BATCH, torch.float64, 'cpu').replace(
      qpos=torch.tensor(qpos), qvel=torch.tensor(qvel))
  err, live = 0.0, set()
  for _ in range(STEPS):
    jd = jsub(jd, ctrl)
    d = forward.substeps(m, d, 1)
    err = max(err, _scaled(d.qpos.numpy(), jd.qpos),
              _scaled(d.qvel.numpy(), jd.qvel))
    for k, (rows, _, _) in lay.ell_groups.items():
      if bool(d.efc_active[:, rows[:, 0]].any()):
        live.add(k)
  print(f'cone model: {STEPS} physics steps, max scaled err {err:.2e}')
  assert err <= TOL and live == {3, 4, 6}


_JACO_HOME = np.array([4.92, 2.839, 0.0, .758, 4.6366, 4.493, 5.0249, 1.1,
                       0.1, 1.1, 0.1, 1.1, 0.1])


@pytest.mark.parametrize('task_name', ['position_reacher_7DOF',
                                       'relative_position_reacher_7DOF',
                                       'configurable_reacher'])
def test_jaco_matches_jax(task_name):
  """jaco's tasks: `before_step` on 8 lanes near home with numpy actions
  in the task's bounds (and beyond them, and at a pose whose DH extremes
  leave the fence) gives the JAX package's controls and penalty; then 3
  RK4 physics steps (not a whole control step: 100 of them) from those
  controls with the target per lane, and the reward (penalty included)
  and observations there, within TOL of the JAX package's."""
  jtask = jsuite.build_task('jaco', task_name)
  task = suite.build_task('jaco', task_name, device='cpu')
  jm, m = jtask.model, task.model
  assert task.n_sub_steps() == jtask.n_sub_steps() == 100
  rng = np.random.RandomState(9)
  qpos = _JACO_HOME + 0.3 * rng.randn(BATCH, m.nq)
  qpos[0, 1] = 5.2                       # the arm down: past the fence
  qvel = 0.3 * rng.randn(BATCH, m.nv)
  target = rng.uniform(-0.5, 0.5, (BATCH, 3)) + [0.0, 0.0, 0.5]
  geom_pos = np.tile(jm.geom_pos, (BATCH, 1, 1))
  geom_pos[:, jm.name2id('geom', 'target')] = target
  lo, hi = task.action_bounds()
  spec = jtask.action_spec_fn()
  np.testing.assert_array_equal(lo, spec.minimum)
  np.testing.assert_array_equal(hi, spec.maximum)
  action = rng.uniform(lo, hi, (BATCH, len(lo)))
  action[1] = 2 * hi                     # beyond the bounds: clipped
  mv = {'geom_pos': geom_pos, '_jaco_penalty': np.zeros(BATCH)}
  d0 = jforward.make_data(jm)
  jd = _jax_batch(lambda q, v, g, p: d0.replace(
      qpos=q, qvel=v, model_var={'geom_pos': g, '_jaco_penalty': p}))(
          *map(jnp.asarray, (qpos, qvel, geom_pos, mv['_jaco_penalty'])))
  jd = _jax_batch(lambda d, a: jtask.before_step(jm, d, a))(
      jd, jnp.asarray(action))
  d = forward.make_data(m, BATCH, torch.float64, 'cpu').replace(
      qpos=torch.tensor(qpos), qvel=torch.tensor(qvel),
      model_var={k: torch.tensor(x) for k, x in mv.items()})
  d = task.before_step(m, d, torch.tensor(action))
  penalty = d.model_var['_jaco_penalty'].numpy()
  err = {'ctrl': _scaled(d.ctrl.numpy(), jd.ctrl),
         'penalty': _scaled(penalty, jd.model_var['_jaco_penalty'])}
  assert (penalty <= -2).any() and (penalty < 0).all(), penalty
  jsub = _jax_substeps(jm, 1)
  for _ in range(3):
    jd = jsub(jd, jd.ctrl)
    d = forward.substeps(m, d, 1)
  err['qpos'] = _scaled(d.qpos.numpy(), jd.qpos)
  err['qvel'] = _scaled(d.qvel.numpy(), jd.qvel)
  jrew, jobs = _jax_batch(lambda dd: (jtask.get_reward(jm, dd),
                                      jtask.get_observation(jm, dd)))(jd)
  err['reward'] = _scaled(task.get_reward(m, d).numpy(), jrew)
  obs = task.get_observation(m, d)
  assert obs.keys() == jobs.keys()
  for k in obs:
    err['obs.' + k] = _scaled(obs[k].numpy(), jobs[k])
  print(f'jaco {task_name}: before_step and 3 RK4 physics steps, max '
        f'scaled err ' + ', '.join(f'{k} {e:.2e}' for k, e in err.items()))
  assert all(e <= TOL for e in err.values()), err


def test_jaco_rejects_other_models():
  from dm_control_tpu_torch.suite import jaco
  with pytest.raises(NotImplementedError, match='jaco_j2s6s300'):
    jaco.configurable_reacher('cpu', xml_name='jaco_j2s6s300_position.xml')


def test_jaco_6dof_model_and_steps_match_jax():
  """jaco's 6-DoF model file (`jaco_j2s6s300_position.xml`: the arm.stl
  mesh, no gravity, velocity actuators) compiles to the JAX package's Model
  field for field, and two of jaco's control steps (200 RK4 physics steps)
  from 2 states in the joint ranges under velocity controls in [-1, 1]
  keep qpos and qvel within TOL of the JAX package's, at float64 on the
  CPU.  (The reacher task itself takes the 7-DoF file only, in both
  packages: the JAX package's raises KeyError on this one.)"""
  from dm_control_tpu.suite import jaco as jjaco
  from dm_control_tpu_torch.suite import jaco
  from test_torch_model import SETCONST_FIELDS, _assert_same
  xml = 'jaco_j2s6s300_position.xml'
  jm, m = jjaco._model(xml), jaco._model(xml, 'cpu')
  for f in dataclasses.fields(jm):
    if f.name in SETCONST_FIELDS:
      assert _scaled(getattr(m, f.name), getattr(jm, f.name)) <= 1e-12
    else:
      _assert_same(f.name, getattr(jm, f.name), getattr(m, f.name))
  assert (m.nq, m.nv, m.nu) == (12, 12, 12)
  n = 2
  rng = np.random.RandomState(12)
  lo, hi = np.asarray(jm.jnt_range).T
  qpos = rng.uniform(np.maximum(lo, -np.pi), np.minimum(hi, np.pi), (n, 12))
  qvel = 0.3 * rng.randn(n, 12)
  ctrl = rng.uniform(-1, 1, (n, 12))
  d0 = jforward.make_data(jm)
  jd = _jax_batch(lambda q, v: jforward.forward(jm, d0.replace(
      qpos=q, qvel=v)))(jnp.asarray(qpos), jnp.asarray(qvel))
  jd = _jax_substeps(jm, 200)(jd, jnp.asarray(ctrl))
  d = forward.forward(m, forward.make_data(m, n, torch.float64, 'cpu').replace(
      qpos=torch.tensor(qpos), qvel=torch.tensor(qvel)))
  d = forward.substeps(m, d.replace(ctrl=torch.tensor(ctrl)), 200)
  err = {'qpos': _scaled(d.qpos.numpy(), jd.qpos),
         'qvel': _scaled(d.qvel.numpy(), jd.qvel)}
  print(f'jaco 6-DoF: 200 RK4 physics steps, contacts at the end '
        f'{d.efc_active.sum(1).tolist()}; max scaled err '
        + ', '.join(f'{k} {e:.2e}' for k, e in err.items()))
  assert all(e <= TOL for e in err.values()), err
  assert _scaled(qpos, d.qpos.numpy()) > 0.1        # the arm moved


@pytest.mark.parametrize('task_name', ['lqr_2_1', 'lqr_6_2'])
def test_lqr_matches_jax(task_name):
  """lqr's model equals the JAX package's field for field (its numpy
  RandomState stiffnesses included); 5 steps of BatchedEnv from 8 states
  on the sphere |qpos| = sqrt(2) keep qpos, reward and observations
  within TOL of the JAX package's; a lane at rest at the origin ends its
  episode at the first step, as the JAX package's termination says
  (discount 0), and restarts on the sphere."""
  from test_torch_model import SETCONST_FIELDS, _assert_same
  jtask = jsuite.build_task('lqr', task_name)
  task = suite.build_task('lqr', task_name, device='cpu')
  jm, m = jtask.model, task.model
  for f in dataclasses.fields(jm):
    if f.name in SETCONST_FIELDS:
      assert _scaled(getattr(m, f.name), getattr(jm, f.name)) <= 1e-12
    else:
      _assert_same(f.name, getattr(jm, f.name), getattr(m, f.name))
  rng = np.random.RandomState(10)
  unit = rng.randn(BATCH, m.nq)
  qpos = np.sqrt(2) * unit / np.linalg.norm(unit, axis=1, keepdims=True)
  qvel = rng.randn(BATCH, m.nv)
  qpos[0], qvel[0] = 0.0, 0.0
  actions = rng.uniform(-1, 1, (STEPS, BATCH, m.nu))
  actions[:, 0] = 0.0
  d0 = jforward.make_data(jm)
  jd = _jax_batch(lambda q, v: d0.replace(qpos=q, qvel=v))(
      jnp.asarray(qpos), jnp.asarray(qvel))
  jsub = _jax_substeps(jm, 1)
  jout = _jax_batch(lambda d: (jtask.get_reward(jm, d),
                               jtask.get_observation(jm, d),
                               jtask.get_termination(jm, d)))
  env = runner.BatchedEnv(task, BATCH, dtype=torch.float64)
  state = env.reset(seed=0)
  state = runner.RunnerState(
      data=forward.forward(m, state.data.replace(
          qpos=torch.tensor(qpos), qvel=torch.tensor(qvel))),
      step_count=state.step_count, episode_id=state.episode_id)
  errs = {}
  for t in range(STEPS):
    jd = jsub(jd, jnp.asarray(actions[t]))
    jrew, jobs, jterm = jout(jd)
    state, (obs, rew, done, discount) = env.step(state,
                                                 torch.tensor(actions[t]))
    # lane 0 follows the JAX package's lane only to its reset
    on = slice(0, BATCH) if t == 0 else slice(1, BATCH)
    jterm = np.asarray(jterm)
    np.testing.assert_array_equal(done.numpy()[on], jterm[on])
    np.testing.assert_array_equal(discount.numpy()[on],
                                  np.where(jterm[on], 0.0, 1.0))
    assert bool(done[0]) == (t == 0)
    errs['reward'] = max(errs.get('reward', 0.0),
                         _scaled(rew.numpy()[on], np.asarray(jrew)[on]))
    for k in obs:
      errs['obs.' + k] = max(errs.get('obs.' + k, 0.0), _scaled(
          obs[k].numpy()[on], np.asarray(jobs[k])[on]))
    errs['qpos'] = max(errs.get('qpos', 0.0), _scaled(
        state.data.qpos.numpy()[1:], np.asarray(jd.qpos)[1:]))
  print(f'lqr {task_name}: {STEPS} steps, max scaled err '
        + ', '.join(f'{k} {e:.2e}' for k, e in errs.items()))
  assert all(e <= TOL for e in errs.values()), errs
  # lane 0 rested at the origin: its first step ended its episode, and it
  # restarted on the sphere
  assert int(state.episode_id[0]) == 1
  assert int(state.step_count[0]) == STEPS - 1
  assert not bool(state.episode_id[1:].any())


def test_batched_env_maps_actions_through_before_step():
  """BatchedEnv with a task's `before_step` (jaco's) steps the Data it
  returns, not the raw actions; `rollout_fn` draws actions of the task's
  `action_bounds` shape inside them.  (lqr_2_1 with a before_step that
  doubles the action into the controls and records it in `model_var`.)"""
  base = suite.build_task('lqr', 'lqr_2_1', device='cpu')
  seen = []

  def before_step(m_, d, action):
    seen.append(action)
    return d.replace(ctrl=2 * action[:, :1],
                     model_var=dict(d.model_var or {}, last=action))

  task = dataclasses.replace(base, before_step=before_step,
                             action_bounds=lambda: ([-0.5, 0.0], [0.5, 0.25]))
  env = runner.BatchedEnv(task, 4, dtype=torch.float64)
  plain = runner.BatchedEnv(base, 4, dtype=torch.float64)
  state, ref = env.reset(seed=1), plain.reset(seed=1)
  action = torch.tensor([[0.1, 0.2], [-0.3, 0.0], [0.4, 0.1], [0.0, 0.05]],
                        dtype=torch.float64)
  state, (_, rew, _, _) = env.step(state, action)
  ref, (_, ref_rew, _, _) = plain.step(ref, 2 * action[:, :1])
  torch.testing.assert_close(state.data.qpos, ref.data.qpos, rtol=0, atol=0)
  torch.testing.assert_close(rew, ref_rew, rtol=0, atol=0)
  assert torch.equal(state.data.model_var['last'], action)
  gen = torch.Generator()
  gen.manual_seed(0)
  seen.clear()
  env.rollout_fn(3)(state, gen)
  drawn = torch.stack(seen)
  assert drawn.shape == (3, 4, 2)
  assert bool((drawn[..., 0].abs() <= 0.5).all())
  assert bool(((drawn[..., 1] >= 0) & (drawn[..., 1] <= 0.25)).all())
