"""The port's locomotion tier against the JAX package, float64 on the CPU.

  * Every task and walker: the composed MJCF (ElementTree text) and the
    compiled Model, field for field (the set_const outputs to 1e-12
    scaled), and the observables' names and per-lane shapes.
  * Ant go_to_target, run_through_corridor, random_goal_maze and escape:
    the JAX package's BatchedEnvironment is reset, its carry crosses the
    bridge (Data with its model_var, the ring buffers, the substep
    counters; not the key), and the same numpy actions drive both for 5
    control steps: qpos, qvel, every model_var key, every observation and
    the reward within TOL (1e-6 scaled by max(1, |ref|)), done equal,
    the buffers' counters equal.
  * The CMU humanoid (go_to_target) and the rodent (two_touch): from the
    same initial states (the JAX package's episode init plus numpy joint
    noise: 0.3 rad for the humanoid, 0.1 rad for the rodent), one forward
    and one physics step, then every observable and the reward, within
    TOL (the JAX package's whole rodent environment is not jitted: a
    minute of compile per build).
  * The rodent at the humanoid's 0.3 rad: one forward, the Newton solve's
    inputs within TOL and each side's solution within the solve's own
    stop criterion of the optimum's cost.  Its episode init already gives
    qacc ~1.5e5 and its limits pile up past that: there two solutions
    whose costs are 1e-10 (scaled) from the optimum's lie 1e-6 apart
    relative to qacc, which one step carries to qvel 3.6e-5 apart, so the
    step itself is compared at 0.1 rad.
  * two_touch's state machine and TargetSphere's latch on hand-made
    per-lane states, against the JAX package's hooks, exactly.
  * The episode inits: the deterministic parts exactly (the corridor's
    start, escape's hfield_data and height, two_touch's 0.06), the drawn
    parts by their ranges.
"""

import contextlib
import copy
import dataclasses
import functools
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dm_control_tpu._src import forward as jforward
from dm_control_tpu.composer import entity as jentity
from dm_control_tpu.locomotion import tasks as jtasks
from dm_control_tpu.locomotion import walkers as jwalkers
from dm_control_tpu_torch import bridge
from dm_control_tpu_torch._src import forward
from dm_control_tpu_torch.locomotion import arenas
from dm_control_tpu_torch.locomotion import tasks
from dm_control_tpu_torch.locomotion import walkers
from test_torch_domains import TOL, _fields, _scaled
from test_torch_model import SETCONST_FIELDS, _assert_same

# set_const's outputs, and the rodent's tendon_invweight0 (a solve at
# set_const, 4e-15 apart), held to 1e-12 scaled
SOLVED_FIELDS = SETCONST_FIELDS + ('tendon_invweight0',)

BATCH = 4
STEPS = 5

# name -> a function making the task from a package's tasks and walkers
# modules and the keyword arguments
CASES = {
    'go_to_target-ant': lambda t, w, **kw: t.go_to_target(**kw),
    'go_to_target-cmu': lambda t, w, **kw: t.go_to_target(
        walker=w.CMUHumanoid(), **kw),
    'go_to_target-rat': lambda t, w, **kw: t.go_to_target(
        walker=w.Rat(), **kw),
    'go_to_target-jumping_ball': lambda t, w, **kw: t.go_to_target(
        walker=w.JumpingBallWithHead(marker_rgba=(0.1, 0.2, 0.9, 1.0)), **kw),
    'random_goal_maze': lambda t, w, **kw: t.random_goal_maze(**kw),
    'escape': lambda t, w, **kw: t.escape(**kw),
    'two_touch': lambda t, w, **kw: t.two_touch(**kw),
    'run_through_corridor-empty': lambda t, w, **kw: t.run_through_corridor(
        'empty', **kw),
    'run_through_corridor-gaps': lambda t, w, **kw: t.run_through_corridor(
        'gaps', **kw),
    'run_through_corridor-walls': lambda t, w, **kw: t.run_through_corridor(
        'walls', **kw),
}
ANT_TASKS = ('go_to_target-ant', 'run_through_corridor-empty',
             'random_goal_maze', 'escape')


@contextlib.contextmanager
def _tasks_only():
  """Inside, the task functions of both packages return their
  ComposerTask instead of an environment."""
  saved = (jtasks.BatchedEnvironment, jtasks.Environment,
           tasks._environment)
  jtasks.BatchedEnvironment = jtasks.Environment = lambda task, *a, **k: task
  tasks._environment = lambda task, *a, **k: task
  try:
    yield
  finally:
    (jtasks.BatchedEnvironment, jtasks.Environment,
     tasks._environment) = saved


_TASKS = {}


def _task_pair(name):
  """(JAX ComposerTask, port ComposerTask) of case `name`, built once per
  process (the JAX package's set_const compiles for ~20 s per rodent)."""
  if name not in _TASKS:
    with _tasks_only():
      _TASKS[name] = (CASES[name](jtasks, jwalkers, batch_size=BATCH),
                      CASES[name](tasks, walkers, batch_size=BATCH,
                                  device='cpu', dtype=torch.float64))
  return _TASKS[name]


def _jax_composed(jtask):
  root = copy.deepcopy(jtask.arena.mjcf_root)
  for e, kw in jtask._attachments:
    jentity.attach(root, e, **kw)
  return root


@pytest.mark.parametrize('name', list(CASES))
def test_composed_model_matches_jax(name):
  jtask, task = _task_pair(name)
  assert ET.tostring(task.composed_root()) == ET.tostring(
      _jax_composed(jtask))
  jm, m = jtask.model, task.model
  for f in [f.name for f in dataclasses.fields(jm)]:
    a, b = getattr(jm, f), getattr(m, f)
    if f in SOLVED_FIELDS:
      a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
      err = np.abs(a - b) / np.maximum(1.0, np.abs(a))
      assert err.max(initial=0.0) <= 1e-12, f'{name} {f}: {err.max():.2e}'
    else:
      _assert_same(f'{name} {f}', a, b)
  assert list(task.observables) == list(jtask.observables)
  print(f'{name}: nv {m.nv} nu {m.nu} na {m.na} ngeom {m.ngeom}; '
        f'observables {list(task.observables)}')


# -- Ant rollouts from the JAX package's carry --------------------------------


@contextlib.contextmanager
def _jitted_forward():
  """The JAX BatchedEnvironment's constructor runs one forward eagerly
  (~30 s op by op for the Ant); inside, that forward is jitted."""
  eager = jforward.forward
  jforward.forward = lambda m, d: jax.jit(functools.partial(eager, m))(d)
  try:
    yield
  finally:
    jforward.forward = eager


def _carry_numpy(jcarry):
  jd, jobs, jsub, _ = jcarry
  obs_state = {n: {k: np.asarray(x) for k, x in st.items()}
               for n, st in jobs.items()}
  return _fields(jd), obs_state, np.asarray(jsub)


@pytest.mark.parametrize('name', ANT_TASKS)
def test_ant_rollout_matches_jax(name):
  with _jitted_forward():
    jenv = CASES[name](jtasks, jwalkers, batch_size=BATCH)
  env = CASES[name](tasks, walkers, batch_size=BATCH, device='cpu',
                    dtype=torch.float64)
  jcarry = jenv.reset(jax.random.PRNGKey(5))
  carry = bridge.composer_carry_from_numpy(*_carry_numpy(jcarry),
                                           device='cpu', dtype=torch.float64)
  assert set(carry.data.model_var) == set(jcarry[0].model_var or {})
  m = env.model
  rng = np.random.RandomState(11)
  actions = rng.uniform(-1, 1, (STEPS, BATCH, m.nu))
  errs, rows = {}, np.zeros(BATCH, bool)
  for t in range(STEPS):
    jcarry, (jobs, jrew, jdone) = jenv.step(jcarry, jnp.asarray(actions[t]))
    carry, (obs, rew, done) = env.step(carry, torch.tensor(actions[t]))
    jd, d = jcarry[0], carry.data
    ref = dict(qpos=jd.qpos, qvel=jd.qvel, reward=jrew,
               **{'obs.' + k: x for k, x in jobs.items()},
               **{'model_var.' + k: x for k, x in jd.model_var.items()})
    out = dict(qpos=d.qpos, qvel=d.qvel, reward=rew,
               **{'obs.' + k: x for k, x in obs.items()},
               **{'model_var.' + k: x for k, x in d.model_var.items()})
    assert out.keys() == ref.keys()
    for k in ref:
      assert tuple(out[k].shape) == np.shape(ref[k]), (k, t)
      errs[k] = max(errs.get(k, 0.0), _scaled(out[k].numpy(), ref[k]))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert not done.any()
    np.testing.assert_array_equal(carry.substep.numpy(),
                                  np.asarray(jcarry[2]))
    for n, st in carry.obs_state.items():
      for k in ('visible_at', 'write_idx'):
        np.testing.assert_array_equal(st[k].numpy(),
                                      np.asarray(jcarry[1][n][k]))
    rows |= d.efc_active.any(dim=1).numpy()
  print(f'{name}: max scaled err over {STEPS} control steps: '
        + ', '.join(f'{k} {e:.2e}' for k, e in errs.items()))
  assert all(e <= TOL for e in errs.values()), errs
  assert rows.all(), f'{name}: a lane had no constraint row'


# -- the CMU humanoid and the rodent: one step from the same state ------------


def _noisy_states(jtask, task, noise):
  """(JAX Data, port Data) of BATCH lanes: the JAX package's episode init
  of `jtask`, plus numpy joint noise of `noise` rad, velocities of twice
  that, activations and controls; neither run forward."""
  jm, m = jtask.model, task.model
  keys = jax.random.split(jax.random.PRNGKey(2), BATCH)
  d0 = jforward.make_data(jm)
  jd = jax.vmap(lambda k: jtask.init_episode(jm, d0, k))(keys)
  rng = np.random.RandomState(3)
  qpos = np.array(jd.qpos)
  hinges = [int(jm.jnt_qposadr[j]) for j in range(jm.njnt)
            if int(jm.jnt_type[j]) == 3]
  qpos[:, hinges] += rng.uniform(-noise, noise, (BATCH, len(hinges)))
  qvel = rng.uniform(-noise, noise, (BATCH, jm.nv)) * 2
  act = rng.uniform(0, 0.5, (BATCH, jm.na))
  ctrl = rng.uniform(-1, 1, (BATCH, jm.nu))
  model_var = {k: np.asarray(x) for k, x in jd.model_var.items()}
  jd = jd.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                  act=jnp.asarray(act), ctrl=jnp.asarray(ctrl))
  d = forward.make_data(m, BATCH, torch.float64, 'cpu').replace(
      qpos=torch.tensor(qpos), qvel=torch.tensor(qvel), act=torch.tensor(act),
      ctrl=torch.tensor(ctrl),
      model_var={k: torch.tensor(x) for k, x in model_var.items()})
  return jd, d


@pytest.mark.parametrize('name,noise', [('go_to_target-cmu', 0.3),
                                        ('two_touch', 0.1)])
def test_walker_step_and_observables_match_jax(name, noise):
  jtask, task = _task_pair(name)
  jm, m = jtask.model, task.model
  jd, d = _noisy_states(jtask, task, noise)
  jd = jax.jit(jax.vmap(lambda d: jforward.step(jm, jforward.forward(
      jm, d))))(jd)
  jobs = {k: jax.vmap(lambda d, f=s.fn: f(jm, d))(jd)
          for k, s in jtask.observables.items()}
  jrew = jax.vmap(lambda d: jtask.get_reward(jm, d))(jd)

  d = forward.step(m, forward.forward(m, d))
  obs = {k: s.fn(m, d) for k, s in task.observables.items()}
  rew = task.get_reward(m, d)
  ref = dict(qpos=jd.qpos, qvel=jd.qvel, act=jd.act, reward=jrew,
             sensordata=jd.sensordata,
             **{'obs.' + k: x for k, x in jobs.items()})
  out = dict(qpos=d.qpos, qvel=d.qvel, act=d.act, reward=rew,
             sensordata=d.sensordata,
             **{'obs.' + k: x for k, x in obs.items()})
  assert out.keys() == ref.keys()
  errs = {}
  for k in ref:
    assert tuple(out[k].shape) == np.shape(ref[k]), k
    errs[k] = _scaled(out[k].numpy(), ref[k])
  print(f'{name}: nv {m.nv}, active rows per lane '
        f'{d.efc_active.sum(dim=1).tolist()}; max scaled err '
        + ', '.join(f'{k} {e:.2e}' for k, e in errs.items()))
  assert all(e <= TOL for e in errs.values()), errs
  assert bool(d.efc_active.any(dim=1).all())


def test_rodent_solve_at_wide_noise_stops_as_jax():
  """two_touch's rodent at the humanoid's 0.3 rad of joint noise, one
  forward on each side: the Newton solve's inputs within TOL (its active
  rows equal), and each side's float64 solution within the solve's own
  stop criterion of the optimum's cost, scale * (cost(qacc) - cost(x*))
  within opt.tolerance (scale 1 / (meaninertia * nv), the solver's); x*
  the port's plain float64 solve of the same inputs from the port's
  qacc, run until a step no longer improves the cost."""
  import chip_smoke
  from dm_control_tpu_torch._src import efc
  from dm_control_tpu_torch._src import solver
  from dm_control_tpu_torch.ops import newton_kernel as nk
  jtask, task = _task_pair('two_touch')
  jm, m = jtask.model, task.model
  jd, d = _noisy_states(jtask, task, 0.3)
  jd = jax.jit(jax.vmap(lambda d: jforward.forward(jm, d)))(jd)
  d = forward.forward(m, d)
  errs = {f: _scaled(getattr(d, f).numpy(), getattr(jd, f))
          for f in ('qM', 'qacc_smooth', 'efc_J', 'efc_aref', 'efc_D',
                    'efc_frictionloss')}
  assert all(e <= TOL for e in errs.values()), errs
  np.testing.assert_array_equal(d.efc_active.numpy(),
                                np.asarray(jd.efc_active))
  lay = efc.layout(m)
  args = (d.efc_J, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss,
          d.efc_active.double(), d.qacc_smooth)
  x_star, _ = nk.newton_solve_plain(
      *args, d.qacc, types=lay.types, ell_groups=lay.ell_groups,
      niter=1000, ls_iter=solver.LS_ITERATIONS, tol=1e-15,
      meaninertia=float(m.stat_meaninertia))
  scale = 1.0 / (float(m.stat_meaninertia) * m.nv)
  optimum = chip_smoke.solve_cost(lay, *args, x_star)[0]
  gaps = {side: scale * (chip_smoke.solve_cost(lay, *args, x)[0] - optimum)
          for side, x in (('port', d.qacc),
                          ('jax', torch.tensor(np.asarray(jd.qacc))))}
  print('two_touch at 0.3 rad: inputs ' + ', '.join(
      f'{k} {e:.2e}' for k, e in errs.items()) + '; scaled cost over the '
      'optimum ' + ', '.join(f'{k} {g.tolist()}' for k, g in gaps.items())
      + f'; qacc apart {_scaled(d.qacc.numpy(), jd.qacc):.2e}')
  for side, g in gaps.items():
    assert bool((g.abs() <= float(m.opt.tolerance)).all()), (side, g)


# -- two_touch's machine and TargetSphere's latch ------------------------------


def _touch_states(jm, m):
  """Hand-made lanes: every (state, time since entry, hand near or far)
  combination, with the target at per-lane positions; returns the JAX
  and the port Data (forward-free: only what the hooks read is set)."""
  states = np.arange(5.0)
  since = np.array([0.3, 0.65, 0.75, 0.8, 0.85, 0.95, 1.1, 1.3])
  grid = np.array(np.meshgrid(states, since, [0, 1], indexing='ij')
                  ).reshape(3, -1).T
  B = len(grid)
  rng = np.random.RandomState(4)
  g = jm.name2id('geom', 'target/target')
  geom_pos = np.tile(np.asarray(jm.geom_pos), (B, 1, 1))
  geom_pos[:, g, :2] = rng.uniform(-0.3, 0.3, (B, 2))
  time = rng.uniform(2.0, 3.0, B)
  tt = np.stack([grid[:, 0], time - grid[:, 1], rng.uniform(0, 1, B)], -1)
  xpos = rng.uniform(-1, 1, (B, jm.nbody, 3))
  hand = jm.name2id('body', 'walker/hand_L')
  offset = np.where(grid[:, 2:] > 0, 0.05, 0.5) * np.array([0.6, 0.0, 0.8])
  xpos[:, hand] = geom_pos[:, g] + offset
  for b in ('walker/hand_R',):
    xpos[:, jm.name2id('body', b)] = geom_pos[:, g] + 0.5
  latch = (rng.uniform(0, 1, B) > 0.5).astype(np.float64)
  rgba = np.tile(np.asarray(jm.geom_rgba), (B, 1, 1))
  mv = dict(geom_pos=geom_pos, tt_state=tt, target_activated=latch,
            geom_rgba=rgba)
  d0 = jforward.make_data(jm)
  jd = jax.vmap(lambda x, t, v: d0.replace(xpos=x, time=t, model_var=v))(
      jnp.asarray(xpos), jnp.asarray(time),
      {k: jnp.asarray(x) for k, x in mv.items()})
  d = forward.make_data(m, B, torch.float64, 'cpu').replace(
      xpos=torch.tensor(xpos), time=torch.tensor(time),
      model_var={k: torch.tensor(x) for k, x in mv.items()})
  return jd, d


def test_two_touch_machine_and_latch_match_jax():
  jtask, task = _task_pair('two_touch')
  jm, m = jtask.model, task.model
  jd, d = _touch_states(jm, m)
  for stage in ('after_step',):
    jhooks, hooks = jtask.step_hooks(stage), task.step_hooks(stage)
    assert [p for _, p in hooks] == [p for _, p in jhooks]
    for (jfn, prefix), (fn, _) in zip(jhooks, hooks):
      jout = jax.vmap(lambda x, f=jfn, p=prefix: f(
          jm, x, jax.random.PRNGKey(0), p))(jd)
      out = fn(m, d, torch.Generator(), prefix)
      assert set(out.model_var) == set(jout.model_var)
      for k, x in out.model_var.items():
        np.testing.assert_array_equal(x.numpy(), np.asarray(
            jout.model_var[k]), err_msg=f'{prefix} {k}')
  new = task.step_hooks('after_step')[0][0](m, d, None, None).model_var
  visited = set(zip(d.model_var['tt_state'][:, 0].tolist(),
                    new['tt_state'][:, 0].tolist()))
  # every transition of the machine is taken on some lane
  assert {(0.0, 1.0), (1.0, 2.0), (1.0, 3.0), (1.0, 4.0), (2.0, 0.0),
          (3.0, 0.0), (4.0, 0.0), (1.0, 1.0)} <= visited, visited
  assert set(new['tt_state'][:, 2].tolist()) == {0.0, 0.2, 1.0}
  jrew = jax.vmap(lambda x: jtask.get_reward(jm, x))(jd)
  np.testing.assert_array_equal(task.get_reward(m, d).numpy(),
                                np.asarray(jrew))


# -- episode inits ----------------------------------------------------------------


@pytest.mark.parametrize('name', ['run_through_corridor-empty', 'escape',
                                  'two_touch', 'go_to_target-ant',
                                  'random_goal_maze',
                                  'go_to_target-jumping_ball'])
def test_episode_init_matches_jax(name):
  jtask, task = _task_pair(name)
  jm, m = jtask.model, task.model
  n = 64
  keys = jax.random.split(jax.random.PRNGKey(9), n)
  d0 = jforward.make_data(jm)
  jd = jax.vmap(lambda k: jtask.init_episode(jm, d0, k))(keys)
  gen = torch.Generator().manual_seed(9)
  d = task.init_episode(m, forward.make_data(m, n, torch.float64, 'cpu'), gen)
  assert set(d.model_var) == set(jd.model_var or {})
  for k, x in d.model_var.items():
    assert tuple(x.shape) == np.shape(jd.model_var[k]), k
  jq, q = np.asarray(jd.qpos), d.qpos.numpy()
  root = 'walker/root' if 'walker/root' in m.names['joint'] else (
      'walker/root_x')
  r = int(m.jnt_qposadr[m.name2id('joint', root)])
  drawn = {'go_to_target-ant': r + np.array([0, 1, 3, 4, 5, 6]),
           'go_to_target-jumping_ball': r + np.arange(2),
           'random_goal_maze': r + np.arange(2)}.get(name, [])
  fixed = np.setdiff1d(np.arange(m.nq), drawn)
  np.testing.assert_array_equal(q[:, fixed], jq[:, fixed])
  if name == 'escape':
    np.testing.assert_array_equal(d.model_var['hfield_data'].numpy(),
                                  np.asarray(jd.model_var['hfield_data']))
    assert bool((d.qpos[:, r + 2] == 0.7).all())
  if name == 'two_touch':
    assert bool((d.qpos[:, r + 2] == 0.06).all())
    for k in ('tt_state', 'target_activated', 'geom_rgba'):
      np.testing.assert_array_equal(d.model_var[k].numpy(),
                                    np.asarray(jd.model_var[k]))
  if name == 'run_through_corridor-empty':
    assert bool((d.qpos[:, r] == 1.0).all() and (d.qpos[:, r + 1] == 0).all())
  if 'geom_pos' in d.model_var:
    g = m.name2id('geom', 'target/target' if name == 'two_touch'
                  else 'target')
    gp, jgp = d.model_var['geom_pos'].numpy(), np.asarray(
        jd.model_var['geom_pos'])
    others = np.setdiff1d(np.arange(m.ngeom), [g])
    np.testing.assert_array_equal(gp[:, others], jgp[:, others])
    np.testing.assert_array_equal(gp[:, g, 2], jgp[:, g, 2])
    lo, hi = jgp[:, g, :2].min(0), jgp[:, g, :2].max(0)
    bound = {'two_touch': [0.3, 0.6]}.get(name, [6.0, 6.0])
    assert np.all(np.abs(gp[:, g, :2]) <= bound), name
    if name == 'random_goal_maze':
      cells = {tuple(c) for c in arenas.maze(n_cells=5, seed=0)[1]}
      spawn, goal = q[:, r:r + 2], gp[:, g, :2]
      assert {tuple(c) for c in spawn} | {tuple(c) for c in goal} <= cells
      assert (spawn != goal).any(axis=1).all()
    assert (hi - lo > 0).all()
  if name == 'go_to_target-ant':
    assert np.all(np.abs(q[:, r:r + 2]) <= 6.0)
    np.testing.assert_allclose(np.linalg.norm(q[:, r + 3:r + 7], axis=1), 1.0,
                               atol=1e-12)
    np.testing.assert_array_equal(q[:, r + 4:r + 6], 0.0)


# -- chip_smoke.py's launch counts ------------------------------------------------


@pytest.mark.parametrize('name', ['go_to_target-ant', 'two_touch'])
def test_composer_launch_counts(name, monkeypatch):
  """The launches `chip_smoke.composer_launches` and `composer_core_calls`
  expect per control step (and `reset_launches` per auto-reset), counted
  on the CPU with every kernel wrapper replaced by its plain version and
  a counter, over the episode limit of phase composer's reset run
  (`COMPOSER_LIMITS`), whose last step ends every episode."""
  import chip_smoke
  from dm_control_tpu_torch.ops import linalg_kernel as lk
  from dm_control_tpu_torch.ops import newton_kernel as nk
  for k, plain in chip_smoke.K1_PLAIN.items():
    def counting(*a, _k=k, _p=getattr(lk, plain)):
      lk.LAUNCHES[_k] += 1
      return _p(*a)
    monkeypatch.setattr(lk, k, counting)

  def solve(*args, lay, **kw):
    nk.LAUNCHES['newton_solve_ell' if lay.ell_groups
                else 'newton_solve_batched'] += 1
    return nk.newton_solve_plain(*args, types=lay.types,
                                 ell_groups=lay.ell_groups, **kw)

  monkeypatch.setattr(nk, 'newton_solve_batched', solve)
  limit, control_dt = chip_smoke.COMPOSER_LIMITS[name]
  env = chip_smoke.composer_env(name, 2, time_limit=limit * control_dt,
                                device='cpu')
  carry = env.reset(seed=0)
  per_step = chip_smoke.composer_launches(env)
  calls = chip_smoke.composer_core_calls(env)
  per_reset = chip_smoke.reset_launches(env)
  zero = torch.zeros((2, env.model.nu))
  for t in range(limit):
    last = t == limit - 1
    lk.reset_launches()
    nk.reset_launches()
    carry, (_, _, done) = env.step(carry, zero)
    assert bool(done.all()) == last
    want = {k: v + (per_reset[k] if last else 0) for k, v in per_step.items()}
    want['chol_solve_batched'] += nk.CORE_LOOPS['loops']
    assert dict(lk.LAUNCHES, **nk.LAUNCHES) == want, (name, t)
    assert nk.CORE_LOOPS['calls'] == calls + (1 if calls and last else 0)
  assert (calls > 0) == (name == 'two_touch')
