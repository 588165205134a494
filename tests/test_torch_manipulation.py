"""The port's manipulation tier against the JAX package, float64 on the CPU.

  * Every `_features` task: the composed MJCF (ElementTree text, mesh
    file paths taken relative to each package's assets), the compiled
    Model field for field (set_const's outputs to 1e-12 scaled), the
    contact groups with their K, and the observables' names.
  * Every `_features` task's episode init under injected draws: the JAX
    package's init hook runs with its keys, the numbers it drew are drawn
    again from the same keys (`_jax_draws`, its key splits replicated) and
    given to the port's `apply`; qpos and every model_var key within
    INIT_TOL (1e-12 scaled), `duplo_order` equal.
  * Every `_features` task's reward and observables from the JAX state
    carried over by the bridge (after kinematics; the first lanes with the
    bricks clicked in the hints' stack, or the prop raised), within TOL.
  * reach_site, place_cradle, stack_2_bricks and reassemble_5: the JAX
    package's init plus numpy arm noise, its forward, its carry (Data and
    observation buffers) across `bridge.composer_carry_from_numpy`, then 5
    physics steps (`forward.step` and the after_substep hooks: the brick
    pin), each from the JAX package's state before it.  At each of a
    step's four RK4 acc stages the active rows equal, the solver inputs
    (their active rows) within TOL on the lanes whose earlier stages
    agree within SAME_TOL, and both packages' float64 solutions within STOP_UNITS of
    the optimum's cost (`_stop_gaps`); qpos within TOL; qvel, the reward
    and every observable within TOL on the lanes whose stage solutions
    agree within TOL.  The bricks' stiff contacts leave the cost flat
    along some directions, where two float64 solves that both reach the
    optimum's cost stop apart: the JAX package's line search, which the
    port's float64 solve departs from (ROADMAP queue 3, item 8), stops
    1e-6 to 1e-5 (scaled qacc) from the port's on some lanes of reach_site,
    stack_2 and reassemble_5, and the port against itself from the JAX
    package's forward and from its own (1e-12 apart in efc_J and
    efc_aref) ends a stack_2 step 4.5e-7 apart in qacc; chained over 5
    steps the packages drift to 1.8e-5 in qvel.
  * `pin_project` against the JAX package's, and holding the pinned brick
    fixed over substeps; `stack_poses` clicked at STACK_DZ for both flip
    branches, against the JAX package's poses.
  * The registry's 25 names and tags, `_vision` raising.
  * chip_smoke.py's launch counts for the manipulation phase, counted on
    the CPU with every kernel wrapper replaced by its plain version.
"""

import contextlib
import copy
import dataclasses
import os
import types
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dm_control_tpu.manipulation as jmanipulation
from dm_control_tpu._src import collision as jcollision
from dm_control_tpu._src import forward as jforward
from dm_control_tpu._src import smooth as jsmooth
from dm_control_tpu.composer import entity as jentity
from dm_control_tpu.composer import observation as jobservation
from dm_control_tpu.manipulation import bricks as jbricks
from dm_control_tpu.manipulation import tasks as jtasks
from dm_control_tpu.suite import common as jcommon
import dm_control_tpu_torch.manipulation as manipulation
from dm_control_tpu_torch import bridge
from dm_control_tpu_torch._src import collision
from dm_control_tpu_torch._src import forward
from dm_control_tpu_torch._src import smooth
from dm_control_tpu_torch.composer.observation import ObservationPipeline
from dm_control_tpu_torch.entities import duplo
from dm_control_tpu_torch.manipulation import tasks
from dm_control_tpu_torch.suite import common
from test_torch_domains import TOL, _fields, _scaled
from test_torch_model import SETCONST_FIELDS, _assert_same

FEATURES = tuple(n for n in jmanipulation.ALL if n.endswith('_features'))
STEPPED = ('reach_site_features', 'place_cradle_features',
           'stack_2_bricks_features',
           'reassemble_5_bricks_random_order_features')
BATCH = 4
STEPS = 5
INIT_TOL = 1e-12
# a float64 solution's cost may stand this many units (`_stop_gaps`) above
# the optimum's: its solve's stop criterion, or float64 roundings of the
# cost, as the reference gate's BAND counts float32 roundings
STOP_UNITS = 64
# stage solutions this close (scaled qacc) make the next stage's inputs
# equal within TOL
SAME_TOL = 1e-9
EPS64 = float(np.finfo(np.float64).eps)


@contextlib.contextmanager
def _tasks_only():
  """Inside, the task functions of both packages return their
  ComposerTask instead of an environment."""
  saved = (jtasks._env, jtasks.make_env, tasks._env, tasks.make_env)
  jtasks._env = jtasks.make_env = lambda task, *a, **k: task
  tasks._env = tasks.make_env = lambda task, *a, **k: task
  try:
    yield
  finally:
    (jtasks._env, jtasks.make_env, tasks._env, tasks.make_env) = saved


_TASKS = {}


def _task_pair(name):
  """(JAX ComposerTask, port ComposerTask) of `name`, built once per
  process."""
  if name not in _TASKS:
    with _tasks_only():
      _TASKS[name] = (jtasks.REGISTRY[name](batch_size=BATCH),
                      tasks.REGISTRY[name](batch_size=BATCH, device='cpu'))
  return _TASKS[name]


def _relative_files(root, assets):
  root = copy.deepcopy(root)
  for el in root.iter():
    if 'file' in el.attrib:
      el.set('file', os.path.relpath(el.attrib['file'], assets))
  return ET.tostring(root)


def _jax_composed(jtask):
  root = copy.deepcopy(jtask.arena.mjcf_root)
  for e, kw in jtask._attachments:
    jentity.attach(root, e, **kw)
  return root


@pytest.mark.parametrize('name', FEATURES)
def test_composed_model_matches_jax(name):
  jtask, task = _task_pair(name)
  assert _relative_files(task.composed_root(), common.ASSETS_DIR) == (
      _relative_files(_jax_composed(jtask),
                      os.path.dirname(jcommon.model_path('x'))))
  jm, m = jtask.model, task.model
  for f in [f.name for f in dataclasses.fields(jm)]:
    a, b = getattr(jm, f), getattr(m, f)
    if f in SETCONST_FIELDS:
      a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
      err = np.abs(a - b) / np.maximum(1.0, np.abs(a))
      assert err.max(initial=0.0) <= 1e-12, f'{name} {f}: {err.max():.2e}'
    else:
      _assert_same(f'{name} {f}', a, b)
  groups = [(int(g.t1), int(g.t2), g.condim, g.npairs, g.K,
             g.g1.tolist(), g.g2.tolist()) for g in collision.groups(m)]
  assert groups == [(int(g.t1), int(g.t2), g.condim, g.npairs, g.K,
                     g.g1.tolist(), g.g2.tolist())
                    for g in jcollision.groups(jm)]
  assert list(task.observables) == list(jtask.observables)
  print(f'{name}: nv {m.nv} ngeom {m.ngeom}; groups (types, condim, '
        f'pairs, K) {[g[:5] for g in groups]}')


# -- episode inits under injected draws ---------------------------------------


def _uniform(k, shape, lo, hi):
  return jax.random.uniform(k, shape, jnp.float64, jnp.asarray(lo, jnp.float64),
                            jnp.asarray(hi, jnp.float64))


def _prop_draws(k):
  k1, k2 = jax.random.split(k)
  return dict(xy=_uniform(k1, (2,), -0.1, 0.1),
              theta=_uniform(k2, (), -jnp.pi, jnp.pi))


def _jax_draws(name, jtask, keys):
  """{name: (B, ...) numpy} of the numbers the JAX package's init hook of
  task `name` draws from each lane's key, in the port's `draw` layout."""
  n = sum(1 for e, _ in jtask._attachments if e.name.startswith('brick')
          and e.name != 'brickpin')
  lo, hi = jbricks._PROP_BBOX_LO, jbricks._PROP_BBOX_HI

  def one(key):
    # the task's init hook takes the second half of a split of the lane's
    # key (ComposerTask.init_episode)
    key = jax.random.split(key)[1]
    if name == 'reach_site_features':
      return dict(target=_uniform(key, (3,), (-0.2, -0.2, 0.02),
                                  (0.2, 0.2, 0.4)))
    if name.startswith(('reach_duplo', 'lift')):
      return _prop_draws(key)
    if name.startswith('place'):
      k1, k2 = jax.random.split(key)
      return dict(_prop_draws(k1), pedestal=_uniform(
          k2, (3,), [-0.1, -0.1, 0.07], [0.1, 0.1, 0.17]))
    if name.startswith('stack'):
      cfg = jtasks.REGISTRY[name].keywords
      k1, k2, k3 = jax.random.split(key, 3)
      s1, s2 = jax.random.split(k2)
      order = (jax.random.permutation(k1, n) if cfg['randomize_order']
               else jnp.arange(n))
      return dict(order=order, xy=_uniform(s1, (20, n, 2), lo[:2], hi[:2]),
                  theta=_uniform(s2, (n,), -jnp.pi, jnp.pi),
                  hint_flips=jax.random.bernoulli(
                      k3, 0.5, (cfg['target_height'],)))
    cfg = jtasks.REGISTRY[name].keywords
    k1, k2, k3, k4 = jax.random.split(key, 4)
    b1, b2, b3 = jax.random.split(k3, 3)
    out = dict(
        initial=(jax.random.permutation(k1, n)
                 if cfg['randomize_initial_order'] else jnp.arange(n)),
        base_pos=_uniform(b1, (3,), lo, hi),
        theta=_uniform(b2, (), -jnp.pi, jnp.pi),
        stack_flips=jax.random.bernoulli(b3, 0.5, (n,)),
        hint_flips=jax.random.bernoulli(k4, 0.5, (n,)))
    if cfg['randomize_desired_order']:
      out['tail'] = jax.random.permutation(k2, n - 1)
    return out

  return {k: np.asarray(v) for k, v in jax.jit(jax.vmap(one))(keys).items()}


def _port_init(task, m, draws):
  """The port's episode init of `task` from the given draws."""
  d = forward.make_data(m, len(next(iter(draws.values()))), torch.float64,
                        'cpu')
  (init,) = task._init_fns
  return init.apply(m, d, {k: torch.tensor(v) for k, v in draws.items()})


def _jax_inits(jtask, keys):
  jm = jtask.model
  d0 = jforward.make_data(jm)
  return jax.jit(jax.vmap(lambda k: jtask.init_episode(jm, d0, k)))(keys)


def _clicked(name, jm, jd):
  """numpy qpos of the JAX init states `jd` with lane 0's bricks moved
  into the goal hints' clicked stack (brick i at hint i's pose), or the
  lifted prop raised 0.35 m, or the brick on the pedestal's target."""
  qpos = np.array(jd.qpos)
  mv = {k: np.asarray(x) for k, x in jd.model_var.items()}
  if 'hint0/hint0' in jm.names['body']:
    for i in range(10):
      if f'brick{i}/brick{i}_root' not in jm.names['joint']:
        break
      a = int(jm.jnt_qposadr[jm.name2id('joint', f'brick{i}/brick{i}_root')])
      b = jm.name2id('body', f'hint{i}/hint{i}')
      if mv['body_pos'][0, b, 2] >= 0:        # a hint in use
        qpos[0, a:a + 3] = mv['body_pos'][0, b]
        qpos[0, a + 3:a + 7] = mv['body_quat'][0, b]
  elif name.startswith(('lift', 'place')):
    p = 'box' if 'large_box' in name else 'brick0'
    a = int(jm.jnt_qposadr[jm.name2id('joint', f'{p}/{p}_root')])
    if name.startswith('lift'):
      qpos[0, a + 2] += 0.35
    else:
      qpos[0, a:a + 3] = mv['body_pos'][0, jm.name2id(
          'body', 'pedestal/pedestal')]
  return qpos


@pytest.mark.parametrize('name', FEATURES)
def test_episode_init_reward_and_observables_match_jax(name):
  jtask, task = _task_pair(name)
  jm, m = jtask.model, task.model
  keys = jax.random.split(jax.random.PRNGKey(9), BATCH)
  jd = _jax_inits(jtask, keys)
  draws = _jax_draws(name, jtask, keys)
  d = _port_init(task, m, draws)
  assert set(d.model_var) == set(jd.model_var)
  errs = {'qpos': _scaled(d.qpos.numpy(), jd.qpos)}
  for k, x in d.model_var.items():
    ref = np.asarray(jd.model_var[k])
    assert tuple(x.shape) == ref.shape, k
    if k == 'duplo_order':
      assert x.dtype == torch.int32
      np.testing.assert_array_equal(x.numpy(), ref)
    else:
      errs['model_var.' + k] = _scaled(x.numpy(), ref)
  assert all(e <= INIT_TOL for e in errs.values()), errs

  # reward and observables from the JAX state carried over, kinematics run
  jd = jax.jit(jax.vmap(lambda d: jsmooth.kinematics(jm, d)))(
      jd.replace(qpos=jnp.asarray(_clicked(name, jm, jd))))
  jobs = {k: jax.vmap(lambda d, f=s.fn: f(jm, d))(jd)
          for k, s in jtask.observables.items()}
  jrew = jax.vmap(lambda d: jtask.get_reward(jm, d))(jd)
  d = bridge.data_from_numpy(_fields(jd), 'cpu', torch.float64)
  obs = {k: s.fn(m, d) for k, s in task.observables.items()}
  assert obs.keys() == jobs.keys()
  out = dict(reward=task.get_reward(m, d).numpy(),
             **{'obs.' + k: x.numpy() for k, x in obs.items()})
  for k, x in out.items():
    ref = jrew if k == 'reward' else jobs[k[4:]]
    assert x.shape == np.shape(ref), k
    errs[k] = _scaled(x, ref)
  print(f'{name}: rewards {np.round(np.asarray(jrew), 4).tolist()}; max '
        f'scaled err ' + ', '.join(f'{k} {e:.2e}' for k, e in errs.items()))
  assert all(e <= TOL for e in errs.values()), errs
  if name.startswith(('stack', 'reassemble', 'lift', 'place')):
    assert float(jrew[0]) > 0.5 > float(np.asarray(jrew)[1:].min()), name


def test_init_draws_of_the_port():
  """The port's own draws (its generator) make inits of the JAX shapes:
  permutations, flips, ranges; scatter keeps separated layouts."""
  _, task = _task_pair('reassemble_5_bricks_random_order_features')
  m = task.model
  d = forward.make_data(m, 64, torch.float64, 'cpu')
  (init,) = task._init_fns
  draws = init.draw(d, torch.Generator().manual_seed(0))
  assert sorted(draws) == ['base_pos', 'hint_flips', 'initial',
                           'stack_flips', 'tail', 'theta']
  for k in ('initial', 'tail'):
    assert (draws[k].sort(1).values == torch.arange(
        draws[k].shape[1])).all()
  d = init.apply(m, d, draws)
  order = d.model_var['duplo_order']
  assert (order[:, 0] == draws['initial'][:, 0].int()).all()
  pin = d.model_var['duplo_pin']
  assert (pin.sum(1) == 1).all()
  _, task = _task_pair('stack_2_of_3_bricks_random_order_features')
  (init,) = task._init_fns
  d = forward.make_data(task.model, 64, torch.float64, 'cpu')
  draws = init.draw(d, torch.Generator().manual_seed(1))
  d = init.apply(task.model, d, draws)
  assert d.model_var['duplo_order'].shape == (64, 2)
  bs_q = [int(task.model.jnt_qposadr[task.model.name2id(
      'joint', f'brick{i}/brick{i}_root')]) for i in range(3)]
  xy = torch.stack([d.qpos[:, a:a + 2] for a in bs_q], 1)
  sep = (xy[:, :, None] - xy[:, None]).norm(dim=-1) + torch.eye(3) * 1e3
  assert float(sep.amin()) > 0.075
  assert float(xy.abs().max()) <= 0.1
  # the unused hint is parked below the table
  hint_z = d.model_var['body_pos'][:, [task.model.name2id(
      'body', f'hint{i}/hint{i}') for i in range(3)], 2]
  assert ((hint_z < 0).sum(1) == 1).all()


# -- physics steps from the JAX carry --------------------------------------------


def _arm_noise(jm, qpos, rng, noise=0.3):
  arm = [int(jm.jnt_qposadr[j]) for j in range(jm.njnt)
         if (jm.id2name('joint', j) or '').startswith('jaco/')]
  qpos = qpos.copy()
  qpos[:, arm] += rng.uniform(-noise, noise, (qpos.shape[0], len(arm)))
  return qpos


_STAGE_FIELDS = ('efc_J', 'qM', 'efc_aref', 'efc_D', 'efc_frictionloss',
                 'qacc_smooth')


def _stop_gaps(m, stage, qaccs):
  """Each of `qaccs`' cost over the optimum of one acc stage's solver
  inputs (the port's `stage` Data), in units of the larger of the solve's
  own stop criterion (tolerance / scale, scale 1 / (meaninertia * nv), the
  solver's) and one float64 rounding of the cost (EPS64 times
  `chip_smoke.solve_cost`'s rounding scale): x* is the port's plain
  float64 solve of those inputs from the port's qacc, run until a step no
  longer improves the cost."""
  import chip_smoke
  from dm_control_tpu_torch._src import efc
  from dm_control_tpu_torch._src import solver
  from dm_control_tpu_torch.ops import newton_kernel as nk
  lay = efc.layout(m)
  args = tuple(getattr(stage, f) for f in _STAGE_FIELDS[:5]) + (
      stage.efc_active.double(), stage.qacc_smooth)
  x_star, _ = nk.newton_solve_plain(
      *args, stage.qacc, types=lay.types, ell_groups=lay.ell_groups,
      niter=1000, ls_iter=solver.LS_ITERATIONS, tol=1e-15,
      meaninertia=float(m.stat_meaninertia))
  optimum, o_scale = chip_smoke.solve_cost(lay, *args, x_star)
  stop = float(m.opt.tolerance) * float(m.stat_meaninertia) * m.nv
  out = []
  for x in qaccs:
    c, c_scale = chip_smoke.solve_cost(lay, *args, x)
    unit = torch.clamp(EPS64 * (c_scale + o_scale), min=stop)
    out.append((c - optimum) / unit)
  return out


@pytest.mark.parametrize('name', STEPPED)
def test_steps_from_the_jax_carry_match_jax(name):
  import chip_smoke
  jtask, task = _task_pair(name)
  jm, m = jtask.model, task.model
  keys = jax.random.split(jax.random.PRNGKey(5), BATCH)
  jd = _jax_inits(jtask, keys)
  rng = np.random.RandomState(6)
  lo, hi = np.asarray(jm.actuator_ctrlrange).T
  ctrl = rng.uniform(lo, hi, (BATCH, jm.nu))
  jd = jd.replace(qpos=jnp.asarray(_arm_noise(jm, _clicked(name, jm, jd),
                                              rng)),
                  qvel=jnp.asarray(rng.uniform(-0.2, 0.2, (BATCH, jm.nv))),
                  ctrl=jnp.asarray(ctrl))
  jhooks = jtask.step_hooks('after_substep')
  hooks = task.step_hooks('after_substep')
  assert [p for _, p in hooks] == [p for _, p in jhooks]
  jfwd = jax.jit(jax.vmap(lambda d: jforward.forward(jm, d)))

  def jstep(d):
    """The JAX package's step and hooks, with the solver inputs and qacc of
    its four acc stages (`_acc_stage` recorded while the step traces: the
    step's own, then one per `_forward_core` of its rk4)."""
    stages, acc_stage = [], jforward._acc_stage

    def recorded(*a, **k):
      out = acc_stage(*a, **k)
      stages.append({f: getattr(out, f)
                     for f in _STAGE_FIELDS + ('efc_active', 'qacc')})
      return out

    jforward._acc_stage = recorded
    try:
      d = jforward.step(jm, d)
    finally:
      jforward._acc_stage = acc_stage
    for fn, prefix in jhooks:
      d = fn(jm, d, jax.random.PRNGKey(0), prefix)
    return d, jtask.get_reward(jm, d), {
        k: s.fn(jm, d) for k, s in jtask.observables.items()}, stages

  jstep = jax.jit(jax.vmap(jstep))
  jd0 = jfwd(jd)
  # the carry: the forward-synced Data and the observation buffers updated
  # at substep 0, as the JAX BatchedEnvironment's reset makes them
  jpipe = jobservation.ObservationPipeline(
      jm, jtask.observables, jax.tree_util.tree_map(lambda x: x[0], jd0))
  jobs_state = jax.vmap(lambda d: jpipe.update(
      jpipe.init_state(), d, jnp.zeros((), jnp.int32),
      jax.random.PRNGKey(0)))(jd0)
  carry = bridge.composer_carry_from_numpy(
      _fields(jd0), {n: {k: np.asarray(x) for k, x in st.items()}
                     for n, st in jobs_state.items()},
      np.ones(BATCH, np.int32), device='cpu', dtype=torch.float64)
  assert set(carry.data.model_var) == set(jd0.model_var)
  for k, x in carry.data.model_var.items():
    assert str(x.dtype)[6:] == str(np.asarray(jd0.model_var[k]).dtype), k
  pipe = ObservationPipeline(m, task.observables, carry.data)
  zero = torch.zeros(BATCH, dtype=torch.int32)
  read, jread = pipe.read(carry.obs_state, zero), jax.vmap(
      lambda s: jpipe.read(s, jnp.zeros((), jnp.int32)))(jobs_state)
  errs = {'buffers': max(_scaled(read[k].numpy(), jread[k]) for k in jread)}
  assert read.keys() == jread.keys()

  # each physics step from the JAX package's state of the step before (the
  # carry's at the first); at each of its four acc stages the solver
  # inputs within TOL, the active rows equal, and both packages' float64
  # solutions within STOP_UNITS of the optimum's cost; qpos within TOL,
  # and qvel, the reward and the observables within TOL on the lanes whose
  # stage solutions agree within TOL (elsewhere two solutions that both
  # stop at the optimum's cost differ, as the rodent's do in
  # tests/test_torch_locomotion.py)
  jd, d = jd0, carry.data
  excused, checked, gap_max = 0, 0, 0.0
  for t in range(STEPS):
    jd, jrew, jobs, jstages = jstep(jd)
    stages = []
    with chip_smoke.recording(lambda before, after, _: stages.append(after)):
      d = forward.step(m, d)
    for fn, prefix in hooks:
      d = fn(m, d, None, prefix)
    assert len(stages) == 4
    agree = torch.ones(BATCH, dtype=torch.bool)
    same = torch.ones(BATCH, dtype=torch.bool)
    for stage, jstage in zip(stages, jstages):
      active = stage.efc_active.numpy()
      np.testing.assert_array_equal(active, np.asarray(jstage['efc_active']))
      # the solve reads the active rows only (an inactive mesh pair's
      # Frank-Wolfe witness may differ past TOL: tests/test_torch_meshes.py),
      # on the lanes whose earlier stages of this step agree to SAME_TOL
      # (a later stage's inputs carry an earlier stage's qacc difference,
      # through its velocities)
      lanes = same.numpy()
      checked += int(same.sum())
      for f in _STAGE_FIELDS:
        x, ref = getattr(stage, f).numpy(), np.asarray(jstage[f])
        if f.startswith('efc_'):
          rows = active.reshape(active.shape + (1,) * (x.ndim - 2))
          x, ref = x * rows, ref * rows
        errs['stage.' + f] = max(errs.get('stage.' + f, 0.0),
                                 _scaled(x[lanes], ref[lanes]))
      jq = torch.tensor(np.asarray(jstage['qacc']))
      for g in _stop_gaps(m, stage, (stage.qacc, jq)):
        assert bool((g <= STOP_UNITS).all()), (name, t, g)
        gap_max = max(gap_max, float(g.max()))
      apart = torch.tensor([_scaled(stage.qacc[i].numpy(), jq[i].numpy())
                            for i in range(BATCH)])
      agree &= apart <= TOL
      same &= apart <= SAME_TOL
    excused += int((~agree).sum())
    out = dict(qpos=d.qpos, qvel=d.qvel, reward=task.get_reward(m, d),
               **{'obs.' + k: s.fn(m, d) for k, s in task.observables.items()})
    ref = dict(qpos=jd.qpos, qvel=jd.qvel, reward=jrew,
               **{'obs.' + k: x for k, x in jobs.items()})
    assert out.keys() == ref.keys()
    for k in ref:
      lanes = slice(None) if k == 'qpos' else agree.numpy()
      errs[k] = max(errs.get(k, 0.0), _scaled(out[k].numpy()[lanes],
                                              np.asarray(ref[k])[lanes]))
    np.testing.assert_array_equal(d.efc_active.numpy(),
                                  np.asarray(jd.efc_active))
    d = bridge.data_from_numpy(_fields(jd), 'cpu', torch.float64)
  active = d.efc_active.sum(1).tolist()
  print(f'{name}: nv {m.nv}, active rows per lane after {STEPS} physics '
        f'steps {active}; lane-steps whose stage solutions differ past TOL '
        f'{excused} of {BATCH * STEPS}, stage inputs held on {checked} of '
        f'{4 * BATCH * STEPS} lane-stages (largest cost over the optimum '
        f'{gap_max:.3g} units of `_stop_gaps`); max scaled err '
        + ', '.join(f'{k} {e:.2e}' for k, e in errs.items()))
  assert all(e <= TOL for e in errs.values()), errs
  assert min(active) > 0


# -- the brick pin and the stack geometry -----------------------------------------


def test_pin_project_matches_jax_and_holds_the_base():
  jtask, task = _task_pair('stack_2_bricks_features')
  jm, m = jtask.model, task.model
  keys = jax.random.split(jax.random.PRNGKey(3), BATCH)
  jd = _jax_inits(jtask, keys)
  rng = np.random.RandomState(4)
  qpos = np.array(jd.qpos) + rng.uniform(-0.01, 0.01, jd.qpos.shape)
  qvel = rng.uniform(-0.5, 0.5, jd.qvel.shape)
  mv = {k: np.asarray(x) for k, x in jd.model_var.items()}
  mv['duplo_pin'] = np.eye(2)[rng.randint(0, 2, BATCH)]
  mv['duplo_pin'][0] = 0.0                        # a lane without a pin
  jd = jd.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                  model_var={k: jnp.asarray(x) for k, x in mv.items()})
  ((jfn, prefix),) = jtask.step_hooks('after_substep')
  ((fn, _),) = task.step_hooks('after_substep')
  jout = jax.vmap(lambda d: jfn(jm, d, jax.random.PRNGKey(0), prefix))(jd)
  d = bridge.data_from_numpy(_fields(jd), 'cpu', torch.float64)
  out = fn(m, d, None, prefix)
  np.testing.assert_array_equal(out.qpos.numpy(), np.asarray(jout.qpos))
  np.testing.assert_array_equal(out.qvel.numpy(), np.asarray(jout.qvel))
  # over substeps with controls, each lane's pinned brick stays at its pin
  bs = task.bricks
  d = forward.forward(m, out.replace(ctrl=torch.tensor(
      rng.uniform(-1, 1, (BATCH, m.nu)))))
  start = bs.brick_qpos(d).clone()
  pin = d.model_var['duplo_pin'] > 0
  for _ in range(3):
    d = fn(m, forward.step(m, d), None, prefix)
    now = bs.brick_qpos(d)
    assert torch.equal(now[pin], d.model_var['duplo_pin_qpos'][
        pin.nonzero()[:, 0]])
    assert torch.equal(now[pin], start[pin])
    v = torch.stack([d.qvel[:, a:a + 6] for a in bs.dadr], 1)
    assert bool((v[pin] == 0).all())
  assert not torch.equal(now[~pin], start[~pin])


@pytest.mark.parametrize('flip', [False, True])
def test_stack_poses_click_at_stack_dz(flip):
  jtask, task = _task_pair('reassemble_3_bricks_fixed_order_features')
  jm, m = jtask.model, task.model
  bs = task.bricks
  B = 2
  flips = torch.full((B, 3), flip)
  base_pos = torch.tensor([[0.05, -0.02, 0.0], [-0.03, 0.04, 0.01]],
                          dtype=torch.float64)
  theta = torch.tensor([0.3, -2.0], dtype=torch.float64)
  poses = bs.stack_poses(flips, base_pos, tasks.zrot_quat(theta), 3)
  # the JAX package's chain with the same flips
  jbs = jbricks.BrickSet(types.SimpleNamespace(
      add_observable=lambda *a: None), jm, 3)
  real = jax.random.bernoulli
  jax.random.bernoulli = lambda k, p, shape: jnp.full(shape, flip)
  try:
    jposes = np.stack([np.asarray(jbs.stack_poses(
        jax.random.PRNGKey(0), jnp.asarray(base_pos[i].numpy()),
        jbricks._zrot_quat(jnp.asarray(theta[i].numpy())), 3))
        for i in range(B)])
  finally:
    jax.random.bernoulli = real
  assert _scaled(poses.numpy(), jposes) <= INIT_TOL
  d = forward.make_data(m, B, torch.float64, 'cpu')
  for k in range(3):
    d = bs.set_brick_qpos(d, k, poses[:, k])
  d = smooth.kinematics(m, d)
  for k in range(2):
    dist = bs.pair_distance(d, k, k + 1)
    assert float(dist.max()) < 1e-12, (k, dist)
    dz = poses[:, k + 1, 2] - poses[:, k, 2]
    assert float((dz - duplo.STACK_DZ).abs().max()) < 1e-15
  reward = bs.stacking_reward(d, torch.arange(3).expand(B, 3), 3)
  assert float(reward.min()) > 0.999


# -- the registry ----------------------------------------------------------------


def test_registry_matches_jax():
  assert manipulation.ALL == jmanipulation.ALL and len(manipulation.ALL) == 25
  assert manipulation.TAGS == jmanipulation.TAGS
  for tag in jmanipulation.TAGS:
    assert (manipulation.get_environments_by_tag(tag)
            == jmanipulation.get_environments_by_tag(tag)), tag
  assert tasks.TAGS == jtasks.TAGS
  vision = manipulation.get_environments_by_tag('vision')
  assert len(vision) == 12 and len(FEATURES) == 13
  for name in vision:
    with pytest.raises(NotImplementedError, match='renderer'):
      manipulation.load(name, device='cpu')
  with pytest.raises(ValueError, match='unknown'):
    manipulation.load('reach_site')


def test_load_returns_environments():
  env = manipulation.load('reach_site_features', seed=3, device='cpu',
                          dtype=torch.float64)
  ts = env.reset()
  assert set(ts.observation) == {'arm_pos', 'arm_vel', 'tcp_pos', 'target'}
  assert env.action_spec().shape == (13,)
  benv = manipulation.load('stack_2_bricks_features', batch_size=2,
                           device='cpu')
  carry = benv.reset(seed=0)
  assert carry.data.qpos.dtype == torch.float32
  assert benv.n_sub_steps == 40 and benv.step_limit == 250
  assert sorted(carry.data.model_var) == [
      'body_pos', 'body_quat', 'duplo_order', 'duplo_pin', 'duplo_pin_qpos']


# -- chip_smoke.py's launch counts -------------------------------------------------


@pytest.mark.parametrize('name', ['reach_site_features',
                                  'stack_2_bricks_features'])
def test_manipulation_launch_counts(name, monkeypatch):
  """The launches `chip_smoke.composer_launches` expects per control step
  of a manipulation task (RK4: 4 acc stages of K1a, K1c and K2 per physics
  step, no K1b), counted on the CPU with every kernel wrapper replaced by
  its plain version and a counter, over one control step."""
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
  env = chip_smoke.manipulation_env(name, 2, device='cpu')
  carry = env.reset(seed=0)
  want = chip_smoke.composer_launches(env)
  assert want == {'cholesky_batched': 160, 'cho_solve_batched': 160,
                  'chol_solve_batched': 0, 'newton_solve_batched': 160,
                  'newton_solve_ell': 0}
  lk.reset_launches()
  nk.reset_launches()
  carry, (_, reward, done) = env.step(carry, torch.zeros((2, env.model.nu)))
  assert not bool(done.any())
  assert dict(lk.LAUNCHES, **nk.LAUNCHES) == want
  assert nk.CORE_LOOPS['calls'] == chip_smoke.composer_core_calls(env) == 0
  assert bool(((reward >= 0) & (reward <= 1)).all())
