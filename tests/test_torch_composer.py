"""The port's composer layer against the JAX package, float64 on the CPU.

  * `ObservationPipeline.update` and `read` on the same numpy-drawn value
    sequences, every lane at its own substep: buffers and reads equal at
    every substep for update intervals 1-3, buffer sizes 1-3, delays 0-4
    and an aggregator (max over the buffer).
  * The Variation DSL's arithmetic on constant draws, and its draws by
    their ranges.
  * `attach`: the composed XML equal to the JAX package's (ElementTree
    text), default classes scoped.
  * `Environment`'s hook, recompile and retry semantics (the JAX
    package's tests/test_hooks.py cases, on the port alone).
  * `BatchedEnvironment`'s auto-reset: every done lane takes a fresh
    state, its buffers and substep counter, with its `model_var` keys that
    are not Model fields (a TargetSphere's latch and colours, a task
    state); such keys also cross `forward.state_of`, the runner's reset
    pool and the bridge per lane.
"""

import copy
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dm_control_tpu.composer import entity as jentity
from dm_control_tpu.composer import observation as jobservation
from dm_control_tpu.composer import variation as jvariation
from dm_control_tpu_torch import bridge
from dm_control_tpu_torch._src import forward
from dm_control_tpu_torch.composer import entity
from dm_control_tpu_torch.composer import environment
from dm_control_tpu_torch.composer import observation
from dm_control_tpu_torch.composer import variation
from dm_control_tpu_torch.composer.entity import Entity
from dm_control_tpu_torch.composer.task import ComposerTask
from dm_control_tpu_torch.locomotion import props
from dm_control_tpu_torch.parallel import runner
from dm_control_tpu_torch.rl import control

# -- the observation pipeline ------------------------------------------------

LANES = 5
SUBSTEPS = 14


def _specs(pkg, agg):
  """One observable per (interval, buffer, delay), reading lane values
  handed in as the 'data', plus two with the aggregator."""
  out = {}
  for interval in (1, 2, 3):
    for size in (1, 2, 3):
      for delay in range(5):
        out[f'u{interval}b{size}d{delay}'] = pkg.ObservableSpec(
            fn=lambda m, d: d, update_interval=interval, buffer_size=size,
            delay=delay)
  out['max_b3d2'] = pkg.ObservableSpec(fn=lambda m, d: d, buffer_size=3,
                                       delay=2, aggregator=agg)
  out['max_u2b2'] = pkg.ObservableSpec(fn=lambda m, d: d, update_interval=2,
                                       buffer_size=2, aggregator=agg)
  return out


def test_pipeline_matches_jax():
  """Every substep, every lane (lanes start at substeps 0-4): the port's
  buffers and reads equal the JAX package's (vmapped) exactly."""
  rng = np.random.RandomState(0)
  values = rng.randn(SUBSTEPS, LANES, 3)
  start = np.arange(LANES) % 5
  jpipe = jobservation.ObservationPipeline(
      None, _specs(jobservation, lambda b: jnp.max(b, axis=0)),
      jnp.zeros(3))
  pipe = observation.ObservationPipeline(
      None, _specs(observation, lambda b: b.amax(dim=1)),
      torch.zeros((1, 3), dtype=torch.float64))
  key = jax.random.PRNGKey(0)
  jupdate = jax.jit(jax.vmap(lambda s, v, t: jpipe.update(s, v, t, key)))
  jread = jax.jit(jax.vmap(jpipe.read))
  jstate = jax.vmap(lambda _: jpipe.init_state())(jnp.arange(LANES))
  state = pipe.init_state(LANES, 'cpu')
  checked = 0
  for t in range(SUBSTEPS):
    sub = start + t
    jstate = jupdate(jstate, jnp.asarray(values[t]),
                     jnp.asarray(sub, jnp.int32))
    state = pipe.update(state, torch.tensor(values[t]),
                        torch.tensor(sub, dtype=torch.int32))
    for name, st in state.items():
      for k, x in st.items():
        np.testing.assert_array_equal(x.numpy(), np.asarray(jstate[name][k]),
                                      err_msg=f'{name} {k} at {t}')
    for now in (sub, sub + 1):
      jobs = jread(jstate, jnp.asarray(now, jnp.int32))
      obs = pipe.read(state, torch.tensor(now, dtype=torch.int32))
      assert obs.keys() == jobs.keys()
      for name in obs:
        np.testing.assert_array_equal(obs[name].numpy(),
                                      np.asarray(jobs[name]),
                                      err_msg=f'{name} read at {t}')
        checked += int(np.count_nonzero(np.asarray(jobs[name])))
  assert checked > 0
  assert pipe.shapes == {name: (3,) for name in obs}


def test_pipeline_corruptor_draws_from_generator():
  """A corruptor gets the sampled (B, *shape) value and the generator."""
  seen = []

  def corrupt(v, gen):
    seen.append(gen)
    return v + torch.rand(v.shape, generator=gen, dtype=v.dtype)

  pipe = observation.ObservationPipeline(None, {'x': observation.ObservableSpec(
      fn=lambda m, d: d, corruptor=corrupt)}, torch.zeros((1, 2),
                                                          dtype=torch.float64))
  gen = torch.Generator().manual_seed(3)
  state = pipe.update(pipe.init_state(4, 'cpu'), torch.zeros(4, 2,
                                                             dtype=torch.float64),
                      torch.zeros(4, dtype=torch.int32), gen)
  x = pipe.read(state, torch.zeros(4, dtype=torch.int32))['x']
  assert seen == [gen] and x.shape == (4, 2)
  assert bool(((x > 0) & (x < 1)).all())
  with pytest.raises(NotImplementedError, match='renderer'):
    observation.camera_observable(0)


# -- the Variation DSL ----------------------------------------------------------


@pytest.fixture
def float64_draws():
  """Variations draw at torch's default dtype: float64 here."""
  old = torch.get_default_dtype()
  torch.set_default_dtype(torch.float64)
  yield
  torch.set_default_dtype(old)


def test_variation_arithmetic_matches_jax(float64_draws):
  """Constant draws (low == high) through every operator equal the JAX
  package's; Additive and Multiplicative noise read the current value."""
  def build(v):
    a, b = v.Uniform(2.0, 2.0), v.Uniform(-3.0, -3.0)
    return [a + 1.5, 1.5 + a, a - b, 4.0 - a, a * b, 0.5 * b, a / b,
            1.0 / a, a ** 2, -b, abs(b), (a + b) * (a - 0.25) / 3.0,
            v.Additive(a), v.Multiplicative(b)]
  gen = torch.Generator().manual_seed(0)
  for i, (x, y) in enumerate(zip(build(variation), build(jvariation))):
    got = variation.evaluate(x, gen, initial_value=0.5, current_value=1.25)
    want = jvariation.evaluate(y, jax.random.PRNGKey(i), initial_value=0.5,
                               current_value=1.25)
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-15,
                               err_msg=f'expression {i}')
  nested = variation.evaluate((variation.Uniform(1.0, 1.0), [2.0]), gen)
  assert isinstance(nested, tuple) and float(nested[0]) == 1.0


def test_variation_draws_in_their_ranges():
  gen = torch.Generator().manual_seed(1)
  u = variation.Uniform(-2.0, 3.0, shape=(1000,))(gen)
  assert u.shape == (1000,) and bool(((u >= -2) & (u < 3)).all())
  assert variation.Uniform([0.0, 1.0], [1.0, 2.0])(gen).shape == (2,)
  # one draw shared by every element
  one = variation.Uniform([0.0, 1.0], [1.0, 3.0], single_sample=True)(gen)
  assert one.shape == (2,) and abs(float(one[1] - 1.0) / 2 - float(one[0])
                                   ) < 1e-6
  assert bool((variation.Exponential(shape=(100,))(gen) >= 0).all())
  assert bool((variation.LogNormal(shape=(100,))(gen) > 0).all())
  b = variation.Bernoulli(0.5, shape=(200,))(gen)
  assert b.dtype == torch.bool and 0 < int(b.sum()) < 200
  assert float(variation.UniformChoice([4.0, 7.0])(gen)) in (4.0, 7.0)
  p = variation.Poisson(3.0, shape=(50,))(gen)
  assert bool((p >= 0).all()) and bool((p == p.round()).all())
  for v in (variation.UniformPointOnSphere(), variation.UniformQuaternion()):
    assert abs(float(torch.linalg.norm(v(gen))) - 1.0) < 1e-6
  q = variation.QuaternionFromAxisAngle([0.0, 0.0, 2.0], np.pi)(gen)
  np.testing.assert_allclose(q.numpy(), [0, 0, 0, 1], atol=1e-6)
  walk = variation.BiasedRandomWalk(stdev=0.1, timescale=10.0)
  assert walk(gen, current_value=torch.zeros(3)).shape == (3,)


# -- attach -----------------------------------------------------------------------

_ARENA = """
<mujoco model="arena">
  <option timestep="0.01"/>
  <default><geom friction=".9 .1 .1"/></default>
  <worldbody>
    <geom type="plane" size="5 5 .1" name="floor"/>
    <body name="mount" pos="1 0 0"/>
  </worldbody>
</mujoco>
"""

_BALL = """
<mujoco model="ball">
  <worldbody>
    <body name="ball" pos="0 0 1">
      <joint type="free" name="root"/>
      <geom type="sphere" size=".1" mass="1" name="ballgeom"/>
    </body>
  </worldbody>
</mujoco>
"""

_ARM = """
<mujoco model="arm">
  <default>
    <joint damping=".5"/>
    <default class="link"><geom rgba=".5 .5 .5 1" size=".03"/></default>
  </default>
  <worldbody>
    <body name="upper" childclass="link">
      <joint name="shoulder" type="hinge" axis="0 1 0"/>
      <geom name="upper" type="capsule" fromto="0 0 0 .3 0 0"/>
      <site name="tip" pos=".3 0 0"/>
    </body>
  </worldbody>
  <tendon><fixed name="t"><joint joint="shoulder" coef="1"/></fixed></tendon>
  <actuator><motor name="m" joint="shoulder" gear="2"/></actuator>
  <sensor><jointpos name="q" joint="shoulder"/></sensor>
</mujoco>
"""


@pytest.mark.parametrize('site_body,pos', [(None, None), ('mount', '0 0 .5')])
def test_attach_matches_jax(site_body, pos):
  """The composed XML is the JAX package's, character for character."""
  got = ET.fromstring(_ARENA)
  want = ET.fromstring(_ARENA)
  for xml, name in ((_BALL, 'ball'), (_ARM, 'arm')):
    entity.attach(got, Entity.from_xml_string(xml, name=name),
                  site_body=site_body, pos=pos)
    jentity.attach(want, jentity.Entity.from_xml_string(xml, name=name),
                   site_body=site_body, pos=pos)
  assert ET.tostring(got) == ET.tostring(want)
  text = ET.tostring(got, encoding='unicode')
  assert 'arm/link' in text and 'class="arm/"' in text
  with pytest.raises(ValueError, match='no body named'):
    entity.attach(got, Entity.from_xml_string(_BALL, name='b2'),
                  site_body='nowhere')


# -- Environment: hooks, recompiles and retries (JAX tests/test_hooks.py) -------


def _make_task(**entity_hooks):
  arena = Entity(mjcf_root=ET.fromstring(_ARENA), name='arena')
  ball = Entity(mjcf_root=ET.fromstring(_BALL), name='ball', **entity_hooks)
  task = ComposerTask(arena, control_timestep=0.05, device='cpu')
  task.attach(ball)
  return task, ball


def _env(task, **kw):
  return environment.Environment(task, dtype=torch.float64, **kw)


def test_step_hooks_fire_and_act():
  calls = []

  def before_step(m, d, generator, prefix):
    calls.append(('before_step', prefix))
    return d

  def after_substep(m, d, generator, prefix):
    calls.append(('after_substep', prefix))
    # damp velocities every substep: observable effect vs no-hook run
    return d.replace(qvel=d.qvel * 0.5)

  task, _ = _make_task(before_step_hook=before_step,
                       after_substep_hook=after_substep)
  env = _env(task, time_limit=1.0)
  env.reset()
  ts = env.step(np.zeros(env.action_spec().shape))
  assert ts.mid() and calls.count(('after_substep', 'ball')) == 5
  assert calls[0] == ('before_step', 'ball')
  task2, _ = _make_task()
  env2 = _env(task2, time_limit=1.0)
  env2.reset()
  env2.step(np.zeros(env2.action_spec().shape))
  v_hooked = float(env.physics.qvel[0, 2])
  v_free = float(env2.physics.qvel[0, 2])
  assert abs(v_hooked) < abs(v_free) * 0.5


def test_after_compile_hook_receives_model_and_prefix():
  seen = {}

  def after_compile(m, prefix):
    seen['nbody'] = int(m.nbody)
    seen['prefix'] = prefix

  task, _ = _make_task(after_compile_hook=after_compile)
  task.compile()
  assert seen == {'nbody': 3, 'prefix': 'ball'}  # world, mount, ball


def test_mjcf_hook_recompiles_per_episode():
  sizes = []

  def mjcf_hook(root, random_state):
    # per-episode geometry variation: grow the ball each episode
    size = 0.1 + 0.05 * len(sizes)
    root.find('.//geom').set('size', str(size))
    sizes.append(size)

  task, _ = _make_task(mjcf_hook=mjcf_hook)
  assert task.has_mjcf_hooks
  env = _env(task, time_limit=0.2)
  env.reset()
  g = env._model.name2id('geom', 'ball/ballgeom')
  r0 = float(env._model.geom_size[g, 0])
  env.reset()
  r1 = float(env._model.geom_size[g, 0])
  assert r1 > r0  # the model really was recompiled with the mutated MJCF
  assert env._base_model is env._model   # a size is no overlay field


def test_reset_raises_after_exhausted_retries():
  calls = []

  def init_hook(m, d, generator, prefix):  # every attempt diverges
    calls.append(prefix)
    qpos = d.qpos.clone()
    qpos[:, 2] = float('nan')
    return d.replace(qpos=qpos)

  task, _ = _make_task(init_hook=init_hook)
  env = _env(task, time_limit=0.2)
  with pytest.raises(RuntimeError, match='diverged'):
    env.reset()
  assert len(calls) == environment.Environment.MAX_RESET_ATTEMPTS


def test_reset_retries_on_divergent_init():
  """Attempts 0 and 1 diverge, attempt 2 does not: the episode starts
  from attempt 2's state."""
  calls = []

  def init_hook(m, d, generator, prefix):
    calls.append(torch.rand((), generator=generator, dtype=torch.float64))
    qpos = d.qpos.clone()
    qpos[:, 2] = float('nan') if len(calls) < 3 else 2.0 + calls[-1]
    return d.replace(qpos=qpos)

  task, _ = _make_task(init_hook=init_hook)
  env = _env(task, time_limit=0.2)
  ts = env.reset()
  assert ts.first() and len(calls) == 3
  assert float(env.physics.qpos[0, 2]) == 2.0 + float(calls[-1])
  assert not bool(env.physics.diverged[0])


def test_add_observable_survives_recompile():
  def mjcf_hook(root, random_state):
    root.find('.//geom').set('size', str(0.1 + 0.01 * random_state.rand()))

  task, _ = _make_task(mjcf_hook=mjcf_hook)
  task.add_observable('ball_height', observation.ObservableSpec(
      fn=lambda m, d: d.qpos[:, 2, None]))
  env = _env(task, time_limit=0.2)
  assert 'ball_height' in env.reset().observation
  assert 'ball_height' in env.reset().observation  # after a recompile
  assert env.observation_spec()['ball_height'].shape == (1,)


def test_pose_only_mjcf_variation_reuses_the_loop():
  """A per-episode variation of overlay fields only (a body's pos) keeps
  the running model and loop and sends the new values through every
  lane's model_var."""
  poses = [0.5, 1.5, 2.5]
  calls = {'n': 0}

  def mjcf_hook(root, random_state):
    root.find('.//body').set('pos', f'0 0 {poses[calls["n"] % 3]}')
    calls['n'] += 1

  task, _ = _make_task(mjcf_hook=mjcf_hook)
  env = _env(task, time_limit=0.2)
  env.reset()
  base, loop = env._base_model, env._loop
  env.reset()
  assert env._base_model is base and env._loop is loop
  assert 'body_pos' in env._overlay
  z = float(env.physics.xpos[0, base.name2id('body', 'ball/ball'), 2])
  assert abs(z - poses[(calls['n'] - 1) % 3]) < 1e-9, (z, calls)


def test_episode_ends_on_termination_and_time_limit():
  task, _ = _make_task()
  task.set_termination(lambda m, d: d.qpos[:, 2] < 0.9)
  env = _env(task, time_limit=10.0)
  env.reset()
  steps = 0
  while True:
    ts = env.step(np.zeros(0))
    steps += 1
    if ts.last():
      break
  assert ts.discount == 0.0 and steps < 10 and env.physics is None
  task2, _ = _make_task()
  env2 = _env(task2, time_limit=0.1)
  env2.reset()
  assert env2.step(np.zeros(0)).mid()
  ts = env2.step(np.zeros(0))
  assert ts.last() and ts.discount == 1.0


# -- BatchedEnvironment: auto-reset and per-lane model_var -------------------


def _sphere_task():
  """A ball with a TargetSphere on the arena's mount and a per-lane task
  state; the ball falls and each lane's episode ends after 2 steps."""
  target = props.TargetSphere(radius=0.4, height_above_ground=0.5,
                              name='target')
  target.install_hooks(['ball/ball'])
  task, ball = _make_task()
  task.attach(target)

  def init(m, d, generator):
    mv = dict(d.model_var or {})
    B = d.qpos.shape[0]
    mv['task_state'] = torch.rand((B, 3), generator=generator,
                                  dtype=d.qpos.dtype)
    qpos = d.qpos.clone()
    qpos[:, 0] = torch.rand((B,), generator=generator, dtype=d.qpos.dtype)
    return d.replace(qpos=qpos, model_var=mv)

  task.add_init_hook(init)
  task.add_observable('x', observation.ObservableSpec(
      fn=lambda m, d: d.qpos[:, :3], buffer_size=2, delay=1))
  task.set_reward(lambda m, d: target.activated(m, d, 'target').to(
      d.qpos.dtype))
  return task


def test_auto_reset_takes_fresh_lanes_whole():
  B = 4
  env = environment.BatchedEnvironment(_sphere_task(), B, time_limit=0.1,
                                       dtype=torch.float64)
  carry = env.reset(seed=3)
  keys = {'task_state', 'target_activated', 'geom_rgba'}
  assert set(carry.data.model_var) == keys
  assert all(x.shape[0] == B for x in carry.data.model_var.values())
  old = carry.data.model_var['task_state']
  zero = torch.zeros((B, 0), dtype=torch.float64)
  carry, (_, _, done) = env.step(carry, zero)
  assert not bool(done.any()) and bool((carry.substep == 6).all())
  drawn = env.generator.get_state()
  carry, (obs, reward, done) = env.step(carry, zero)
  assert bool(done.all()) and env.reset_calls == 1
  env.generator.set_state(drawn)
  fresh_d, fresh_obs = env._loop.fresh(B, env.generator)
  for k in keys:
    assert torch.equal(carry.data.model_var[k], fresh_d.model_var[k]), k
  assert not torch.equal(carry.data.model_var['task_state'], old)
  for f in ('qpos', 'qvel', 'xpos', 'qM', 'efc_J', 'sensordata', 'time'):
    assert torch.equal(getattr(carry.data, f), getattr(fresh_d, f)), f
  assert torch.equal(carry.data.contact.dist, fresh_d.contact.dist)
  for k in ('values', 'visible_at', 'write_idx'):
    assert torch.equal(carry.obs_state['x'][k], fresh_obs['x'][k])
  assert bool((carry.substep == 1).all())
  # the observation is read after the reset, at substep 1: the reset's
  # sample (taken at substep 0, delay 1) has just arrived
  assert torch.equal(obs['x'][:, 1], fresh_d.qpos[:, :3])
  assert torch.equal(obs['x'][:, 0], torch.zeros((B, 3), dtype=torch.float64))


def test_unknown_model_var_keys_cross_state_pool_and_bridge():
  """model_var keys that are not Model fields ((B, 3), (B,), (B, ngeom,
  4)) travel per lane through state_of, the runner's reset pool and the
  bridge."""
  task = _sphere_task()
  m = task.compile()
  B = 4

  def init(m_, d, generator):
    mv = dict(d.model_var or {})
    mv['tt_state'] = torch.rand((d.qpos.shape[0], 3), generator=generator,
                                dtype=d.qpos.dtype)
    mv['target_activated'] = torch.rand((d.qpos.shape[0],),
                                        generator=generator,
                                        dtype=d.qpos.dtype)
    mv['geom_rgba'] = torch.rand((d.qpos.shape[0], m_.ngeom, 4),
                                 generator=generator, dtype=d.qpos.dtype)
    return d.replace(model_var=mv)

  tdef = control.TaskDef(
      name='ball', model=m, init_episode=init,
      get_observation=lambda m_, d: {'q': d.qpos},
      get_reward=lambda m_, d: d.qpos[:, 2], control_timestep=0.05,
      expensive_init=True)
  env = runner.BatchedEnv(tdef, B, time_limit=0.1, dtype=torch.float64)
  state = env.reset(seed=1)
  pool = state.reset_pool['model_var']
  assert set(pool) == {'tt_state', 'target_activated', 'geom_rgba'}
  for _ in range(2):
    state, _ = env.step(state, torch.zeros((B, 0), dtype=torch.float64))
  assert bool((state.episode_id == 1).all())
  taken = runner.pool_index(torch.zeros(B, dtype=torch.int32),
                            torch.arange(B), B)
  for k, x in state.data.model_var.items():
    assert torch.equal(x, pool[k][taken]), k
  fields = bridge.data_to_numpy(state.data)
  back = bridge.data_from_numpy(fields, device='cpu', dtype=torch.float64)
  for k, x in state.data.model_var.items():
    assert torch.equal(back.model_var[k], x), k
  st = forward.state_of(state.data)
  assert set(st['model_var']) == set(pool)


def test_composer_carry_crosses_the_bridge():
  """A carry through numpy and back: every buffer, counter and model_var
  tensor equal, counters int32."""
  env = environment.BatchedEnvironment(_sphere_task(), 3,
                                       dtype=torch.float64)
  carry = env.reset(seed=0)
  fields = bridge.data_to_numpy(carry.data)
  obs_state = {n: {k: x.numpy() for k, x in st.items()}
               for n, st in carry.obs_state.items()}
  back = bridge.composer_carry_from_numpy(
      fields, obs_state, carry.substep.numpy(), device='cpu',
      dtype=torch.float64)
  assert back.substep.dtype == torch.int32
  assert torch.equal(back.substep, carry.substep)
  for n, st in carry.obs_state.items():
    for k, x in st.items():
      assert back.obs_state[n][k].dtype == x.dtype
      assert torch.equal(back.obs_state[n][k], x)
  for k, x in carry.data.model_var.items():
    assert torch.equal(back.data.model_var[k], x)
  assert torch.equal(back.data.qpos, carry.data.qpos)
  copy.deepcopy(back)
