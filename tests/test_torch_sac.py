"""The port's SAC learner and its companions against the JAX package.

The same SAC state (carried by `bridge.sac_state_from_numpy`), the same
batch and the same normal draws (made from the JAX package's split keys)
go through the JAX package's `SAC.update` and the port's at float64 on
the CPU: every parameter, target, Adam moment, `log_alpha` and metric
within 1e-9.  Also `mlp_apply`, `replay_add`'s wrap, three train steps of
pendulum-swingup (the JAX package's tests/test_sac.py), the checkpoint
round trip and its refusals, `Meter`, and `make_sac_trainer`'s device
rule.  Float64 throughout, batch <= 16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dm_control_tpu.parallel.metrics import Meter as JMeter
from dm_control_tpu.rl import sac as jsac
from dm_control_tpu_torch import bridge
from dm_control_tpu_torch import suite
from dm_control_tpu_torch.parallel import distributed
from dm_control_tpu_torch.parallel.metrics import Meter
from dm_control_tpu_torch.parallel.runner import BatchedEnv
from dm_control_tpu_torch.rl import sac
from dm_control_tpu_torch.utils import checkpoint

TOL = 1e-9
CFG = dict(hidden=(32, 32), replay_capacity=64, learn_batch=16)


@pytest.fixture(scope='module')
def jax_learner():
  """The port's SAC on cheetah-run (obs 17, act 6) and the JAX package's
  SAC of the same widths, its state made float64.  The JAX learner is
  made without its constructor, whose one eager forward of the task only
  measures the observation (~30 s of primitive compiles on a CPU): `init`
  and `update` read only the widths, the config and the target entropy.
  Every floating leaf is cast, `log_alpha` too: it is born a weakly typed
  scalar, which would take the float32 of Adam's step size and update in
  float32."""
  port = sac.SAC(suite.build_task('cheetah', 'run', device='cpu'),
                 sac.SACConfig(**CFG), dtype=torch.float64)
  learner = object.__new__(jsac.SAC)
  learner.config = jsac.SACConfig(**CFG)
  learner.obs_dim, learner.act_dim = port.obs_dim, port.act_dim
  learner.target_entropy = -float(port.act_dim)
  state = jax.tree_util.tree_map(
      lambda x: (x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating)
                 else x), learner.init(jax.random.PRNGKey(3)))
  return learner, state, port


def _numpy_state(state):
  """A JAX SACState's fields as numpy (the bridge's input)."""
  return {f.name: jax.tree_util.tree_map(np.asarray, getattr(state, f.name))
          for f in dataclasses.fields(state)}


def _max_err(a, b):
  errs = jax.tree_util.tree_map(
      lambda x, y: float(np.max(np.abs(np.asarray(x) - np.asarray(y)),
                                initial=0.0)), a, b)
  return max(jax.tree_util.tree_leaves(errs))


def test_bridge_round_trip(jax_learner):
  _, state, _ = jax_learner
  fields = _numpy_state(state)
  back = bridge.sac_state_to_numpy(
      bridge.sac_state_from_numpy(fields, 'cpu', torch.float64))
  assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
      fields)
  assert _max_err(back, fields) == 0.0


def test_mlp_apply_matches_jax(jax_learner):
  learner, state, port = jax_learner
  x = np.random.RandomState(0).randn(16, learner.obs_dim)
  ours = bridge.sac_state_from_numpy(_numpy_state(state), 'cpu',
                                     torch.float64)
  ref = np.asarray(jsac.mlp_apply(state.actor, jnp.asarray(x)))
  got = sac.mlp_apply(ours.actor, torch.from_numpy(x)).detach().numpy()
  err = np.abs(got - ref).max()
  print(f'mlp_apply: max abs err {err:.2e}')
  # cheetah-run's observation: 8 positions (all but the root's x) and 9
  # velocities, as the JAX package's
  assert (port.obs_dim, port.act_dim) == (17, 6)
  assert err <= TOL


def _batch(rng, learner, b):
  return (rng.randn(b, learner.obs_dim),
          np.tanh(rng.randn(b, learner.act_dim)),
          rng.rand(b), rng.randn(b, learner.obs_dim),
          (rng.rand(b) > 0.2).astype(np.float64))


@pytest.mark.parametrize('updates', [1, 3])
def test_update_matches_jax(jax_learner, updates):
  """`updates` consecutive updates (Adam's bias correction at t = 1 and
  3, the moments carried) from the same state, batches and draws."""
  learner, state, port = jax_learner
  ours = bridge.sac_state_from_numpy(_numpy_state(state), 'cpu',
                                     torch.float64)
  update = jax.jit(learner.update)
  rng = np.random.RandomState(updates)
  for i in range(updates):
    batch = _batch(rng, learner, CFG['learn_batch'])
    key = jax.random.PRNGKey(100 + i)
    k1, k2 = jax.random.split(key)
    noise = [torch.from_numpy(np.array(jax.random.normal(
        k, (CFG['learn_batch'], learner.act_dim)))) for k in (k1, k2)]
    state, metrics = update(state, tuple(jnp.asarray(x) for x in batch), key)
    ours, got = port.update(ours, tuple(torch.from_numpy(x) for x in batch),
                            noise=noise)
  ref = _numpy_state(state)
  mine = bridge.sac_state_to_numpy(ours)
  errs = {k: _max_err(mine[k], ref[k]) for k in ref}
  errs.update({f'metric {k}': abs(float(got[k]) - float(v))
               for k, v in metrics.items()})
  print(f'SAC update x{updates}: max abs err ' + ', '.join(
      f'{k} {e:.1e}' for k, e in errs.items()))
  assert int(ours.step) == updates
  assert max(errs.values()) <= TOL, errs


def test_replay_wraps_as_jax():
  rng = np.random.RandomState(5)
  cap, obs_dim, act_dim = 20, 3, 2
  buf = sac.replay_init(cap, obs_dim, act_dim, torch.float64)
  jbuf = jsac.replay_init(cap, obs_dim, act_dim, jnp.float64)
  for b in (8, 8, 8, 7):               # past the capacity twice
    xs = (rng.randn(b, obs_dim), rng.randn(b, act_dim), rng.randn(b),
          rng.randn(b, obs_dim), rng.rand(b))
    jbuf = jsac.replay_add(jbuf, *(jnp.asarray(x) for x in xs))
    buf = sac.replay_add(buf, *(torch.from_numpy(x) for x in xs))
    assert (buf.ptr, buf.size) == (int(jbuf.ptr), int(jbuf.size))
    for f in ('obs', 'action', 'reward', 'next_obs', 'discount'):
      np.testing.assert_array_equal(getattr(buf, f).numpy(),
                                    np.asarray(getattr(jbuf, f)))
  gen = torch.Generator().manual_seed(0)
  sample = sac.replay_sample(buf, gen, 16)
  rows = {tuple(r) for r in buf.obs.numpy()}
  assert all(tuple(r) in rows for r in sample[0].numpy())


def _pendulum(batch=8, time_limit=2.0):
  task = suite.build_task('pendulum', 'swingup', device='cpu')
  env = BatchedEnv(task, batch, time_limit=time_limit, dtype=torch.float64)
  cfg = sac.SACConfig(hidden=(32, 32), replay_capacity=1024, learn_batch=16)
  return task, env, sac.SAC(task, cfg, dtype=torch.float64)


def test_sac_train_step_runs():
  """Three fused train steps (the JAX package's tests/test_sac.py:14-37)."""
  task, env, learner = _pendulum()
  gen = torch.Generator().manual_seed(2)
  state = learner.init(gen)
  actor0 = [p.detach().clone() for p in state.actor.parameters()]
  replay = sac.replay_init(1024, learner.obs_dim, learner.act_dim,
                           torch.float64)
  train = sac.make_train_step(learner, env)
  carry = (state, env.reset(1), replay, gen)
  for _ in range(3):
    carry, metrics = train(carry)
  state = carry[0]
  assert int(state.step) == 3 and carry[2].size == 24
  assert set(metrics) == {'critic_loss', 'actor_loss', 'alpha_loss', 'alpha',
                          'reward_mean'}
  for k, v in metrics.items():
    assert np.isfinite(float(v)), f'{k} not finite'
  delta = sum(float((a - p.detach()).abs().sum())
              for a, p in zip(actor0, state.actor.parameters()))
  assert delta > 0


def test_checkpoint_round_trip(tmp_path):
  task, env, learner = _pendulum(batch=4)
  gen = torch.Generator().manual_seed(0)
  run_state = env.reset(0)
  replay = sac.replay_add(
      sac.replay_init(16, learner.obs_dim, learner.act_dim, torch.float64),
      *(torch.randn((4,) + s, dtype=torch.float64, generator=gen)
        for s in ((learner.obs_dim,), (learner.act_dim,), (),
                  (learner.obs_dim,), ())))
  for tree in (run_state, learner.init(gen), replay):
    path = str(tmp_path / f'{type(tree).__name__}.npz')
    checkpoint.save(path, tree)
    restored = checkpoint.restore(path, tree)
    want, got = [], []
    checkpoint._flatten(tree, '', want)
    checkpoint._flatten(restored, '', got)
    assert [(p, k) for p, k, _ in want] == [(p, k) for p, k, _ in got]
    for (p, kind, x), (_, _, y) in zip(want, got):
      if kind == 'tensor':
        assert x.dtype == y.dtype and torch.equal(x, y), p
      else:
        assert x == y, p


def test_checkpoint_rejects_mismatch(tmp_path):
  task, env, learner = _pendulum(batch=4)
  gen = torch.Generator().manual_seed(0)
  path = str(tmp_path / 'ck.npz')
  checkpoint.save(path, env.reset(0))
  with pytest.raises(ValueError, match='structure'):
    checkpoint.restore(path, learner.init(gen))
  with pytest.raises(ValueError, match='shape'):
    checkpoint.restore(path, BatchedEnv(task, 5, dtype=torch.float64).reset(0))
  checkpoint.save(path, learner.init(gen))
  wide = sac.SAC(task, sac.SACConfig(hidden=(32, 33)), dtype=torch.float64)
  with pytest.raises(ValueError, match='shape'):
    checkpoint.restore(path, wide.init(gen))


def test_meter_matches_jax():
  rng = np.random.RandomState(7)
  ours, ref = Meter(batch_size=8), JMeter(batch_size=8)
  for _ in range(5):
    done = rng.rand(8) < 0.3
    reward = rng.randn(8)
    diverged = rng.rand(8) < 0.1
    ref.update(done=jnp.asarray(done), reward=jnp.asarray(reward),
               diverged=jnp.asarray(diverged))
    ours.update(done=torch.from_numpy(done), reward=torch.from_numpy(reward),
                diverged=torch.from_numpy(diverged))
  a, b = ours.snapshot(), ref.snapshot()
  for k in ('env_steps', 'episodes', 'divergences'):
    assert a[k] == b[k], k
  assert abs(a['mean_reward'] - b['mean_reward']) <= TOL
  assert set(a) == set(b)


def test_make_sac_trainer_device_rule(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='device="cpu"'):
    distributed.make_sac_trainer('pendulum', 'swingup', 4)


def test_make_sac_trainer_on_cpu():
  cfg = sac.SACConfig(hidden=(16, 16), replay_capacity=64, learn_batch=8)
  carry, train = distributed.make_sac_trainer('pendulum', 'swingup', 4,
                                              seed=1, config=cfg,
                                              device='cpu')
  for _ in range(2):
    carry, metrics = train(carry)
  assert int(carry[0].step) == 2 and carry[2].size == 8
  assert all(np.isfinite(float(v)) for v in metrics.values())
