"""Activation dynamics of the port against the JAX package's, float64 on
the CPU, and `act` through every copy of the integration state.

quadruped's 12 actuators are `dyntype="filter"` (tau 0.1 s): act_dot =
(ctrl - act) / tau, and the force acts through the activation, not the
control.  From seeded states (the free root low, at random orientations,
activations anywhere in the control range), `actuation`'s act_dot and
force, then act, qpos and qvel after one Euler step and after one RK4
step (the model with its integrator set to RK4: act goes through the
three inner stages) agree with the JAX package's to TOL scaled by
max(1, |ref|).  `act` then crosses `forward.state_of`, the bridge and
BatchedEnv's reset pool lane by lane.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dm_control_tpu import suite as jsuite
from dm_control_tpu._src import forward as jforward
from dm_control_tpu._src.types import Integrator as JIntegrator
from dm_control_tpu_torch import bridge
from dm_control_tpu_torch import suite
from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch._src import forward
from dm_control_tpu_torch._src.types import DynType, Integrator
from dm_control_tpu_torch.parallel import runner
from dm_control_tpu_torch.suite import quadruped

B = 8
TOL = 1e-9
# quadruped's control step (s)
_CONTROL_STEP = 0.02


def _scaled(x, ref):
  x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
  return float((np.abs(x - ref) / np.maximum(1.0, np.abs(ref))).max())


def _states(m, rng):
  qpos = np.tile(m.qpos0, (B, 1))
  for j in range(1, m.njnt):
    qpos[:, m.jnt_qposadr[j]] = rng.uniform(*m.jnt_range[j], B)
  quat = rng.randn(B, 4)
  qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
  qpos[:, 2] = rng.uniform(0.2, 0.5, B)
  return (qpos, 0.5 * rng.randn(B, m.nv), rng.uniform(-1, 1, (B, m.nu)),
          rng.uniform(-1, 1, (B, m.na)))


@pytest.mark.parametrize('integrator', ['euler', 'rk4'])
def test_activation_matches_jax(integrator):
  jm = jsuite.build_task('quadruped', 'walk').model
  m = suite.build_task('quadruped', 'walk', device='cpu').model
  assert m.na == m.nu == 12
  assert (m.actuator_dyntype == int(DynType.FILTER)).all()
  if integrator == 'rk4':
    jm = dataclasses.replace(jm, opt=dataclasses.replace(
        jm.opt, integrator=JIntegrator.RK4))
    m = engine.model_from_root(quadruped.arena(10.0), 'cpu',
                               integrator=Integrator.RK4,
                               **quadruped.BROADPHASE)
  qpos, qvel, ctrl, act = _states(m, np.random.RandomState(4))
  d0 = jforward.make_data(jm)
  step = jforward.rk4 if integrator == 'rk4' else jforward.euler

  def one(q, v, u, a):
    d = jforward.forward(jm, d0.replace(qpos=q, qvel=v, ctrl=u, act=a))
    out = step(jm, d)
    return d.act_dot, d.actuator_force, out.act, out.qpos, out.qvel

  refs = jax.jit(jax.vmap(one))(*map(jnp.asarray, (qpos, qvel, ctrl, act)))
  t = torch.tensor
  d = forward.forward(m, forward.make_data(m, B, torch.float64, 'cpu')
                      .replace(qpos=t(qpos), qvel=t(qvel), ctrl=t(ctrl),
                               act=t(act)))
  out = (forward.rk4 if integrator == 'rk4' else forward.euler)(m, d)
  outs = (d.act_dot, d.actuator_force, out.act, out.qpos, out.qvel)
  for name, x, ref in zip(('act_dot', 'actuator_force', 'act', 'qpos',
                           'qvel'), outs, refs):
    err = _scaled(x.numpy(), ref)
    print(f'quadruped {integrator}: {name} max scaled err {err:.2e}')
    assert err <= TOL, name
  ctrl = np.clip(ctrl, *m.actuator_ctrlrange.T)   # ctrllimited
  np.testing.assert_allclose(d.act_dot.numpy(), (ctrl - act) / 0.1,
                             rtol=1e-12)
  assert not torch.equal(out.act, d.act)


def test_make_data_gives_zero_activations():
  m = suite.build_task('quadruped', 'walk', device='cpu').model
  d = forward.make_data(m, 3, torch.float64, 'cpu')
  assert d.act.shape == (3, 12) and not d.act.any()
  assert forward.state_of(d)['act'] is d.act


def test_act_through_the_bridge_and_the_reset_pool():
  """The bridge carries act both ways; an episode limit of one control
  step sends every lane through the reset pool, and each lane's act is
  its pool entry's."""
  task = suite.build_task('quadruped', 'walk', device='cpu')
  env = runner.BatchedEnv(task, 4, time_limit=_CONTROL_STEP,
                          dtype=torch.float64)
  state = env.reset(seed=3)
  fields = bridge.data_to_numpy(state.data)
  assert fields['act'].shape == (4, 12)
  back = bridge.data_from_numpy(fields, device='cpu', dtype=torch.float64)
  assert torch.equal(back.act, state.data.act)
  pool_act = state.reset_pool['act'].clone()
  gen = torch.Generator()
  gen.manual_seed(0)
  state, _ = env.rollout_fn(1)(state, gen)
  assert bool((state.episode_id == 1).all())
  taken = runner.pool_index(torch.zeros(4, dtype=torch.int32),
                            torch.arange(4), 4)
  assert torch.equal(state.data.act, pool_act[taken])
  assert env.reset_calls == 0                 # no init_states call

