"""The port's BatchedEnv on walker-walk against the JAX package's.

The JAX BatchedEnv resets a batch of 8; the port takes the same initial
states through the bridge.  The same numpy actions then drive both
`step`s for 5 control steps (50 physics substeps) at float64 on the CPU.
qpos, qvel, reward and every observation key must agree to 1e-6 scaled
by max(1, |ref|) at every step (the per-step solve stops at
opt.tolerance, and its ~1e-8 differences grow over the contact-rich
substeps).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dm_control_tpu import suite as jsuite
from dm_control_tpu.parallel import runner as jrunner
from dm_control_tpu_torch import bridge
from dm_control_tpu_torch import suite
from dm_control_tpu_torch.parallel import runner

BATCH = 8
STEPS = 5


def _fields(d):
  out = {f.name: np.asarray(getattr(d, f.name))
         for f in dataclasses.fields(d)
         if f.name not in ('contact', 'model_var')}
  out.update({'contact.' + f.name: np.asarray(getattr(d.contact, f.name))
              for f in dataclasses.fields(d.contact)})
  return out


def _scaled_err(x, ref):
  return float((np.abs(x - ref) / np.maximum(1.0, np.abs(ref))).max())


@pytest.fixture(scope='module')
def trajectories():
  jenv = jrunner.BatchedEnv(jsuite.build_task('walker', 'walk'), BATCH)
  jstate = jenv.reset(jax.random.PRNGKey(3))
  # start low enough that most walkers touch the floor from the first
  # substep, so the 50 substeps run through contact rows
  m = jenv.model
  qpos = np.array(jstate.data.qpos)
  qpos[:, m.jnt_qposadr[m.name2id('joint', 'rootz')]] = (
      np.random.RandomState(5).uniform(-1.2, -0.7, BATCH))
  jstate = jstate.replace(data=jstate.data.replace(qpos=jax.numpy.asarray(qpos)))
  env = runner.BatchedEnv(suite.build_task('walker', 'walk', device='cpu'),
                          BATCH, dtype=torch.float64)
  state = runner.RunnerState(
      data=bridge.data_from_numpy(_fields(jstate.data), device='cpu',
                                  dtype=torch.float64),
      step_count=torch.zeros(BATCH, dtype=torch.int32),
      episode_id=torch.zeros(BATCH, dtype=torch.int32))
  actions = np.random.RandomState(11).uniform(-1, 1, (STEPS, BATCH, 6))
  ref, port, contacts = [], [], []
  for a in actions:
    jstate, (jobs, jrew, jdone, _) = jenv.step(jstate, jax.numpy.asarray(a))
    state, (obs, rew, done, _) = env.step(state, torch.tensor(a))
    ref.append(dict(qpos=np.asarray(jstate.data.qpos),
                    qvel=np.asarray(jstate.data.qvel),
                    reward=np.asarray(jrew), done=np.asarray(jdone),
                    **{k: np.asarray(v) for k, v in jobs.items()}))
    contacts.append(state.data.efc_active[:, 6:].any(dim=1).numpy())
    port.append(dict(qpos=state.data.qpos.numpy(),
                     qvel=state.data.qvel.numpy(), reward=rew.numpy(),
                     done=done.numpy(),
                     **{k: v.numpy() for k, v in obs.items()}))
  contacts = np.asarray(contacts)             # (STEPS, BATCH)
  assert contacts.any(axis=1).all() and contacts.any(axis=0).mean() >= 0.5
  return ref, port


@pytest.mark.parametrize('key', ['qpos', 'qvel', 'reward', 'orientations',
                                 'height', 'velocity'])
def test_rollout_matches_jax(trajectories, key):
  ref, port = trajectories
  errs = []
  for t in range(STEPS):
    assert port[t][key].shape == ref[t][key].shape, key
    errs.append(_scaled_err(port[t][key], ref[t][key]))
  print(f'rollout.{key}: max scaled err {max(errs):.2e} over {STEPS} steps')
  for t, err in enumerate(errs):
    assert err <= 1e-6, f'{key} at control step {t}: {err:.2e}'


def test_observation_keys_and_no_resets(trajectories):
  ref, port = trajectories
  assert port[0].keys() == ref[0].keys()
  for t in range(STEPS):
    np.testing.assert_array_equal(port[t]['done'], ref[t]['done'])
    assert not port[t]['done'].any()


def test_batched_env_without_cuda_needs_explicit_cpu():
  if torch.cuda.is_available():
    pytest.skip('a CUDA device is present: the default device is valid')
  with pytest.raises(RuntimeError, match='device="cpu"'):
    runner.BatchedEnv(suite.build_task('walker', 'walk'), 4)


def test_auto_reset_at_time_limit():
  """Lanes that reach the time limit return their terminal step and come
  back as fresh, forward-synced states (qacc_warmstart included)."""
  from dm_control_tpu_torch._src import forward
  task = suite.build_task('walker', 'walk', device='cpu')
  env = runner.BatchedEnv(task, 4, time_limit=0.05, dtype=torch.float64)
  state = env.reset(seed=1)
  first = state.data.qpos.clone()
  a = torch.zeros(4, task.model.nu, dtype=torch.float64)
  state, (_, _, done, _) = env.step(state, a)
  assert not done.any() and env.reset_calls == 0
  state, (_, _, done, discount) = env.step(state, a)
  assert done.all() and (discount == 1).all() and env.reset_calls == 1
  assert (state.step_count == 0).all() and (state.episode_id == 1).all()
  assert (state.data.time == 0).all() and (state.data.qvel == 0).all()
  assert not torch.equal(state.data.qpos, first)
  d = forward.make_data(task.model, 4, torch.float64, 'cpu')
  synced = forward.forward(task.model, d.replace(qpos=state.data.qpos))
  torch.testing.assert_close(state.data.qacc_warmstart,
                             synced.qacc_warmstart, rtol=0, atol=1e-12)
