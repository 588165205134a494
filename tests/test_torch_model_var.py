"""Per-lane `model_var` through every copy of the integration state, float64
on the CPU: `forward.state_of`, the bridge, `base.select_collision_free`,
BatchedEnv's auto-reset of fresh lanes (reacher's target `geom_pos`) and
its reset pool (finger-turn's target `site_pos`, an expensive init;
insert_ball's target and cup `body_pos` and `body_quat`; escape's
terrain `hfield_data`, which the collider and the rangefinders read per
lane).
"""

import numpy as np
import torch

from dm_control_tpu_torch import bridge
from dm_control_tpu_torch import suite
from dm_control_tpu_torch._src import forward
from dm_control_tpu_torch.parallel import runner
from dm_control_tpu_torch.suite import base

BATCH = 8


def test_state_of_carries_model_var_by_key():
  """state_of holds the lanes' model_var as a dict, {} where the task sets
  none; map_state and state_items go into it by name."""
  walker = suite.build_task('walker', 'walk', device='cpu')
  d = forward.make_data(walker.model, 2, torch.float64, 'cpu')
  assert forward.state_of(d)['model_var'] == {}
  env = runner.BatchedEnv(suite.build_task('reacher', 'easy', device='cpu'),
                          BATCH, dtype=torch.float64)
  st = forward.state_of(env.reset(seed=1).data)
  assert st['model_var'].keys() == {'geom_pos'}
  assert st['model_var']['geom_pos'].shape == (BATCH,) + tuple(
      env.model.geom_pos.shape)
  half = forward.map_state(lambda x: x[:3], st)
  assert half['model_var']['geom_pos'].shape[0] == 3
  names = dict(forward.state_items(st))
  assert 'model_var.geom_pos' in names and 'qpos' in names
  assert 'model_var' not in names


def test_bridge_round_trip_keeps_model_var():
  env = runner.BatchedEnv(
      suite.build_task('finger', 'turn_easy', device='cpu'), 4,
      dtype=torch.float64)
  d = env.reset(seed=2).data
  fields = bridge.data_to_numpy(d)
  assert fields['model_var.site_pos'].shape == (4,) + tuple(
      env.model.site_pos.shape)
  back = bridge.data_from_numpy(fields, device='cpu', dtype=torch.float32)
  assert back.model_var['site_pos'].dtype == torch.float32
  np.testing.assert_array_equal(back.model_var['site_pos'].double().numpy(),
                                d.model_var['site_pos'].float().double())


def test_select_collision_free_takes_each_lanes_model_var():
  """Each lane keeps the model_var of the candidate it takes."""
  m = suite.build_task('finger', 'turn_easy', device='cpu').model
  d = forward.make_data(m, 4, torch.float64, 'cpu')
  rng = np.random.RandomState(0)
  cands = []
  for k in range(3):
    qpos = torch.tensor(np.tile(m.qpos0, (4, 1)))
    sp = torch.tensor(rng.randn(4, m.nsite, 3))
    cands.append(d.replace(qpos=qpos + k, model_var={'site_pos': sp}))
  out = base.select_collision_free(m, cands)
  touch = torch.stack([base.has_contacts(m, c) for c in cands])
  free = ~touch
  take = torch.where(free.any(0), free.int().argmax(0), len(cands) - 1)
  for lane, k in enumerate(take.tolist()):
    assert torch.equal(out.model_var['site_pos'][lane],
                       cands[k].model_var['site_pos'][lane])
    assert torch.equal(out.qpos[lane], cands[k].qpos[lane])


def test_auto_reset_takes_fresh_geom_pos():
  """reacher (fresh init per reset): with an episode limit of 2 control
  steps every lane resets at the second; each lane then holds the target
  geom_pos its fresh init_states drew (the same generator state drawn
  again) and no longer its old one."""
  task = suite.build_task('reacher', 'easy', device='cpu')
  env = runner.BatchedEnv(task, BATCH, time_limit=0.04, dtype=torch.float64)
  state = env.reset(seed=3)
  a = torch.zeros(BATCH, task.model.nu, dtype=torch.float64)
  state, (_, _, done, _) = env.step(state, a)
  assert not done.any()
  old = state.data.model_var['geom_pos'].clone()
  drawn = env.generator.get_state()
  state, (_, _, done, _) = env.step(state, a)
  assert done.all() and env.reset_calls == 1
  env.generator.set_state(drawn)
  fresh = env.init_states(BATCH)
  new = state.data.model_var['geom_pos']
  assert torch.equal(new, fresh.model_var['geom_pos'])
  assert torch.equal(state.data.qpos, fresh.qpos)
  target = task.model.name2id('geom', 'target')
  assert bool((new[:, target] != old[:, target]).any(-1).all())


def test_reset_pool_carries_site_pos():
  """finger-turn (expensive init): with an episode limit of 3 control
  steps every lane resets from the pool at the third; each lane then holds
  its pool entry's target site_pos (runner.pool_index) with the rest of
  the entry, and not its own old one."""
  task = suite.build_task('finger', 'turn_easy', device='cpu')
  env = runner.BatchedEnv(task, BATCH, time_limit=0.06, dtype=torch.float64)
  state = env.reset(seed=4)
  pool = state.reset_pool
  assert pool['model_var'].keys() == {'site_pos'}
  old = state.data.model_var['site_pos'].clone()
  a = torch.zeros(BATCH, task.model.nu, dtype=torch.float64)
  for _ in range(3):
    state, (_, _, done, _) = env.step(state, a)
  assert done.all() and env.reset_calls == 0
  idx = runner.pool_index(torch.zeros(BATCH, dtype=torch.int32),
                          torch.arange(BATCH), BATCH)
  for name, x in forward.state_items(forward.state_of(state.data)):
    want = dict(forward.state_items(pool))[name][idx]
    assert torch.equal(x, want), name
  s_target = task.model.name2id('site', 'target')
  moved = idx != torch.arange(BATCH)
  new = state.data.model_var['site_pos'][:, s_target]
  assert moved.any()
  assert bool((new[moved] != old[moved, s_target]).any(-1).all())


def test_reset_pool_carries_body_pose():
  """manipulator-insert_ball (expensive init): each lane's reset draws the
  target's and the cup's pose, the same per lane in body_pos (x and z)
  and body_quat (a rotation about y), which the kinematics places (the cup's
  xpos and xquat); the pose goes through the bridge at float32 and, with
  an episode limit of 2 control steps, every lane resets from the pool at
  the second, holding its pool entry's body_pos and body_quat with the
  rest of the entry, and no longer its own old ones."""
  task = suite.build_task('manipulator', 'insert_ball', device='cpu')
  m = task.model
  env = runner.BatchedEnv(task, BATCH, time_limit=0.02, dtype=torch.float64)
  state = env.reset(seed=5)
  mv = state.data.model_var
  assert mv.keys() == {'body_pos', 'body_quat'}
  target, cup = m.name2id('body', 'target_ball'), m.name2id('body', 'cup')
  xz = lambda b: mv['body_pos'][:, b][:, [0, 2]]
  assert torch.equal(xz(cup), xz(target))
  assert torch.equal(mv['body_quat'][:, cup], mv['body_quat'][:, target])
  quat = mv['body_quat'][:, target]
  assert bool((quat[:, [1, 3]] == 0).all())
  assert len(set(quat[:, 2].tolist())) == BATCH
  torch.testing.assert_close(state.data.xpos[:, cup], mv['body_pos'][:, cup],
                             rtol=0, atol=1e-12)
  torch.testing.assert_close(state.data.xquat[:, cup], quat, rtol=0,
                             atol=1e-12)
  fields = bridge.data_to_numpy(state.data)
  back = bridge.data_from_numpy(fields, device='cpu', dtype=torch.float32)
  for k in ('body_pos', 'body_quat'):
    np.testing.assert_array_equal(back.model_var[k].double().numpy(),
                                  mv[k].float().double())
  old = {k: v.clone() for k, v in mv.items()}
  pool = state.reset_pool
  a = torch.zeros(BATCH, m.nu, dtype=torch.float64)
  for _ in range(2):
    state, (_, _, done, _) = env.step(state, a)
  assert done.all() and env.reset_calls == 0
  idx = runner.pool_index(torch.zeros(BATCH, dtype=torch.int32),
                          torch.arange(BATCH), BATCH)
  for name, x in forward.state_items(forward.state_of(state.data)):
    assert torch.equal(x, dict(forward.state_items(pool))[name][idx]), name
  moved = idx != torch.arange(BATCH)
  assert moved.any()
  for k in ('body_pos', 'body_quat'):
    new = state.data.model_var[k][:, target]
    assert bool((new[moved] != old[k][moved, target]).any(-1).all()), k


def test_reset_pool_carries_hfield_data():
  """quadruped-escape (expensive init): each lane draws a terrain of its
  own (B, 201 * 201), the bowl times bumps in [0.15, 1] upsampled by a
  cubic (whose overshoot stays well within [0, 1.25]), on which its body
  settles clear of contact; the
  terrain goes through the bridge at float32; with an episode limit of 2
  control steps every lane resets from the pool at the second, holding its
  pool entry's hfield_data with the rest of the entry and no longer its
  own; and a lane's contacts and rangefinders read its own terrain (a
  lane given another's terrain sees other heights)."""
  from dm_control_tpu_torch._src import sensor
  from dm_control_tpu_torch._src import smooth
  task = suite.build_task('quadruped', 'escape', device='cpu')
  m = task.model
  B = 4
  env = runner.BatchedEnv(task, B, time_limit=0.04, dtype=torch.float64)
  state = env.reset(seed=6)
  hd = state.data.model_var['hfield_data']
  assert hd.shape == (B, int(m.hfield_nrow[0] * m.hfield_ncol[0]))
  assert bool((hd >= 0).all() and (hd <= 1.25).all())
  assert all(not torch.equal(hd[i], hd[j]) for i in range(B)
             for j in range(i))
  assert not bool(base.has_contacts(m, state.data).any())
  fields = bridge.data_to_numpy(state.data)
  back = bridge.data_from_numpy(fields, device='cpu', dtype=torch.float32)
  np.testing.assert_array_equal(back.model_var['hfield_data'].double().numpy(),
                                hd.float().double())
  d = smooth.kinematics(m, state.data)
  rf = sensor.sensors(m, d, 'posvel').sensordata
  swapped = sensor.sensors(m, d.replace(
      model_var={'hfield_data': hd.roll(1, 0)}), 'posvel').sensordata
  assert not torch.equal(rf, swapped)
  old = hd.clone()
  pool = state.reset_pool
  a = torch.zeros(B, m.nu, dtype=torch.float64)
  for _ in range(2):
    state, (_, _, done, _) = env.step(state, a)
  assert done.all() and env.reset_calls == 0
  idx = runner.pool_index(torch.zeros(B, dtype=torch.int32), torch.arange(B),
                          B)
  for name, x in forward.state_items(forward.state_of(state.data)):
    assert torch.equal(x, dict(forward.state_items(pool))[name][idx]), name
  new = state.data.model_var['hfield_data']
  moved = idx != torch.arange(B)
  assert moved.any()
  assert bool((new[moved] != old[moved]).any(-1).all())
