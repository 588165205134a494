"""The port's sensors against the JAX package's, float64 on the CPU.

The velocimeter, gyro, framexaxis and frameyaxis sensors:

swimmer6 reads all four (the head's x and y axes of an xbody, and a
velocimeter and a gyro at the head's and every segment's site, besides
two geom framepos), fish a velocimeter and a gyro at its free-floating
torso's site.  Seeded numpy states (fish's root at random orientations)
go through `step1` in both packages; every entry of sensordata agrees to
TOL = 1e-10 scaled by max(1, |ref|).

The acc-stage sensors: humanoid (accelerometer, force, torque and touch
sensors, besides subtreelinvel, velocimeter and gyro) and quadruped
(accelerometer, force, torque and subtreecom) at seeded states lying or
standing on the floor, their free roots low and at random orientations,
through `forward` (the solve included): every entry of sensordata agrees
to ACC_TOL = 1e-8 scaled by max(1, |ref|), and `rne_postconstraint`'s
cacc and cfrc_int to ACC_TOL scaled by max(1, the lane's largest |ref|):
they sum the constraint forces of a Newton solve that stops at
opt.tolerance, so an entry carries the rounding of the lane's largest
wrench (the world's, ~1e5 on a fallen quadruped).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dm_control_tpu import suite as jsuite
from dm_control_tpu._src import forward as jforward
from dm_control_tpu._src import sensor as jsensor
from dm_control_tpu_torch import suite
from dm_control_tpu_torch._src import forward
from dm_control_tpu_torch._src import sensor
from dm_control_tpu_torch._src.types import SensorType

B = 16
TOL = 1e-10
ACC_TOL = 1e-8


@pytest.mark.parametrize('domain,task_name', [('swimmer', 'swimmer6'),
                                              ('fish', 'swim')])
def test_sensors_match_jax(domain, task_name):
  jm = jsuite.build_task(domain, task_name).model
  m = suite.build_task(domain, task_name, device='cpu').model
  types = {SensorType(int(t)) for t in m.sensor_type}
  assert {SensorType.VELOCIMETER, SensorType.GYRO} <= types
  if domain == 'swimmer':
    assert {SensorType.FRAMEXAXIS, SensorType.FRAMEYAXIS} <= types
  rng = np.random.RandomState(8)
  qpos = np.tile(m.qpos0, (B, 1)) + rng.uniform(-1, 1, (B, m.nq))
  if domain == 'fish':
    quat = rng.randn(B, 4)
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
  qvel = 2 * rng.randn(B, m.nv)
  d0 = jforward.make_data(jm)
  ref = jax.jit(jax.vmap(lambda q, v: jforward.step1(
      jm, d0.replace(qpos=q, qvel=v)).sensordata))(jnp.asarray(qpos),
                                                   jnp.asarray(qvel))
  d = forward.step1(m, forward.make_data(m, B, torch.float64, 'cpu').replace(
      qpos=torch.tensor(qpos), qvel=torch.tensor(qvel)))
  out, ref = d.sensordata.numpy(), np.asarray(ref)
  assert out.shape == ref.shape == (B, m.nsensordata)
  err = np.abs(out - ref) / np.maximum(1.0, np.abs(ref))
  for s in range(m.nsensor):
    adr, dim = int(m.sensor_adr[s]), int(m.sensor_dim[s])
    e = float(err[:, adr:adr + dim].max())
    assert e <= TOL, (SensorType(int(m.sensor_type[s])).name, s, e)
  print(f'{domain}: {m.nsensor} sensors, sensordata max scaled err '
        f'{err.max():.2e}')
  assert np.abs(out).min(axis=0).max() > 0


@pytest.mark.parametrize('domain,task_name', [('humanoid', 'run'),
                                              ('quadruped', 'walk')])
def test_acc_sensors_match_jax(domain, task_name):
  jm = jsuite.build_task(domain, task_name).model
  m = suite.build_task(domain, task_name, device='cpu').model
  types = {SensorType(int(t)) for t in m.sensor_type}
  assert {SensorType.ACCELEROMETER, SensorType.FORCE,
          SensorType.TORQUE} <= types
  assert (SensorType.TOUCH if domain == 'humanoid'
          else SensorType.SUBTREECOM) in types
  rng = np.random.RandomState(9)
  qpos = np.tile(m.qpos0, (B, 1))
  for j in range(1, m.njnt):
    qpos[:, m.jnt_qposadr[j]] = rng.uniform(*m.jnt_range[j], B)
  quat = rng.randn(B, 4)
  qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
  qpos[:, 2] = rng.uniform(0.1, 0.4, B)
  qvel = rng.randn(B, m.nv)
  ctrl = rng.uniform(-1, 1, (B, m.nu))
  act = rng.uniform(-1, 1, (B, m.na))
  d0 = jforward.make_data(jm)

  def jfwd(q, v, u, a):
    d = jforward.forward(jm, d0.replace(qpos=q, qvel=v, ctrl=u, act=a))
    return (d.sensordata,) + jsensor.rne_postconstraint(jm, d)

  refs = jax.jit(jax.vmap(jfwd))(*map(jnp.asarray, (qpos, qvel, ctrl, act)))
  t = lambda x: torch.tensor(x)
  d = forward.forward(m, forward.make_data(m, B, torch.float64, 'cpu')
                      .replace(qpos=t(qpos), qvel=t(qvel), ctrl=t(ctrl),
                               act=t(act)))
  outs = (d.sensordata,) + sensor.rne_postconstraint(m, d)
  err = lambda o, r: np.abs(o - r) / np.maximum(1.0, np.abs(r))
  lane_err = lambda o, r: np.abs(o - r).reshape(B, -1).max(1) / np.maximum(
      1.0, np.abs(r).reshape(B, -1).max(1))
  for name, o, r in zip(('sensordata', 'cacc', 'cfrc_int'), outs, refs):
    o, r = o.numpy(), np.asarray(r)
    assert o.shape == r.shape, name
    e = (err if name == 'sensordata' else lane_err)(o, r).max()
    print(f'{domain}: {name} max scaled err {e:.2e}'
          f'{"" if name == "sensordata" else " (lane-scaled)"}')
    assert e <= ACC_TOL, name
  e = err(outs[0].numpy(), np.asarray(refs[0]))
  for s in range(m.nsensor):
    adr, dim = int(m.sensor_adr[s]), int(m.sensor_dim[s])
    assert e[:, adr:adr + dim].max() <= ACC_TOL, (
        SensorType(int(m.sensor_type[s])).name, s)
  # the floor pushes on most lanes: active contacts, touch sensors on
  assert (d.contact.dist < d.contact.includemargin).any(1).double().mean(
  ) >= 0.75
  touch = [s for s in range(m.nsensor)
           if SensorType(int(m.sensor_type[s])) == SensorType.TOUCH]
  if touch:
    cols = [int(m.sensor_adr[s]) for s in touch]
    assert (outs[0][:, cols] > 0).any()
