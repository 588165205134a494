"""The port's velocimeter, gyro, framexaxis and frameyaxis sensors against
the JAX package's, float64 on the CPU.

swimmer6 reads all four (the head's x and y axes of an xbody, and a
velocimeter and a gyro at the head's and every segment's site, besides
two geom framepos), fish a velocimeter and a gyro at its free-floating
torso's site.  Seeded numpy states (fish's root at random orientations)
go through `step1` in both packages; every entry of sensordata agrees to
TOL = 1e-10 scaled by max(1, |ref|).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dm_control_tpu import suite as jsuite
from dm_control_tpu._src import forward as jforward
from dm_control_tpu_torch import suite
from dm_control_tpu_torch._src import forward
from dm_control_tpu_torch._src.types import SensorType

B = 16
TOL = 1e-10


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
