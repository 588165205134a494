"""The port's fluid forces against the JAX package's, float64 on the CPU.

`forward._inertia_box_fluid` (each body's equivalent inertia box, the
quadratic linear and angular drag of the fluid's density, and the viscous
terms) on swimmer6 and on fish, whose free root takes random
orientations: seeded numpy states go through kinematics, com_pos and
com_vel in both packages, and the (B, nv) forces agree to TOL = 1e-10
scaled by max(1, |ref|).  A third case gives swimmer6 a viscosity and a
wind, which no suite model sets, so that every term runs.  The velocity
transform it reads, `math.transform_motion`, is held alone too.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dm_control_tpu._src import engine as jengine
from dm_control_tpu._src import forward as jforward
from dm_control_tpu._src import math as jmath
from dm_control_tpu._src import smooth as jsmooth
from dm_control_tpu.suite import common as jcommon
from dm_control_tpu.suite import swimmer as jswimmer
from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch._src import forward
from dm_control_tpu_torch._src import math
from dm_control_tpu_torch._src import smooth
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.suite import swimmer

B = 16
TOL = 1e-10


def _scaled(x, ref):
  x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
  assert x.shape == ref.shape, (x.shape, ref.shape)
  return float((np.abs(x - ref) / np.maximum(1.0, np.abs(ref))).max(
      initial=0.0))


def _models(case):
  """Fresh JAX and port models of the case (not the suites' cached ones:
  the viscous case edits its options)."""
  if case == 'fish':
    return (jengine.load_model(jcommon.model_path('fish.xml')),
            engine.load_model(common.model_path('fish.xml'), device='cpu'))
  jm = jswimmer._model.__wrapped__(6)
  m = swimmer._model.__wrapped__(6, 'cpu')
  if case == 'swimmer6-viscous':
    jm.opt = dataclasses.replace(jm.opt, viscosity=0.2, wind=(0.3, -0.2, 0.1))
    m.opt = dataclasses.replace(m.opt, viscosity=0.2, wind=(0.3, -0.2, 0.1))
  return jm, m


@pytest.mark.parametrize('case', ['swimmer6', 'fish', 'swimmer6-viscous'])
def test_inertia_box_fluid_matches_jax(case):
  jm, m = _models(case)
  rng = np.random.RandomState(['swimmer6', 'fish',
                               'swimmer6-viscous'].index(case))
  qpos = np.tile(m.qpos0, (B, 1)) + rng.uniform(-1, 1, (B, m.nq))
  if case == 'fish':
    quat = rng.randn(B, 4)
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
  qvel = 2 * rng.randn(B, m.nv)
  d0 = jforward.make_data(jm)

  def one(q, v):
    d = d0.replace(qpos=q, qvel=v)
    d = jsmooth.com_vel(jm, jsmooth.com_pos(jm, jsmooth.kinematics(jm, d)))
    return jforward._inertia_box_fluid(jm, d)

  ref = jax.jit(jax.vmap(one))(jnp.asarray(qpos), jnp.asarray(qvel))
  d = forward.make_data(m, B, torch.float64, 'cpu').replace(
      qpos=torch.tensor(qpos), qvel=torch.tensor(qvel))
  d = smooth.com_vel(m, smooth.com_pos(m, smooth.kinematics(m, d)))
  out = forward._inertia_box_fluid(m, d).numpy()
  err = _scaled(out, ref)
  print(f'{case}: qfrc_fluid max scaled err {err:.2e}, largest |force| '
        f'{np.abs(np.asarray(ref)).max():.3g}')
  assert err <= TOL
  assert np.abs(out).max() > 1e-6


def test_transform_motion_matches_jax():
  rng = np.random.RandomState(5)
  vec, offset = rng.randn(B, 6), rng.randn(B, 3)
  rot = np.linalg.qr(rng.randn(B, 3, 3))[0]
  for r in (None, rot):
    ref = jmath.transform_motion(jnp.asarray(vec), jnp.asarray(offset),
                                 None if r is None else jnp.asarray(r))
    out = math.transform_motion(torch.tensor(vec), torch.tensor(offset),
                                None if r is None else torch.tensor(r))
    assert _scaled(out.numpy(), ref) <= 1e-14
