"""Per-stage parity of the port's walker pipeline with the JAX package.

Both packages start from the same randomized qpos/qvel/ctrl (drawn with
numpy from a seed) at float64 on the CPU and run the same stage chain:
step1 (position, velocity, sensors), the acc stage and the Euler update.
After each stage the fields it writes must agree to 1e-9, scaled by
max(1, |ref|); the constraint solve stops at opt.tolerance, so its
outputs are held to 1e-5, the bound of tests/test_pallas.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dm_control_tpu._src import collision as jcollision
from dm_control_tpu._src import constraint as jconstraint
from dm_control_tpu._src import engine as jengine
from dm_control_tpu._src import forward as jforward
from dm_control_tpu._src import sensor as jsensor
from dm_control_tpu._src import smooth as jsmooth
from dm_control_tpu._src import solver as jsolver
from dm_control_tpu.suite import common as jcommon
from dm_control_tpu_torch import bridge
from dm_control_tpu_torch._src import collision
from dm_control_tpu_torch._src import constraint
from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch._src import forward
from dm_control_tpu_torch._src import sensor
from dm_control_tpu_torch._src import smooth
from dm_control_tpu_torch._src import solver
from dm_control_tpu_torch.suite import common

BATCH = 8


def _posvel_sensors(sens, fwd):
  return lambda m, d: fwd._energy(m, sens.sensors(m, d, stages='posvel'))


# (stage name, JAX stage, port stage, fields it writes, tolerance)
STAGES = [
    ('kinematics', jsmooth.kinematics, smooth.kinematics,
     ('xpos', 'xquat', 'xmat', 'xipos', 'ximat', 'geom_xpos', 'geom_xmat',
      'site_xpos', 'site_xmat', 'xanchor', 'xaxis'), 1e-9),
    ('com_pos', jsmooth.com_pos, smooth.com_pos,
     ('subtree_com', 'cinert', 'cdof'), 1e-9),
    ('crb', jsmooth.crb, smooth.crb, ('qM',), 1e-9),
    ('factor_m', jsmooth.factor_m, smooth.factor_m, ('qLD',), 1e-9),
    ('collide', jcollision.collide, collision.collide,
     ('contact.dist', 'contact.pos', 'contact.frame',
      'contact.includemargin', 'contact.friction', 'contact.solref',
      'contact.solimp', 'contact.geom1', 'contact.geom2', 'contact.body1',
      'contact.body2', 'contact.dim'), 1e-9),
    ('transmission', jsmooth.transmission, smooth.transmission,
     ('actuator_length', 'actuator_moment'), 1e-9),
    ('make_constraint', jconstraint.make_constraint,
     constraint.make_constraint,
     ('efc_J', 'efc_pos', 'efc_margin', 'efc_D', 'efc_aref',
      'efc_frictionloss', 'efc_active'), 1e-9),
    ('com_vel', jsmooth.com_vel, smooth.com_vel, ('cvel', 'cdof_dot'), 1e-9),
    ('rne', jsmooth.rne, smooth.rne, ('qfrc_bias',), 1e-9),
    ('passive', jforward.passive, forward.passive,
     ('qfrc_spring', 'qfrc_damper', 'qfrc_passive'), 1e-9),
    ('sensors', _posvel_sensors(jsensor, jforward),
     _posvel_sensors(sensor, forward), ('sensordata', 'energy'), 1e-9),
    ('actuation', jforward.actuation, forward.actuation,
     ('actuator_velocity', 'actuator_force', 'qfrc_actuator'), 1e-9),
    ('fwd_acceleration', jforward.fwd_acceleration,
     forward.fwd_acceleration, ('qfrc_smooth', 'qacc_smooth'), 1e-9),
    ('solve', jsolver.solve, solver.solve,
     ('qacc', 'efc_force', 'qfrc_constraint', 'qacc_warmstart'), 1e-5),
    ('euler', jforward.euler, forward.euler, ('qpos', 'qvel', 'time'), 1e-9),
]


def _inputs(m, rng):
  """Randomized walker states: random root pose (contacts at many depths),
  limited hinges uniform in range, random velocities and controls."""
  qpos = np.tile(m.qpos0, (BATCH, 1))
  for j in range(m.njnt):
    a = int(m.jnt_qposadr[j])
    if m.jnt_limited[j]:
      lo, hi = m.jnt_range[j]
      qpos[:, a] = rng.uniform(lo, hi, BATCH)
  names = m.names['joint']
  qpos[:, m.jnt_qposadr[names['rootz']]] = rng.uniform(-1.2, -0.7, BATCH)
  qpos[:, m.jnt_qposadr[names['rootx']]] = rng.uniform(-1, 1, BATCH)
  qpos[:, m.jnt_qposadr[names['rooty']]] = rng.uniform(-np.pi, np.pi, BATCH)
  qvel = rng.randn(BATCH, m.nv)
  ctrl = rng.uniform(-1, 1, (BATCH, m.nu))
  return qpos, qvel, ctrl


def _fields(d):
  """Flat numpy dict of a (batched) JAX Data, keyed as the bridge keys it."""
  out = {f.name: np.asarray(getattr(d, f.name))
         for f in dataclasses.fields(d)
         if f.name not in ('contact', 'model_var')}
  out.update({'contact.' + f.name: np.asarray(getattr(d.contact, f.name))
              for f in dataclasses.fields(d.contact)})
  return out


@pytest.fixture(scope='module')
def chains():
  jm = jengine.load_model(jcommon.model_path('walker.xml'))
  pm = engine.load_model(common.model_path('walker.xml'), device='cpu')
  qpos, qvel, ctrl = _inputs(jm, np.random.RandomState(7))

  def jax_chain(q, v, u):
    d = jforward.make_data(jm).replace(qpos=q, qvel=v, ctrl=u)
    outs = []
    for _, jfn, _, _, _ in STAGES:
      d = jfn(jm, d)
      outs.append(d)
    return outs

  ref = jax.jit(jax.vmap(jax_chain))(
      jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(ctrl))
  ref = [_fields(d) for d in ref]

  d = forward.make_data(pm, BATCH, torch.float64, 'cpu')
  d = d.replace(qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
                ctrl=torch.as_tensor(ctrl))
  port = []
  for _, _, pfn, _, _ in STAGES:
    d = pfn(pm, d)
    port.append(bridge.data_to_numpy(d))
  return ref, port


def test_inputs_reach_contacts(chains):
  ref, _ = chains
  active = ref[[s[0] for s in STAGES].index('make_constraint')]['efc_active']
  assert active[:, 6:].any(axis=1).sum() >= BATCH // 2


@pytest.mark.parametrize('i', range(len(STAGES)),
                         ids=[s[0] for s in STAGES])
def test_stage_matches_jax(chains, i):
  ref, port = chains
  name, _, _, fields, tol = STAGES[i]
  for f in fields:
    a, b = ref[i][f], port[i][f]
    assert a.shape == b.shape, (f, a.shape, b.shape)
    if a.dtype.kind in 'bi':
      np.testing.assert_array_equal(b, a, err_msg=f)
      continue
    err = (np.abs(b - a) / np.maximum(1.0, np.abs(a))).max(initial=0.0)
    print(f'{name}.{f}: max scaled err {err:.2e}')
    assert err <= tol, f'{name}.{f}: {err:.2e}'
