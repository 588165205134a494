"""The port's sensors against the JAX package's, float64 on the CPU.

subtreeangmom (dog's torso_angmom): a small tree built in the test, a
free torso with hinged and ball-jointed limbs of skewed inertia, at seeded
states through `step1`; every entry within TOL.

The rangefinder: escape's 20 at states on the terrain (a field per lane
in model_var), and `render.raycast` alone on rays that hit the terrain,
the floor or a geom, pass a body they exclude, or hit nothing.

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


def _escape(n, rng):
  """escape's models and n lanes' states in numpy: a terrain per lane
  (`test_torch_domains.escape_terrain`), the body upright at random
  headings and a few degrees of tilt, at the bowl's middle or out on its
  slope, 0.3-0.8 m over the terrain."""
  from test_torch_domains import escape_terrain, terrain_height
  jm = jsuite.build_task('quadruped', 'escape').model
  m = suite.build_task('quadruped', 'escape', device='cpu').model
  hdata = escape_terrain(jm, rng.uniform(0.15, 1.0, (n, 30, 30)))
  qpos = np.tile(m.qpos0, (n, 1))
  yaw = rng.uniform(-np.pi, np.pi, n)
  tilt = rng.uniform(-0.1, 0.1, (n, 2))
  quat = np.stack([np.cos(yaw / 2), tilt[:, 0], tilt[:, 1], np.sin(yaw / 2)],
                  -1)
  qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
  r = np.where(np.arange(n) % 2 == 0, rng.uniform(0, 1, n),
               rng.uniform(3, 9, n))
  ang = rng.uniform(-np.pi, np.pi, n)
  qpos[:, :2] = r[:, None] * np.stack([np.cos(ang), np.sin(ang)], -1)
  qpos[:, 2] = (np.maximum(terrain_height(jm, hdata, qpos[:, :2]), 0.0)
                + rng.uniform(0.3, 0.8, n))
  return jm, m, qpos, hdata


@pytest.fixture(scope='module')
def escape_rays():
  """escape's 16 lanes (`_escape`) after kinematics in the port, and the
  JAX package's `render.raycast` of each lane's 20 rangefinder rays (from
  its site along the site's z axis, the torso unseen) and of six more
  rays: straight down onto the terrain or the floor, straight up into
  nothing, at the torso from 2 m out (a geom hit) and the same ray with
  the torso unseen (it goes on to what lies behind), level over the bowl
  towards its rim (the heightfield's march over a long way), and straight
  down onto the floor past the terrain's edge (the plane alone).  Rays
  that see every body go in one vmapped cast, rays that do not see the
  torso in another."""
  from dm_control_tpu._src import render as jrender
  from dm_control_tpu._src import smooth as jsmooth
  from dm_control_tpu_torch._src import smooth
  jm, m, qpos, hdata = _escape(B, np.random.RandomState(30))
  torso = m.name2id('body', 'torso')
  rf = [s for s in range(m.nsensor)
        if SensorType(int(m.sensor_type[s])) == SensorType.RANGEFINDER]
  sites = np.asarray([int(m.sensor_objid[s]) for s in rf])
  assert len(rf) == 20 and (m.site_bodyid[sites] == torso).all()
  d = smooth.kinematics(m, forward.make_data(m, B, torch.float64, 'cpu')
                        .replace(qpos=torch.tensor(qpos),
                                 model_var={'hfield_data':
                                            torch.tensor(hdata)}))
  rng = np.random.RandomState(32)
  ang = rng.uniform(-np.pi, np.pi, B)
  flat = np.stack([np.cos(ang), np.sin(ang), np.zeros(B)], -1)
  high = np.concatenate([rng.uniform(-12, 12, (B, 2)), np.full((B, 1), 8.0)],
                        -1)
  past = high + [50.0, 0.0, 0.0]
  down, up = np.tile([0.0, 0, -1], (B, 1)), np.tile([0.0, 0, 1], (B, 1))
  above = np.concatenate([qpos[:, :2], qpos[:, 2:3] + 0.3], -1)
  at = qpos[:, :3] + 2.0 * flat
  origins = np.stack([high, high, at, at, above, past], 1)
  dirs = np.stack([down, up, -flat, -flat, flat, down], 1)
  excl = np.array([-1, -1, -1, torso, -1, -1])
  d0 = jforward.make_data(jm)

  def jcast(q, hd, o, v, o_t, v_t):
    jd = jsmooth.kinematics(jm, d0.replace(qpos=q,
                                           model_var={'hfield_data': hd}))
    cast = lambda body: jax.vmap(lambda a, b: jrender.raycast(
        jm, jd, a, b, exclude_body=body))
    sx, sm = jd.site_xpos[sites], jd.site_xmat[sites][:, :, 2]
    return (cast(-1)(o, v), cast(torso)(o_t, v_t),
            cast(torso)(jnp.concatenate([sx]), sm))

  seen, unseen, sensed = jax.jit(jax.vmap(jcast))(*[jnp.asarray(a) for a in (
      qpos, hdata, origins[:, excl < 0], dirs[:, excl < 0],
      origins[:, excl >= 0], dirs[:, excl >= 0])])
  ref = np.zeros((B, len(excl)))
  ref[:, excl < 0], ref[:, excl >= 0] = np.asarray(seen), np.asarray(unseen)
  return dict(m=m, d=d, rf=rf, sensed=np.asarray(sensed), origins=origins,
              dirs=dirs, excl=excl, ref=ref)


def test_rangefinder_matches_jax(escape_rays):
  """escape's 20 rangefinders (all rays cast at once) through the port's
  posvel sensors: each one's distance equals the JAX package's raycast of
  its ray (its sensor's definition, `escape_rays`) to TOL, -1 where the
  ray hits nothing; some rays hit the terrain."""
  from dm_control_tpu_torch._src import sensor
  m, d, rf = escape_rays['m'], escape_rays['d'], escape_rays['rf']
  out = sensor.sensors(m, d, 'posvel').sensordata.numpy()
  out = out[:, [int(m.sensor_adr[s]) for s in rf]]
  ref = escape_rays['sensed']
  err = float((np.abs(out - ref) / np.maximum(1.0, np.abs(ref))).max())
  print(f'rangefinder: {int((ref > 0).sum())} of {ref.size} rays hit, '
        f'max scaled err {err:.2e}')
  assert err <= TOL
  assert (ref > 0).any()


def test_raycast_hit_miss_geom_and_hfield_match_jax(escape_rays):
  """render.raycast against the JAX package's on escape's 16 lanes and
  six rays each (`escape_rays`): every distance agrees to TOL; the rays
  down hit, the rays up miss (-1), the ray at the torso hits it within
  2 m (or a leg before it), the same ray with the torso unseen hits
  something no nearer, or nothing, some level rays reach the bowl's rim,
  and past the terrain the ray down meets the floor 8 m below."""
  from dm_control_tpu_torch._src import render
  r = escape_rays
  out = render.raycast(r['m'], r['d'], torch.tensor(r['origins']),
                       torch.tensor(r['dirs']),
                       exclude_body=r['excl']).numpy()
  ref = r['ref']
  err = float((np.abs(out - ref) / np.maximum(1.0, np.abs(ref))).max())
  print(f'raycast: hits per ray {(ref > 0).sum(0).tolist()} of {B}; max '
        f'scaled err {err:.2e}')
  assert err <= TOL
  assert (ref[:, 0] > 0).all() and (ref[:, 1] == -1).all()
  assert ((ref[:, 2] > 0) & (ref[:, 2] < 2.0)).all()
  assert ((ref[:, 3] >= ref[:, 2]) | (ref[:, 3] == -1)).all()
  assert (ref[:, 3] != ref[:, 2]).any()
  assert (ref[:, 4] > 0).any()
  np.testing.assert_allclose(ref[:, 5], 8.0, rtol=1e-12)


ANGMOM_XML = """<mujoco>
  <worldbody>
    <body name="torso" pos="0 0 1"><freejoint/>
      <geom type="box" size=".2 .1 .05" mass="3"/>
      <body name="arm" pos=".2 0 0">
        <joint name="shoulder" type="hinge" axis="0 1 .3"/>
        <geom type="capsule" fromto="0 0 0 .3 0 .1" size=".03" mass=".7"/>
        <body name="hand" pos=".3 0 .1">
          <joint name="wrist" type="ball"/>
          <geom type="ellipsoid" size=".05 .02 .04" mass=".2"/>
        </body>
      </body>
      <body name="leg" pos="-.2 0 -.05">
        <joint name="hip" type="hinge" axis="1 0 0"/>
        <geom type="cylinder" fromto="0 0 0 0 .05 -.3" size=".04" mass="1"/>
      </body>
    </body>
  </worldbody>
  <sensor>
    <subtreeangmom body="torso"/>
    <subtreeangmom body="arm"/>
    <subtreeangmom body="hand"/>
    <subtreelinvel body="arm"/>
  </sensor>
</mujoco>"""


def test_subtreeangmom_matches_jax():
  """subtreeangmom of the whole tree, of a limb and of a leaf, beside the
  subtreelinvel it reads, on a small model at seeded states (random
  orientations, joint angles and velocities) through `step1`: every
  entry of sensordata within TOL scaled by max(1, |ref|)."""
  from dm_control_tpu._src import engine as jengine
  from dm_control_tpu_torch._src import engine
  jm = jengine.load_model_from_string(ANGMOM_XML)
  m = engine.load_model_from_string(ANGMOM_XML, device='cpu')
  assert [SensorType(int(t)) for t in m.sensor_type].count(
      SensorType.SUBTREEANGMOM) == 3
  rng = np.random.RandomState(12)
  qpos = np.tile(m.qpos0, (B, 1))
  for q in (3, 8):                                 # the free and ball quats
    quat = rng.randn(B, 4)
    qpos[:, q:q + 4] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
  qpos[:, [7, 12]] = rng.uniform(-2, 2, (B, 2))
  qpos[:, :3] = rng.uniform(-1, 1, (B, 3))
  qvel = 2 * rng.randn(B, m.nv)
  d0 = jforward.make_data(jm)
  ref = jax.jit(jax.vmap(lambda q, v: jforward.step1(
      jm, d0.replace(qpos=q, qvel=v)).sensordata))(jnp.asarray(qpos),
                                                   jnp.asarray(qvel))
  d = forward.step1(m, forward.make_data(m, B, torch.float64, 'cpu').replace(
      qpos=torch.tensor(qpos), qvel=torch.tensor(qvel)))
  out, ref = d.sensordata.numpy(), np.asarray(ref)
  assert out.shape == ref.shape == (B, 12)
  err = np.abs(out - ref) / np.maximum(1.0, np.abs(ref))
  print(f'subtreeangmom: sensordata max scaled err {err.max():.2e}')
  assert err.max() <= TOL
  assert (np.abs(ref[:, :9]) > 1e-3).all(axis=0).any()
