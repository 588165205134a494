"""The port's entity tier, transformations, IK and initializers against the
JAX package, float64 on the CPU.

  * `utils/transformations`: every function on seeded random inputs (all
    seven Euler orderings both ways) within TRANS_TOL of the JAX
    package's.
  * `composer/colors`: hsv_to_rgb against colorsys and the JAX package;
    the variations' constant channels and per-lane draws.
  * The Jaco arm and hand (`JacoArm`, `JacoHand` on a floor arena): the
    composed Model equal to the JAX package's, the joint bounds, the
    observables, `set_grasp`, `randomize_arm_joints` by its bounds; the
    IK (`ToolCenterPointInitializer`, position only, and
    `qpos_from_site_pose` with an orientation) from the same states to
    the same targets within IK_TOL of the JAX package's solution;
    `set_site_to_xpos` reaching a point with its retries.
  * `PropPlacer` with constant poses against the JAX package's; with
    drawn positions, every lane's placement drawn apart from the others,
    within the ranges and free of contacts where a free draw exists.
  * `Primitive` and `PositionDetector`: the composed Model, the
    observables and the detector (2-D, 3-D, inverted) against the JAX
    package's on the same states.
  * The Duplo pair scene (`duplo_utils`): its Model equal to the JAX
    package's, the clicked pair's sites, and 50 physics steps of two
    lanes pulled up at 1 N and 16 N within TOL of the JAX package's.
"""

import colorsys
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dm_control_tpu._src import forward as jforward
from dm_control_tpu.composer import colors as jcolors
from dm_control_tpu.composer import initializers as jinitializers
from dm_control_tpu.composer.task import ComposerTask as JComposerTask
from dm_control_tpu.entities import duplo_utils as jduplo_utils
from dm_control_tpu.entities import manipulators as jmanipulators
from dm_control_tpu.entities import props as jprops
from dm_control_tpu.locomotion import arenas as jarenas
from dm_control_tpu.manipulation import tasks as jtasks
from dm_control_tpu.utils import inverse_kinematics as jik
from dm_control_tpu.utils import transformations as jtr
from dm_control_tpu_torch._src import forward
from dm_control_tpu_torch.composer import colors
from dm_control_tpu_torch.composer import initializers
from dm_control_tpu_torch.composer import variation
from dm_control_tpu_torch.composer.task import ComposerTask
from dm_control_tpu_torch.entities import duplo
from dm_control_tpu_torch.entities import duplo_utils
from dm_control_tpu_torch.entities import manipulators
from dm_control_tpu_torch.entities import props
from dm_control_tpu_torch.locomotion import arenas
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.utils import inverse_kinematics as ik
from dm_control_tpu_torch.utils import transformations as tr
from test_torch_domains import TOL, _fields, _scaled
from test_torch_model import SETCONST_FIELDS, _assert_same

TRANS_TOL = 1e-12
IK_TOL = 1e-8


def _same_model(jm, m, what):
  for f in [f.name for f in dataclasses.fields(jm)]:
    a, b = getattr(jm, f), getattr(m, f)
    if f in SETCONST_FIELDS:
      assert _scaled(b, a) <= 1e-12, (what, f)
    else:
      _assert_same(f'{what} {f}', a, b)


# -- transformations ----------------------------------------------------------


def _quats(rng, n):
  q = rng.randn(n, 4)
  return q / np.linalg.norm(q, axis=1, keepdims=True)


def _rmats(rng, n):
  return np.asarray(jtr.quat_to_mat3(jnp.asarray(_quats(rng, n))))


_ORDERINGS = ('XYZ', 'XYX', 'XZY', 'ZYX', 'YZX', 'ZXY', 'YXZ')
# name -> (function name, inputs from a RandomState)
_TRANSFORMS = {
    'quat_conj': ('quat_conj', lambda r: (_quats(r, 8),)),
    'quat_mul': ('quat_mul', lambda r: (_quats(r, 8), _quats(r, 8))),
    'quat_rotate': ('quat_rotate', lambda r: (_quats(r, 8), r.randn(8, 3))),
    'quat_to_mat3': ('quat_to_mat3', lambda r: (_quats(r, 8),)),
    'mat3_to_quat': ('mat3_to_quat', lambda r: (_rmats(r, 8),)),
    'quat_inv': ('quat_inv', lambda r: (r.randn(8, 4),)),
    'quat_diff': ('quat_diff', lambda r: (_quats(r, 8), _quats(r, 8))),
    'quat_dist': ('quat_dist', lambda r: (_quats(r, 8), _quats(r, 8))),
    'quat_angle': ('quat_angle', lambda r: (_quats(r, 8),)),
    'quat_axis': ('quat_axis', lambda r: (_quats(r, 8),)),
    'axisangle_to_quat': ('axisangle_to_quat', lambda r: (np.concatenate(
        [r.randn(7, 3), np.zeros((1, 3))]),)),
    'quat_to_axisangle': ('quat_to_axisangle', lambda r: (_quats(r, 8),)),
    'quat_to_mat': ('quat_to_mat', lambda r: (_quats(r, 8),)),
    'mat_to_quat': ('mat_to_quat', lambda r: (np.asarray(jtr.quat_to_mat(
        jnp.asarray(_quats(r, 8)))),)),
    'quat_slerp': ('quat_slerp', lambda r: (_quats(r, 8), _quats(r, 8),
                                            r.uniform(0, 1, (8, 1)))),
    'quat_log': ('quat_log', lambda r: (_quats(r, 8),)),
    'rotation_x_axis': ('rotation_x_axis', lambda r: (r.uniform(-3, 3, 8),)),
    'rotation_y_axis full': (
        'rotation_y_axis', lambda r: (r.uniform(-3, 3, 8), True)),
    'rotation_z_axis full': (
        'rotation_z_axis', lambda r: (r.uniform(-3, 3, 8), True)),
    'rotation_matrix_2d': ('rotation_matrix_2d',
                           lambda r: (r.uniform(-3, 3, 8),)),
    'pos_quat_to_hmat': ('pos_quat_to_hmat',
                         lambda r: (r.randn(8, 3), _quats(r, 8))),
    'hmat_inv': ('hmat_inv', lambda r: (np.asarray(jtr.pos_quat_to_hmat(
        jnp.asarray(r.randn(8, 3)), jnp.asarray(_quats(r, 8)))),)),
}
for _o in _ORDERINGS:
  _TRANSFORMS[f'euler_to_rmat {_o}'] = (
      'euler_to_rmat', lambda r, o=_o: (r.uniform(-1.2, 1.2, (8, 3)), o))
  _TRANSFORMS[f'euler_to_quat {_o}'] = (
      'euler_to_quat', lambda r, o=_o: (r.uniform(-1.2, 1.2, (8, 3)), o))
  _TRANSFORMS[f'rmat_to_euler {_o}'] = (
      'rmat_to_euler', lambda r, o=_o: (_rmats(r, 8), o))
  _TRANSFORMS[f'quat_to_euler {_o}'] = (
      'quat_to_euler', lambda r, o=_o: (_quats(r, 8), o))


@pytest.mark.parametrize('name', list(_TRANSFORMS))
def test_transformation_matches_jax(name):
  fn, make = _TRANSFORMS[name]
  args = make(np.random.RandomState(len(name)))
  ref = getattr(jtr, fn)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                           else a for a in args])
  out = getattr(tr, fn)(*[torch.tensor(a) if isinstance(a, np.ndarray)
                          else a for a in args])
  assert tuple(out.shape) == np.shape(ref), name
  err = float(np.abs(out.numpy() - np.asarray(ref)).max())
  print(f'{name}: max abs err {err:.2e}')
  assert err <= TRANS_TOL, (name, err)


# -- colors --------------------------------------------------------------------


def test_colors_match_colorsys_and_jax():
  grid = np.array(np.meshgrid(np.linspace(0, 1, 13), [0.0, 0.4, 1.0],
                              [0.2, 1.0], indexing='ij')).reshape(3, -1)
  got = np.stack([x.numpy() for x in colors.hsv_to_rgb(
      *[torch.tensor(g) for g in grid])], -1)
  want = np.array([colorsys.hsv_to_rgb(*c) for c in grid.T])
  ref = np.stack([np.asarray(x) for x in jcolors.hsv_to_rgb(
      *[jnp.asarray(g) for g in grid])], -1)
  np.testing.assert_allclose(got, want, atol=1e-12)
  np.testing.assert_allclose(got, ref, atol=1e-12)
  gen = torch.Generator().manual_seed(0)
  rgba = colors.RgbVariation(r=variation.Uniform(0.2, 0.4, shape=(6,)),
                             g=0.5, b=0.75)(gen)
  assert rgba.shape == (6, 4) and len(set(rgba[:, 0].tolist())) == 6
  assert bool(((rgba[:, 0] >= 0.2) & (rgba[:, 0] <= 0.4)).all())
  np.testing.assert_allclose(rgba[:, 1:].numpy(), [[0.5, 0.75, 1.0]] * 6)
  np.testing.assert_allclose(colors.GrayVariation(0.3)(gen).numpy(),
                             [0.3, 0.3, 0.3, 1.0])
  hsv = colors.HsvVariation(1 / 3, 1.0, 1.0, alpha=0.5)(gen)
  np.testing.assert_allclose(hsv.numpy(), [0.0, 1.0, 0.0, 0.5], atol=1e-7)


# -- the Jaco arm and hand -------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _arm_pair():
  """(JAX task, model, arm; port task, model, arm): JacoArm on a floor
  arena.  The JAX package's JacoArm adds its sites to the cached jaco
  fragment its manipulation tasks share; that cache is cleared after."""
  try:
    jarm = jmanipulators.JacoArm()
    jtask = JComposerTask(arena=jarenas.floor(size=(4.0, 4.0),
                                              timestep=0.005),
                          control_timestep=0.02)
    jtask.attach(jarm)
    jm = jtask.compile()
  finally:
    jtasks._jaco_entity.cache_clear()
  arm = manipulators.JacoArm()
  task = ComposerTask(arena=arenas.floor(size=(4.0, 4.0), timestep=0.005),
                      control_timestep=0.02, device='cpu')
  task.attach(arm)
  return jtask, jm, jarm, task, task.compile(), arm


def _arm_states(jm, m, n, seed):
  """n states of the arm: its joints uniform in the sampling bounds."""
  _, _, jarm, _, _, arm = _arm_pair()
  bounds = arm.joint_pos_sampling_bounds(m)
  qs, _ = arm.joint_addrs(m)
  qpos = np.tile(np.asarray(jm.qpos0), (n, 1))
  qpos[:, qs] = np.random.RandomState(seed).uniform(*bounds, (n, len(qs)))
  d0 = jforward.make_data(jm)
  jd = jax.vmap(lambda q: d0.replace(qpos=q))(jnp.asarray(qpos))
  d = forward.make_data(m, n, torch.float64, 'cpu').replace(
      qpos=torch.tensor(qpos))
  return jd, d


def test_jaco_arm_and_hand_match_jax():
  jtask, jm, jarm, task, m, arm = _arm_pair()
  _same_model(jm, m, 'jaco arm')
  assert list(task.observables) == list(jtask.observables) == [
      'jaco/joints_pos', 'jaco/joints_vel']
  assert arm.attachment_site == 'jaco/wrist_site'
  hand = manipulators.JacoHand()
  assert hand.tool_center_point == 'jaco/pinch_site'
  np.testing.assert_array_equal(arm.joint_pos_sampling_bounds(m),
                                jarm.joint_pos_sampling_bounds(jm))
  for a, b in zip(arm.joint_addrs(m), jarm.joint_addrs(jm)):
    np.testing.assert_array_equal(a, b)
  jd, d = _arm_states(jm, m, 4, 0)
  jd = jax.vmap(lambda x: jforward.forward(jm, x))(jd)
  d = bridge_data(jd)
  for k, spec in task.observables.items():
    ref = jax.vmap(lambda x, f=jtask.observables[k].fn: f(jm, x))(jd)
    assert _scaled(spec.fn(m, d).numpy(), ref) <= TRANS_TOL, k
  jhand = jmanipulators.JacoHand()
  for close in (0.0, 0.3, 1.0, [0.1, 0.5, 0.9]):
    ref = jax.vmap(lambda x: jhand.set_grasp(jm, x, close))(jd)
    np.testing.assert_array_equal(hand.set_grasp(m, d, close).qpos.numpy(),
                                  np.asarray(ref.qpos))
  per_lane = torch.rand((4, 3), generator=torch.Generator().manual_seed(1),
                        dtype=torch.float64)
  shut = hand.set_grasp(m, d, per_lane).qpos
  fq = [int(m.jnt_qposadr[m.name2id('joint', f'jaco/{n}')])
        for n in manipulators._FINGER_JOINTS]
  np.testing.assert_allclose(shut[:, fq].numpy(), 1.1 * per_lane.numpy(),
                             atol=1e-15)
  d1 = arm.randomize_arm_joints(m, d, torch.Generator().manual_seed(2))
  qs, _ = arm.joint_addrs(m)
  q = d1.qpos[:, qs].numpy()
  lo, hi = arm.joint_pos_sampling_bounds(m)
  assert (q >= lo).all() and (q <= hi).all()
  assert len({tuple(r) for r in np.round(q, 9)}) == 4


def bridge_data(jd):
  from dm_control_tpu_torch import bridge
  return bridge.data_from_numpy(_fields(jd), 'cpu', torch.float64)


def test_ik_matches_jax():
  """The TCP initializer (position only, 30 steps) and qpos_from_site_pose
  with an orientation target (100 steps) from the same 3 arm states to
  the same targets: qpos within IK_TOL (scaled) of the JAX package's."""
  jtask, jm, jarm, task, m, arm = _arm_pair()
  jd, d = _arm_states(jm, m, 3, 3)
  site = 'jaco/pinch_site'
  target = np.array([0.3, 0.2, 0.4])
  _, ds = arm.joint_addrs(m)
  mask = np.zeros(m.nv, bool)
  mask[ds] = True
  jinit = jinitializers.ToolCenterPointInitializer(site, tuple(target),
                                                   joint_mask=mask)
  init = initializers.ToolCenterPointInitializer(site, tuple(target),
                                                 joint_mask=mask)
  jq = jax.jit(jax.vmap(lambda x: jinit(jm, x, jax.random.PRNGKey(0))))(jd)
  q = init(m, d, torch.Generator()).qpos
  errs = {'tcp': _scaled(q.numpy(), jq.qpos)}
  # an orientation target: a pose of the arm reached by forward kinematics
  goal = jax.vmap(lambda x: jforward.forward(jm, x))(_arm_states(
      jm, m, 3, 4)[0])
  sid = jm.name2id('site', site)
  goal_pos = np.asarray(goal.site_xpos[:, sid])
  goal_quat = np.asarray(jtr.mat_to_quat(goal.site_xmat[:, sid]))
  jres = jax.jit(jax.vmap(lambda x, p, qt: jik.qpos_from_site_pose(
      jm, x, site, target_pos=p, target_quat=qt, joint_mask=mask,
      rot_weight=2.0).qpos))(jd, jnp.asarray(goal_pos), jnp.asarray(goal_quat))
  res = ik.qpos_from_site_pose(m, d, site, target_pos=torch.tensor(goal_pos),
                               target_quat=torch.tensor(goal_quat),
                               joint_mask=mask, rot_weight=2.0)
  errs['pose'] = _scaled(res.qpos.numpy(), jres)
  print(f'IK: max scaled err {errs}; pose error per lane '
        f'{res.err_norm.tolist()}')
  assert all(e <= IK_TOL for e in errs.values()), errs
  # 30 steps from these starts reach the target on two lanes and come
  # within 5 mm on the third, in both packages
  reached = forward.forward(m, d.replace(qpos=q)).site_xpos[
      :, m.name2id('site', site)]
  miss = (reached - torch.tensor(target)).norm(dim=-1)
  assert int((miss < 1e-6).sum()) >= 2 and float(miss.max()) < 5e-3, miss


def test_set_site_to_xpos_reaches_target():
  _, _, _, task, m, arm = _arm_pair()
  d = forward.forward(m, forward.make_data(m, 2, torch.float64, 'cpu'))
  target = torch.tensor([[0.3, 0.2, 0.4], [-0.2, 0.3, 0.5]],
                        dtype=torch.float64)
  d_ik, ok = arm.set_site_to_xpos(m, d, torch.Generator().manual_seed(2),
                                  'jaco/pinch_site', target, target_quat=None)
  site = m.name2id('site', 'jaco/pinch_site')
  err = (forward.forward(m, d_ik).site_xpos[:, site] - target).norm(dim=-1)
  print(f'set_site_to_xpos: errors {err.tolist()}')
  assert bool(ok.all()) and float(err.max()) < 1e-3


# -- the prop placer ------------------------------------------------------------


_PROP_ARENA = """<mujoco><option timestep="0.005"/><worldbody>
  <geom name="floor" type="plane" size="2 2 .1"/>
  <geom name="post" type="box" size=".3 .3 .3" pos="0 0 .3"/>
</worldbody></mujoco>"""


def _placer_tasks():
  from dm_control_tpu.composer.entity import Entity as JEntity
  from dm_control_tpu_torch.composer.entity import Entity
  out = []
  for task_cls, entity_cls, p in ((JComposerTask, JEntity, jprops),
                                  (ComposerTask, Entity, props)):
    kw = {} if task_cls is JComposerTask else dict(device='cpu')
    task = task_cls(arena=entity_cls.from_xml_string(_PROP_ARENA, 'arena'),
                    control_timestep=0.01, **kw)
    task.attach(p.Primitive('sphere', (0.1,), name='ball'))
    out.append((task, task.compile()))
  return out


def test_prop_placer_matches_jax_and_keeps_free_draws():
  (jtask, jm), (task, m) = _placer_tasks()
  adr = int(m.jnt_qposadr[m.name2id('joint', 'ball/ball_root')])
  pose = ((0.5, -0.5, 0.2), (0.0, 0.0, 0.0, 1.0))
  jplacer = jinitializers.PropPlacer([adr], *pose, max_attempts=3)
  placer = initializers.PropPlacer([adr], *pose, max_attempts=3)
  d0 = jforward.make_data(jm)
  jd = jax.jit(jax.vmap(lambda k: jplacer(jm, d0, k)))(
      jax.random.split(jax.random.PRNGKey(0), 2))
  d = placer(m, forward.make_data(m, 2, torch.float64, 'cpu'),
             torch.Generator())
  np.testing.assert_array_equal(d.qpos.numpy(), np.asarray(jd.qpos))
  # drawn positions over a range that overlaps the post: 16 lanes, each
  # placed apart from the others and free of contacts
  placer = initializers.PropPlacer(
      [adr], position=(variation.Uniform(-0.6, 0.6),
                       variation.Uniform(-0.6, 0.6), 0.15),
      quaternion=variation.UniformQuaternion(), max_attempts=20)
  d = placer(m, forward.make_data(m, 16, torch.float64, 'cpu'),
             torch.Generator().manual_seed(5))
  xy = d.qpos[:, adr:adr + 2]
  assert len({tuple(r) for r in np.round(xy.numpy(), 9)}) == 16
  assert float(xy.abs().max()) <= 0.6
  assert bool((d.qpos[:, adr + 2] == 0.15).all())
  np.testing.assert_allclose(d.qpos[:, adr + 3:adr + 7].norm(dim=-1).numpy(),
                             1.0, atol=1e-12)
  assert not bool(base.has_contacts(m, d).any())
  # one attempt keeps its first draw, in contact or not
  one = initializers.PropPlacer([adr], position=(variation.Uniform(-0.6, 0.6),
                                                 0.0, 0.15), max_attempts=1)
  d = one(m, forward.make_data(m, 64, torch.float64, 'cpu'),
          torch.Generator().manual_seed(6))
  assert bool(base.has_contacts(m, d).any())


# -- primitives and the position detector ---------------------------------------


def test_primitive_and_position_detector_match_jax():
  (jtask, jm), (task, m) = _placer_tasks()
  _same_model(jm, m, 'primitive')
  assert list(task.observables) == list(jtask.observables)
  with pytest.raises(ValueError):
    props.Primitive('box', (0.1,))
  with pytest.raises(ValueError):
    props.Primitive('cone', (0.1,))
  with pytest.raises(ValueError):
    props.PositionDetector(pos=(0, 0), size=(1, 1, 1))
  rng = np.random.RandomState(7)
  n = 16
  qpos = np.tile(np.asarray(jm.qpos0), (n, 1))
  qpos[:, :3] = rng.uniform(-1, 1, (n, 3))
  qpos[:, 3:7] = _quats(rng, n)
  qvel = rng.randn(n, jm.nv)
  d0 = jforward.make_data(jm)
  jd = jax.vmap(lambda q, v: jforward.forward(jm, d0.replace(qpos=q, qvel=v)))(
      jnp.asarray(qpos), jnp.asarray(qvel))
  d = bridge_data(jd)
  for k, spec in task.observables.items():
    ref = jax.vmap(lambda x, f=jtask.observables[k].fn: f(jm, x))(jd)
    np.testing.assert_array_equal(spec.fn(m, d).numpy(), np.asarray(ref))
  body = m.name2id('body', 'ball/ball')
  for kw in (dict(pos=(0.0, 0.0), size=(0.5, 0.5)),
             dict(pos=(0.2, 0.0, 0.1), size=(0.6, 0.5, 0.4)),
             dict(pos=(0.0, 0.3), size=(0.5, 0.4), inverted=True)):
    det, jdet = props.PositionDetector(**kw), jprops.PositionDetector(**kw)
    got = det.detected(m, d, body).numpy()
    ref = np.asarray(jax.vmap(lambda x: jdet.detected(jm, x, body))(jd))
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < n, kw
    np.testing.assert_array_equal(det.observable(body).fn(m, d).numpy(),
                                  got[:, None].astype(np.float64))
  assert det.site_entity().mjcf_root.find('worldbody/geom') is not None


# -- the Duplo pair scene ---------------------------------------------------------


def test_duplo_pair_scene_matches_jax():
  jm = jduplo_utils.build_pair_scene()
  m = duplo_utils.build_pair_scene(device='cpu')
  _same_model(jm, m, 'duplo pair')
  d, top_q = duplo_utils.clicked_data(m, 2)
  jd, jtop_q = jduplo_utils.clicked_data(jm)
  assert top_q == jtop_q
  studs, holes = duplo.corner_site_ids(m, 'top')
  np.testing.assert_allclose(d.site_xpos[0, studs, 2].numpy(),
                             2 * duplo.STUD_Z - duplo.HOLE_Z, atol=1e-12)
  np.testing.assert_allclose(d.site_xpos[0, holes, 2].numpy(), duplo.STUD_Z,
                             atol=1e-12)
  forces = np.array([1.0, 16.0])
  top_b = m.name2id('body', 'top/top')
  xfrc = d.xfrc_applied.clone()
  xfrc[:, top_b, 2] = torch.tensor(forces)
  d = d.replace(xfrc_applied=xfrc)
  step = jax.jit(jax.vmap(lambda x: jax.lax.scan(
      lambda c, _: (jforward.step(jm, c), c.qpos), x, None, length=50)[1]))
  jq = step(jax.vmap(lambda f: jd.replace(
      xfrc_applied=jd.xfrc_applied.at[top_b, 2].set(f)))(jnp.asarray(forces)))
  err = 0.0
  for t in range(50):
    err = max(err, _scaled(d.qpos.numpy(), jq[:, t]))
    d = forward.step(m, d)
  print(f'duplo pair, 50 physics steps at 1 N and 16 N: max scaled err '
        f'{err:.2e}; top brick rise {(d.qpos[:, top_q + 2] - duplo.STACK_DZ).tolist()}')
  assert err <= TOL
  assert int(d.efc_active[0].sum()) > 0
