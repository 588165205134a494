"""Jaco-arm manipulation tasks (reference: manipulation/reach.py,
lift.py, place.py, bricks.py).

The port of `dm_control_tpu/manipulation/tasks.py`.  Each task composes
a table arena (RK4 at 1 ms), the Jaco j2s7s300 arm (the port's copy of
the model as a composer entity), props (Duplo bricks, boxes, pedestals)
and target sites.  Rewards follow the reference shapes (tolerance on
TCP/prop/target distances, lowest-vertex lift heights, corner
stud-to-hole stacking distances); observations are the feature sets (arm
joints pos/vel, TCP position, target, prop poses, desired order).

Every task function returns a `BatchedEnvironment` of `batch_size` lanes,
or the single-lane `Environment` without one, on `device` (CUDA unless
the caller passes device='cpu').  Each lane's episode state rides its
`Data.model_var`: the target `site_pos`, the pedestal's `body_pos`, the
`lift_target`.  Episode inits draw from the environment's
torch.Generator; each is a `draw` of every random number it takes and an
`apply` of them (`_episode_init`), so that the same draws can be given
to both.

The `_vision` names need a camera observable, which needs the renderer
the port does not have yet: building one raises NotImplementedError.
"""

from __future__ import annotations

import functools
import os
import xml.etree.ElementTree as ET

import numpy as np
import torch

from dm_control_tpu_torch._src import smooth
from dm_control_tpu_torch.composer.entity import Entity
from dm_control_tpu_torch.composer.environment import (BatchedEnvironment,
                                                       Environment)
from dm_control_tpu_torch.composer.observation import ObservableSpec
from dm_control_tpu_torch.composer.task import ComposerTask
from dm_control_tpu_torch.entities import duplo
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import rewards

_CONTROL_TIMESTEP = 0.04   # reference manipulation/shared/constants.py:18
_TIME_LIMIT = 10.0

_TARGET_RADIUS = 0.05      # reference reach.py:65 / place.py:47
_DISTANCE_TO_LIFT = 0.3    # reference lift.py:64
_BOX_SIZE = 0.09           # reference lift.py:53 (too big for pinch grip)
_BOX_MASS = 1.3
_PEDESTAL_RADIUS = 0.07    # reference place.py:48
_PEDESTAL_HEIGHT = 0.2     # reference place.py:85

REGISTRY = {}
TAGS = {}


def _register(name, *tags):
  def deco(fn):
    REGISTRY[name] = fn
    TAGS[name] = tags
    return fn
  return deco


def _arena_xml():
  root = ET.Element('mujoco')
  # the jaco model's own integrator settings (its <option> does not
  # survive the composer merge): RK4 @ 1 ms, jaco_j2s7s300_position.xml:4
  ET.SubElement(root, 'option', dict(
      timestep='0.001', integrator='RK4'))
  wb = ET.SubElement(root, 'worldbody')
  ET.SubElement(wb, 'geom', dict(
      name='table', type='plane', size='1.2 1.2 0.1',
      friction='1 0.005 0.0001'))
  ET.SubElement(wb, 'site', dict(
      name='target', type='sphere', size='0.04', pos='0.2 0.2 0.4',
      rgba='1 0 0 0.4'))
  return Entity(mjcf_root=root, name='arena')


@functools.lru_cache(maxsize=None)
def _jaco_entity():
  """The Jaco arm (the port's copy of jaco_j2s7s300_position.xml) as an
  attachable entity."""
  from dm_control_tpu_torch.mjcf.compiler import _load_xml
  path = common.model_path('jaco_j2s7s300_position.xml')
  root = _load_xml(path)
  # absolutize mesh refs (the fragment's meshdir does not survive the
  # composer merge) and drop the reacher model's own target
  meshdir = ''
  for comp in root.findall('compiler'):
    meshdir = comp.attrib.pop('meshdir', meshdir)
  base = os.path.dirname(path)
  for asset in root.findall('asset'):
    for el in asset:
      if 'file' in el.attrib:
        el.set('file', os.path.join(base, meshdir, el.attrib['file']))
  wb = root.find('worldbody')
  for el in list(wb):
    if el.attrib.get('name') in ('target', 'reach_site'):
      wb.remove(el)
  return Entity(mjcf_root=root, name='jaco')


def _build(props=(), device=None):
  task = ComposerTask(arena=_arena_xml(), control_timestep=_CONTROL_TIMESTEP,
                      device=device)
  task.attach(_jaco_entity())
  for p in props:
    task.attach(p)
  m = task.compile()
  return task, m


# exported names for the bricks module
build_arena_jaco = _build


def _uniform(generator, ref, lo, hi, shape=()):
  """(B, *shape) uniform in [lo, hi) at ref's dtype and device; lo and hi
  broadcast against shape."""
  u = torch.rand((ref.shape[0],) + tuple(shape), generator=generator,
                 dtype=ref.dtype, device=ref.device)
  lo = torch.as_tensor(lo, dtype=ref.dtype, device=ref.device)
  hi = torch.as_tensor(hi, dtype=ref.dtype, device=ref.device)
  return lo + (hi - lo) * u


def _episode_init(draw, apply):
  """An init hook (m, d, generator) -> Data from `draw(d, generator)`,
  the dict of every number the episode draws, (B, ...) each, and
  `apply(m, d, draws)`; both ride the hook as attributes."""
  def init(m_, d, generator):
    return apply(m_, d, draw(d, generator))
  init.draw, init.apply = draw, apply
  return init


def zrot_quat(theta: torch.Tensor) -> torch.Tensor:
  """(..., 4) quaternions of rotations by theta about z."""
  z = torch.zeros_like(theta)
  return torch.stack([torch.cos(theta / 2), z, z, torch.sin(theta / 2)], -1)


class _Common:
  """Index constants and shared observables for one compiled model."""

  def __init__(self, task, m, prop_names=()):
    self.m = m
    self.target_s = m.names['site']['target']
    # TCP: the deepest jaco link body, by sorted name, as the tool
    # reference
    link_names = [n for n in m.names['body'] if 'jaco' in n]
    self.tool_b = m.names['body'][sorted(link_names)[-1]]
    self.arm_q = np.array([int(m.jnt_qposadr[j]) for j in range(m.njnt)
                           if (m.id2name('joint', j) or '').startswith(
                               'jaco/')])
    self.arm_d = np.array([int(m.jnt_dofadr[j]) for j in range(m.njnt)
                           if (m.id2name('joint', j) or '').startswith(
                               'jaco/')])
    self.prop_q = {p: int(m.jnt_qposadr[m.name2id('joint', f'{p}/{p}_root')])
                   for p in prop_names}

    task.add_observable('arm_pos', ObservableSpec(
        fn=lambda m_, d: d.qpos[:, self.arm_q]))
    task.add_observable('arm_vel', ObservableSpec(
        fn=lambda m_, d: d.qvel[:, self.arm_d]))
    task.add_observable('tcp_pos', ObservableSpec(
        fn=lambda m_, d: d.xpos[:, self.tool_b]))
    task.add_observable('target', ObservableSpec(
        fn=lambda m_, d: self.target_pos(m_, d)))
    for p in prop_names:
      adr = self.prop_q[p]
      task.add_observable(f'{p}_pose', ObservableSpec(
          fn=lambda m_, d, a=adr: d.qpos[:, a:a + 7]))

  def target_pos(self, m_, d):
    """(B, 3): each lane's target site position."""
    return smooth.mparam(m_, d, 'site_pos')[..., self.target_s, :].expand(
        d.qpos.shape[0], 3)

  @staticmethod
  def draw_target(d, generator, lo=(-0.2, -0.2, 0.02), hi=(0.2, 0.2, 0.4)):
    return {'target': _uniform(generator, d.qpos, lo, hi, (3,))}

  def randomize_target(self, m_, d, draws):
    site_pos = smooth.mparam(m_, d, 'site_pos').expand(
        (d.qpos.shape[0],) + m_.site_pos.shape).clone()
    site_pos[:, self.target_s] = draws['target']
    return d.replace(model_var=dict(d.model_var or {}, site_pos=site_pos))

  @staticmethod
  def draw_prop(d, generator, r=0.1):
    """A prop's placement draws (reference prop_bbox half-extent 0.1,
    reach.py:46-49): xy uniform in [-r, r), yaw in [-pi, pi)."""
    return {'xy': _uniform(generator, d.qpos, -r, r, (2,)),
            'theta': _uniform(generator, d.qpos, -np.pi, np.pi)}

  def place_prop(self, m_, d, draws, name, z=0.001, yaw=True):
    """The prop on the table at its drawn xy, height z, drawn yaw."""
    adr = self.prop_q[name]
    qpos = d.qpos.clone()
    qpos[:, adr:adr + 2] = draws['xy']
    qpos[:, adr + 2] = z
    if yaw:
      qpos[:, adr + 3:adr + 7] = zrot_quat(draws['theta'])
    return d.replace(qpos=qpos)

  def tcp_to(self, d, pos):
    return torch.linalg.vector_norm(d.xpos[:, self.tool_b] - pos, dim=-1)


def _env(task, batch_size, random, dtype):
  if batch_size:
    return BatchedEnvironment(task, batch_size, time_limit=_TIME_LIMIT,
                              dtype=dtype)
  return Environment(task, time_limit=_TIME_LIMIT, random=random,
                     dtype=dtype)


make_env = _env


# ---------------------------------------------------------------------------
# Reach (reference manipulation/reach.py:68-215)


@_register('reach_site_features', 'features', 'easy')
def reach_site(random=None, batch_size=None, device=None,
               dtype=torch.float32):
  task, m = _build(device=device)
  c = _Common(task, m)
  task.add_init_hook(_episode_init(c.draw_target, c.randomize_target))
  # reference Reach.get_reward (reach.py:151-157): gaussian tolerance
  # with bounds=(0, radius), margin=radius
  task.set_reward(lambda m_, d: rewards.tolerance(
      c.tcp_to(d, c.target_pos(m_, d)),
      (0, _TARGET_RADIUS), margin=_TARGET_RADIUS))
  return _env(task, batch_size, random, dtype)


@_register('reach_duplo_features', 'features', 'easy')
def reach_duplo(random=None, batch_size=None, device=None,
                dtype=torch.float32):
  """Reach to a free Duplo brick (reference reach.py:197-205)."""
  task, m = _build(props=(duplo.duplo_entity('brick0'),), device=device)
  c = _Common(task, m, prop_names=('brick0',))
  adr = c.prop_q['brick0']
  task.add_init_hook(_episode_init(
      c.draw_prop, lambda m_, d, draws: c.place_prop(m_, d, draws, 'brick0')))
  task.set_reward(lambda m_, d: rewards.tolerance(
      c.tcp_to(d, d.qpos[:, adr:adr + 3]),
      (0, _TARGET_RADIUS), margin=_TARGET_RADIUS))
  return _env(task, batch_size, random, dtype)


# ---------------------------------------------------------------------------
# Lift (reference manipulation/lift.py:105-255)


def _box_entity(name='box', half=_BOX_SIZE, mass=_BOX_MASS):
  """A plain box with the 8 vertex sites the Lift reward reads
  (reference lift.py:67-94 _BoxWithVertexSites)."""
  root = ET.Element('mujoco')
  wb = ET.SubElement(root, 'worldbody')
  body = ET.SubElement(wb, 'body', dict(name=name))
  ET.SubElement(body, 'freejoint', dict(name=f'{name}_root'))
  ET.SubElement(body, 'geom', dict(
      name=f'{name}_geom', type='box', size=f'{half} {half} {half}',
      mass=f'{mass}', friction='1.5 0.01 0.001'))
  k = 0
  for sx in (-1, 1):
    for sy in (-1, 1):
      for sz in (-1, 1):
        ET.SubElement(body, 'site', dict(
            name=f'vertex_{k}', type='sphere', size='0.002',
            pos=f'{sx * half} {sy * half} {sz * half}',
            rgba='1 0 0 0.3'))
        k += 1
  return Entity(mjcf_root=root, name=name)


def _lift_task(prop_entity, prop_name, place_z, vertex_prefix,
               random, batch_size, device, dtype):
  """Shared Lift wiring: reward is a linear tolerance on the height of
  the prop's LOWEST bounding vertex above a target set at episode init
  (initial height + 0.3 m), reference lift.py:176-196."""
  task, m = _build(props=(prop_entity,), device=device)
  c = _Common(task, m, prop_names=(prop_name,))
  vids = np.array([m.name2id('site', f'{vertex_prefix}/vertex_{k}')
                   for k in range(8)])

  def lowest(d):
    return d.site_xpos[:, vids, 2].amin(dim=1)

  def apply(m_, d, draws):
    d = smooth.kinematics(m_, c.place_prop(m_, d, draws, prop_name,
                                           z=place_z))
    return d.replace(model_var=dict(
        d.model_var or {}, lift_target=lowest(d) + _DISTANCE_TO_LIFT))

  task.add_init_hook(_episode_init(c.draw_prop, apply))

  def reward(m_, d):
    # tolerance(h, bounds=(target, inf), margin=0.3, value_at_margin=0,
    # sigmoid='linear') with a per-episode target reduces to a clamped
    # linear ramp (reference lift.py:182-187)
    target = (d.model_var or {})['lift_target']
    return torch.clamp(1.0 - (target - lowest(d)) / _DISTANCE_TO_LIFT,
                       0.0, 1.0)

  task.set_reward(reward)
  return _env(task, batch_size, random, dtype)


@_register('lift_brick_features', 'features')
def lift_brick(random=None, batch_size=None, device=None,
               dtype=torch.float32):
  """Lift a Duplo brick (reference lift.py:237-245 lifts a Duplo, not a
  plain box)."""
  return _lift_task(
      duplo.duplo_entity('brick0', vertex_sites=True), 'brick0',
      place_z=0.001, vertex_prefix='brick0', random=random,
      batch_size=batch_size, device=device, dtype=dtype)


@_register('lift_large_box_features', 'features')
def lift_large_box(random=None, batch_size=None, device=None,
                   dtype=torch.float32):
  return _lift_task(
      _box_entity('box'), 'box', place_z=_BOX_SIZE, vertex_prefix='box',
      random=random, batch_size=batch_size, device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Place (reference manipulation/place.py:82-300)


def _pedestal_entity(cradle: str):
  """Static pedestal whose origin is the placement point: a capsule
  column below, a target site at the origin, and either a welded Duplo
  (place_brick) or a 3-sphere cradle (place_cradle) on top (reference
  place.py:44-108)."""
  root = ET.Element('mujoco')
  wb = ET.SubElement(root, 'worldbody')
  body = ET.SubElement(wb, 'body', dict(name='pedestal'))
  ET.SubElement(body, 'geom', dict(
      name='column', type='capsule', size=f'{_PEDESTAL_RADIUS}',
      fromto=f'0 0 {-_PEDESTAL_RADIUS} 0 0 '
             f'{-(_PEDESTAL_HEIGHT + _PEDESTAL_RADIUS)}'))
  ET.SubElement(body, 'site', dict(
      name='target', type='sphere', size=f'{_TARGET_RADIUS}',
      rgba='1 0 0 0.2'))
  if cradle == 'duplo':
    # welded brick on top: its studs are what the free brick clicks onto
    from dm_control_tpu_torch.composer.entity import attach as graft
    brick = duplo.duplo_entity('cradle', color=(0.5, 0.5, 0.5), free=False)
    graft(root, brick, prefix='cradle', site_body='pedestal')
  else:
    sr = _PEDESTAL_RADIUS * 0.7
    for i, ang in enumerate(np.linspace(0, 2 * np.pi, 3, endpoint=False)):
      pos = 0.7 * sr * np.array([np.sin(ang), np.cos(ang), -1.0])
      ET.SubElement(body, 'geom', dict(
          name=f'cradle_{i}', type='sphere', size=f'{sr}', condim='6',
          pos=f'{pos[0]} {pos[1]} {pos[2]}'))
  return Entity(mjcf_root=root, name='pedestal')


def _place_task(cradle, random, batch_size, device, dtype):
  """Reference Place.get_reward (place.py:214-240): weighted mix of
  in_place (prop at the pedestal target) with grasp/hand-away shaping."""
  prop = duplo.duplo_entity('brick0')
  task, m = _build(props=(prop, _pedestal_entity(cradle)), device=device)
  c = _Common(task, m, prop_names=('brick0',))
  adr = c.prop_q['brick0']
  ped_b = m.name2id('body', 'pedestal/pedestal')
  target_s = m.name2id('site', 'pedestal/target')

  task.add_observable('pedestal_position', ObservableSpec(
      fn=lambda m_, d: d.site_xpos[:, target_s]))

  def draw(d, generator):
    return dict(c.draw_prop(d, generator), pedestal=_uniform(
        generator, d.qpos, [-0.1, -0.1, _PEDESTAL_RADIUS],
        [0.1, 0.1, _PEDESTAL_RADIUS + 0.1], (3,)))

  def apply(m_, d, draws):
    d = c.place_prop(m_, d, draws, 'brick0', z=0.001)
    # the pedestal's pose rides the body_pos overlay (a static body)
    body_pos = smooth.mparam(m_, d, 'body_pos').expand(
        (d.qpos.shape[0],) + m_.body_pos.shape).clone()
    body_pos[:, ped_b] = draws['pedestal']
    return d.replace(model_var=dict(d.model_var or {}, body_pos=body_pos))

  task.add_init_hook(_episode_init(draw, apply))

  def reward(m_, d):
    target = d.site_xpos[:, target_s]
    obj = d.qpos[:, adr:adr + 3]
    tcp = d.xpos[:, c.tool_b]
    dist = functools.partial(torch.linalg.vector_norm, dim=-1)
    grasp = rewards.tolerance(
        dist(obj - tcp), (0, _TARGET_RADIUS),
        margin=_TARGET_RADIUS, sigmoid='long_tail')
    in_place = rewards.tolerance(
        dist(obj - target), (0, _TARGET_RADIUS),
        margin=_TARGET_RADIUS, sigmoid='long_tail')
    hand_away = rewards.tolerance(
        dist(tcp - target), (4 * _TARGET_RADIUS, np.inf),
        margin=3 * _TARGET_RADIUS, sigmoid='long_tail')
    grasp_or_away = grasp * (1 - in_place) + hand_away * in_place
    return (grasp_or_away + 10.0 * in_place) / 11.0

  task.set_reward(reward)
  return _env(task, batch_size, random, dtype)


@_register('place_brick_features', 'features')
def place_brick(random=None, batch_size=None, device=None,
                dtype=torch.float32):
  return _place_task('duplo', random, batch_size, device, dtype)


@_register('place_cradle_features', 'features')
def place_cradle(random=None, batch_size=None, device=None,
                 dtype=torch.float32):
  return _place_task('cradle', random, batch_size, device, dtype)


# ---------------------------------------------------------------------------
# Stack / reassemble families (see bricks.py)


def _register_bricks():
  from dm_control_tpu_torch.manipulation import bricks as B

  stack_cfgs = {
      'stack_2_bricks': dict(num_bricks=2, target_height=2,
                             moveable_base=False, randomize_order=False),
      'stack_2_bricks_moveable_base': dict(
          num_bricks=2, target_height=2, moveable_base=True,
          randomize_order=False),
      'stack_3_bricks': dict(num_bricks=3, target_height=3,
                             moveable_base=False, randomize_order=False),
      'stack_3_bricks_random_order': dict(
          num_bricks=3, target_height=3, moveable_base=False,
          randomize_order=True),
      'stack_2_of_3_bricks_random_order': dict(
          num_bricks=3, target_height=2, moveable_base=False,
          randomize_order=True),
  }
  for name, cfg in stack_cfgs.items():
    REGISTRY[f'{name}_features'] = functools.partial(B.stack, **cfg)
    TAGS[f'{name}_features'] = ('features', 'hard')

  re_cfgs = {
      'reassemble_3_bricks_fixed_order': dict(
          num_bricks=3, randomize_initial_order=False,
          randomize_desired_order=False),
      'reassemble_5_bricks_random_order': dict(
          num_bricks=5, randomize_initial_order=True,
          randomize_desired_order=True),
  }
  for name, cfg in re_cfgs.items():
    REGISTRY[f'{name}_features'] = functools.partial(B.reassemble, **cfg)
    TAGS[f'{name}_features'] = ('features', 'hard')


_register_bricks()


# ---------------------------------------------------------------------------
# Vision variants


# every reference feature task has a vision twin EXCEPT
# stack_3_bricks_random_order (manipulation registry)
_NO_VISION = {'stack_3_bricks_random_order_features'}


def _register_vision_variants():
  """<name>_vision: the feature task plus a rendered 'pixels' observable
  (reference manipulation registry's vision tags).  The JAX package
  renders it with its raytracer through `camera_observable`; the port has
  no renderer yet, so these raise."""
  def make(vname):
    def factory(*args, **kwargs):
      raise NotImplementedError(
          f'{vname} needs the renderer (a camera observable over '
          f'render.render), which is not ported yet; its _features twin '
          f'runs')
    return factory
  for name in list(REGISTRY):
    if name.endswith('_features') and name not in _NO_VISION:
      vname = name[:-len('_features')] + '_vision'
      REGISTRY[vname] = make(vname)
      TAGS[vname] = tuple(t for t in TAGS[name] if t != 'features'
                          ) + ('vision',)


_register_vision_variants()
