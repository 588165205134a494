"""Duplo-brick manipulation families: stack / reassemble
(reference: manipulation/bricks.py:89-714).

The port of `dm_control_tpu/manipulation/bricks.py`.  Every episode-level
quantity is per lane:

* The desired stack order is a per-lane permutation carried in
  `Data.model_var['duplo_order']` (int32, as in the JAX package; the
  reference shuffles in `initialize_episode_mjcf`, bricks.py:253-263).
* The fixed-base brick is not a model edit (the reference removes its
  freejoint, bricks.py:511-528): every brick keeps a freejoint and an
  `after_substep` hook re-pins the base brick's qpos/qvel each substep, a
  weld implemented as a projection, so one compiled model serves both
  moveable- and fixed-base episodes and every lane can pin a different
  brick (`duplo_pin`, `duplo_pin_qpos`).
* Goal-hint bricks are contactless static bodies (reference
  bricks.py:536-566 `_hintify`) posed per episode through the model_var
  `body_pos`/`body_quat` overlay instead of model surgery.
* The stacking reward is the reference's shaped close/clicked mix over
  corner stud-to-hole distances (bricks.py:415-463), computed from
  `site_xpos` with per-lane gathers over the order.

The episode inits are, as in `tasks.py`, a `draw` and an `apply`.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np
import torch

from dm_control_tpu_torch._src import math as _math
from dm_control_tpu_torch._src import smooth
from dm_control_tpu_torch._src.types import mirror
from dm_control_tpu_torch.composer.entity import Entity
from dm_control_tpu_torch.composer.observation import ObservableSpec
from dm_control_tpu_torch.entities import duplo
from dm_control_tpu_torch.utils import rewards
from dm_control_tpu_torch.utils import transformations as tr

# reference bricks.py:67-72
_CLOSE_THRESHOLD = 0.01
_CLICK_THRESHOLD = 0.001

# reference shared/workspaces + bricks.py:55-64
_PROP_BBOX_LO = (-0.1, -0.1, 1e-6)
_PROP_BBOX_HI = (0.1, 0.1, 1e-6)
_GOAL_HINT_POS = np.array([0.2, 0.1, 0.0])
_GOAL_HINT_QUAT = np.array([-0.38268343, 0.0, 0.0, 0.92387953])

# reference bricks.py:75-83 color cycle
COLORS = [(1., 0., 0.), (0., 1., 0.), (0., 0., 1.),
          (0., 1., 1.), (1., 0., 1.), (1., 1., 0.)]

_ZROT_PI = np.array([0.0, 0.0, 0.0, 1.0])  # 180 deg about z


def _zrot_quat(theta):
  from dm_control_tpu_torch.manipulation.tasks import zrot_quat
  return zrot_quat(theta)


def _lanes(ref: torch.Tensor) -> torch.Tensor:
  return torch.arange(ref.shape[0], device=ref.device)


class BrickSet:
  """Index state for n bricks + n goal hints in one compiled model."""

  def __init__(self, task, m, num_bricks):
    self.n = num_bricks
    self.names = [f'brick{i}' for i in range(num_bricks)]
    self.qadr = np.array(
        [int(m.jnt_qposadr[m.name2id('joint', f'{n}/{n}_root')])
         for n in self.names])
    self.dadr = np.array(
        [int(m.jnt_dofadr[m.name2id('joint', f'{n}/{n}_root')])
         for n in self.names])
    self.studs = np.stack(
        [duplo.corner_site_ids(m, n)[0] for n in self.names])  # (n, 2)
    self.holes = np.stack(
        [duplo.corner_site_ids(m, n)[1] for n in self.names])
    self.hint_bids = np.array(
        [m.name2id('body', f'hint{i}/hint{i}') for i in range(num_bricks)])
    self._m = m

    for i, name in enumerate(self.names):
      adr = self.qadr[i]
      task.add_observable(f'{name}_pose', ObservableSpec(
          fn=lambda m_, d, a=adr: d.qpos[:, a:a + 7]))

  # -- reward ---------------------------------------------------------------

  def pair_distance(self, d, bottom, top):
    """Reference `_min_stud_to_hole_distance` (bricks.py:420-430): sum of
    the two corner stud->hole distances, minimized over the brick's
    180-degree symmetry.  bottom and top: (B,) brick indices, or ints."""
    ref = d.qpos
    lanes = _lanes(ref)[:, None]
    studs, holes = (mirror(self._m, ref, a) for a in (self.studs,
                                                      self.holes))
    sp = d.site_xpos[lanes, studs[bottom].expand(ref.shape[0], 2)]
    hp = d.site_xpos[lanes, holes[top].expand(ref.shape[0], 2)]
    dist = torch.linalg.vector_norm
    d1 = dist(sp[:, 0] - hp[:, 0], dim=-1) + dist(sp[:, 1] - hp[:, 1], dim=-1)
    d2 = dist(sp[:, 1] - hp[:, 0], dim=-1) + dist(sp[:, 0] - hp[:, 1], dim=-1)
    return torch.minimum(d1, d2)

  def stacking_reward(self, d, order, target_height, close_coef=0.1):
    """Reference `_get_pairwise_stacking_rewards` (bricks.py:432-463);
    order: (B, >= target_height)."""
    dists = torch.stack([
        self.pair_distance(d, order[:, k], order[:, k + 1])
        for k in range(target_height - 1)], -1)
    close = rewards.tolerance(dists, (0, _CLOSE_THRESHOLD),
                              margin=10 * _CLOSE_THRESHOLD)
    clicked = rewards.tolerance(dists, (0, _CLICK_THRESHOLD),
                                margin=_CLICK_THRESHOLD)
    return ((close_coef * close + clicked) / (close_coef + 1.0)).mean(-1)

  # -- episode state --------------------------------------------------------

  def brick_qpos(self, d):
    """(B, n, 7): every brick's freejoint qpos."""
    return torch.stack([d.qpos[:, a:a + 7] for a in self.qadr], 1)

  def set_brick_qpos(self, d, i, pose7):
    """Set brick `i`'s freejoint qpos to pose7 (B, 7); i: an int or a (B,)
    index per lane."""
    i = torch.as_tensor(i, device=d.qpos.device)
    qpos = d.qpos.clone()
    for j, a in enumerate(self.qadr):
      hit = (i == j).expand(d.qpos.shape[0])[:, None]
      qpos[:, a:a + 7] = torch.where(hit, pose7, qpos[:, a:a + 7])
    return d.replace(qpos=qpos)

  def pin_base(self, m, d, base_idx):
    """Record the pin: base brick index one-hot (B, n) + its current pose
    (B, 7)."""
    ref = d.qpos
    onehot = torch.arange(self.n, device=ref.device) == base_idx[:, None]
    mv = dict(d.model_var or {})
    mv['duplo_pin'] = onehot.to(ref.dtype)
    mv['duplo_pin_qpos'] = self.brick_qpos(d)[_lanes(ref), base_idx]
    return d.replace(model_var=mv)

  def no_pin(self, m, d):
    ref = d.qpos
    mv = dict(d.model_var or {})
    mv['duplo_pin'] = ref.new_zeros((ref.shape[0], self.n))
    mv['duplo_pin_qpos'] = ref.new_zeros((ref.shape[0], 7))
    return d.replace(model_var=mv)

  def pin_project(self, m, d):
    """after_substep projection: snap each lane's pinned brick back to its
    weld pose (the replacement for freejoint removal)."""
    mv = d.model_var or {}
    if 'duplo_pin' not in mv:
      return d
    pin = mv['duplo_pin']
    pin_qpos = mv['duplo_pin_qpos'].to(d.qpos.dtype)
    qpos, qvel = d.qpos.clone(), d.qvel.clone()
    for i in range(self.n):
      qa, da = self.qadr[i], self.dadr[i]
      w = (pin[:, i] > 0)[:, None]
      qpos[:, qa:qa + 7] = torch.where(w, pin_qpos, qpos[:, qa:qa + 7])
      qvel[:, da:da + 6] = torch.where(w, 0.0, qvel[:, da:da + 6])
    return d.replace(qpos=qpos, qvel=qvel)

  def set_order(self, d, order, length):
    mv = dict(d.model_var or {})
    mv['duplo_order'] = order[:, :length].to(torch.int32)
    return d.replace(model_var=mv)

  # -- stack geometry -------------------------------------------------------

  def stack_poses(self, flips, base_pos, base_quat, length):
    """Analytic pose chain for a clicked stack (reference `_build_stack`,
    bricks.py:468-509): level k >= 1 is rotated 180 degrees about z from
    the one below where flips[:, k] (B, length) bool, and positioned so
    its hole_00 (or hole_13 when flipped) lands on the stud_00 of the
    brick below.  Returns (B, length, 7) poses by rank."""
    ref = base_pos
    poses = [torch.cat([base_pos, base_quat], -1)]
    stud_local = mirror(self._m, ref, duplo.STUD_00_LOCAL)
    hole00 = mirror(self._m, ref, duplo.HOLE_00_LOCAL)
    hole13 = mirror(self._m, ref, duplo.HOLE_13_LOCAL)
    zpi = mirror(self._m, ref, _ZROT_PI)
    for k in range(1, length):
      bpos, bquat = poses[k - 1][:, :3], poses[k - 1][:, 3:]
      stud_world = bpos + _math.quat_rotate(bquat, stud_local)
      flip = flips[:, k, None]
      quat = torch.where(flip, tr.quat_mul(bquat, zpi), bquat)
      hole_local = torch.where(flip, hole13, hole00)
      pos = stud_world - _math.quat_rotate(quat, hole_local)
      poses.append(torch.cat([pos, quat], -1))
    return torch.stack(poses, 1)

  def place_hints(self, m, d, flips, order, length):
    """Pose the goal-hint bricks as a stack in the desired order at the
    fixed goal-hint corner (reference bricks.py:280-287); park the unused
    ones (2-of-3 tasks) out of the scene."""
    ref = d.qpos
    B = ref.shape[0]
    poses = self.stack_poses(
        flips, mirror(m, ref, _GOAL_HINT_POS).expand(B, 3),
        mirror(m, ref, _GOAL_HINT_QUAT).expand(B, 4), length)
    body_pos = smooth.mparam(m, d, 'body_pos').expand(
        (B,) + m.body_pos.shape).clone()
    body_quat = smooth.mparam(m, d, 'body_quat').expand(
        (B,) + m.body_quat.shape).clone()
    bids = mirror(m, ref, self.hint_bids)
    lanes = _lanes(ref)
    for k in range(length):
      body_pos[lanes, bids[order[:, k]]] = poses[:, k, :3]
      body_quat[lanes, bids[order[:, k]]] = poses[:, k, 3:]
    for i in range(self.n):
      used = (order[:, :length] == i).any(-1)[:, None]
      bid = int(self.hint_bids[i])
      body_pos[:, bid] = torch.where(used, body_pos[:, bid],
                                     ref.new_tensor([0., 0., -1.]))
    mv = dict(d.model_var or {}, body_pos=body_pos, body_quat=body_quat)
    return d.replace(model_var=mv)

  def build_stack(self, m, d, draws, order, length):
    """Physically assemble bricks[order] into a clicked stack at the drawn
    base position and yaw, with the drawn flips."""
    poses = self.stack_poses(draws['stack_flips'], draws['base_pos'],
                             _zrot_quat(draws['theta']), length)
    for k in range(length):
      d = self.set_brick_qpos(d, order[:, k], poses[:, k])
    return d


def _make_brick_task(build_fn, num_bricks, vertex_sites=False, device=None):
  """Arena + jaco + n bricks + n contactless goal hints + pin hook.

  The pin hook is late-bound: it must close over compiled indices, but
  step hooks ride entities that exist before compilation, so the hook
  reads them through a cell filled right after compile."""
  bricks = [duplo.duplo_entity(f'brick{i}', color=COLORS[i],
                               vertex_sites=vertex_sites)
            for i in range(num_bricks)]
  hints = [duplo.duplo_entity(f'hint{i}', color=COLORS[i], hint=True)
           for i in range(num_bricks)]
  bs_cell = []

  def pin_hook(m, d, generator, prefix):
    return bs_cell[0].pin_project(m, d) if bs_cell else d

  pin_root = ET.Element('mujoco')
  ET.SubElement(pin_root, 'worldbody')
  pin = Entity(mjcf_root=pin_root, name='brickpin',
               after_substep_hook=pin_hook)
  task, m = build_fn(props=tuple(bricks) + tuple(hints) + (pin,),
                     device=device)
  from dm_control_tpu_torch.manipulation import tasks as T
  T._Common(task, m)  # arm/tcp observables (brick poses via BrickSet)
  bs = BrickSet(task, m, num_bricks)
  bs_cell.append(bs)
  task.bricks = bs
  return task, m, bs


def draw_scatter(d, generator, n, attempts=20):
  """scatter_bricks' draws: `attempts` layouts of n xy positions in the
  prop box, (B, attempts, n, 2), and n yaws, (B, n)."""
  from dm_control_tpu_torch.manipulation.tasks import _uniform
  return {'xy': _uniform(generator, d.qpos, _PROP_BBOX_LO[:2],
                         _PROP_BBOX_HI[:2], (attempts, n, 2)),
          'theta': _uniform(generator, d.qpos, -np.pi, np.pi, (n,))}


def scatter_bricks(bs, m, d, draws, min_sep=0.075):
  """Joint rejection placement of all bricks on the table (the role of
  the reference's PropPlacer, initializers/prop_initializer.py): of each
  lane's drawn layouts, keep the first whose pairwise brick separation
  exceeds min_sep (the first layout where none does)."""
  xy = draws['xy']                                   # (B, A, n, 2)
  n = bs.n
  ref = d.qpos
  if n > 1:
    pair = torch.linalg.vector_norm(xy[:, :, :, None] - xy[:, :, None],
                                    dim=-1)
    pair = pair + torch.eye(n, dtype=ref.dtype, device=ref.device) * 1e3
    ok = pair.amin(dim=(2, 3)) > min_sep
  else:
    ok = torch.ones(xy.shape[:2], dtype=torch.bool, device=ref.device)
  idx = torch.argmax(ok.to(torch.int32), dim=1)
  chosen = xy[_lanes(ref), idx]                      # (B, n, 2)
  quats = _zrot_quat(draws['theta'])                 # (B, n, 4)
  qpos = ref.clone()
  for i, a in enumerate(bs.qadr):
    qpos[:, a:a + 2] = chosen[:, i]
    qpos[:, a + 2] = _PROP_BBOX_LO[2]
    qpos[:, a + 3:a + 7] = quats[:, i]
  return d.replace(qpos=qpos)


def _permutations(generator, ref, B, n):
  """(B, n) int64: a uniform permutation of range(n) per lane."""
  u = torch.rand((B, n), generator=generator, device=ref.device)
  return torch.argsort(u, dim=1)


def _flips(generator, ref, n):
  return torch.rand((ref.shape[0], n), generator=generator,
                    device=ref.device) < 0.5


# ---------------------------------------------------------------------------
# Task factories (registered from tasks.py).


def stack(num_bricks, target_height, moveable_base, randomize_order,
          random=None, batch_size=None, device=None, dtype=torch.float32):
  """Reference Stack task (bricks.py:186-294)."""
  from dm_control_tpu_torch.manipulation import tasks as T
  task, m, bs = _make_brick_task(T.build_arena_jaco, num_bricks,
                                 device=device)

  def draw(d, generator):
    ref = d.qpos
    B = ref.shape[0]
    if randomize_order:
      order = _permutations(generator, ref, B, num_bricks)
    else:
      order = torch.arange(num_bricks, device=ref.device).expand(
          B, num_bricks)
    return dict(draw_scatter(d, generator, num_bricks), order=order,
                hint_flips=_flips(generator, ref, target_height))

  def apply(m_, d, draws):
    order = draws['order']
    d = bs.set_order(d, order, target_height)
    d = scatter_bricks(bs, m_, d, draws)
    if moveable_base:
      d = bs.no_pin(m_, d)
    else:
      d = bs.pin_base(m_, d, order[:, 0])
    return bs.place_hints(m_, d, draws['hint_flips'], order, target_height)

  task.add_init_hook(T._episode_init(draw, apply))

  # a default order: the observation pipeline shapes its buffers from an
  # example Data that has not run the init hook
  def order_of(d):
    mv = d.model_var or {}
    if 'duplo_order' in mv:
      return mv['duplo_order']
    return torch.arange(target_height, device=d.qpos.device).expand(
        d.qpos.shape[0], target_height)
  if randomize_order:
    task.add_observable('desired_order', ObservableSpec(
        fn=lambda m_, d: order_of(d).to(d.qpos.dtype)))
  task.set_reward(lambda m_, d: bs.stacking_reward(
      d, order_of(d).long(), target_height))
  return T.make_env(task, batch_size, random, dtype)


def reassemble(num_bricks, randomize_initial_order,
               randomize_desired_order, random=None, batch_size=None,
               device=None, dtype=torch.float32):
  """Reference Reassemble task (bricks.py:296-414): starts from a
  clicked stack; the goal stack reverses the order above the pinned base
  brick (optionally independently shuffled)."""
  from dm_control_tpu_torch.manipulation import tasks as T
  task, m, bs = _make_brick_task(T.build_arena_jaco, num_bricks,
                                 device=device)
  n = num_bricks

  def draw(d, generator):
    ref = d.qpos
    B = ref.shape[0]
    out = {}
    if randomize_initial_order:
      out['initial'] = _permutations(generator, ref, B, n)
    else:
      out['initial'] = torch.arange(n, device=ref.device).expand(B, n)
    if randomize_desired_order:
      # a permutation of the n - 1 places above the base
      out['tail'] = _permutations(generator, ref, B, n - 1)
    out['base_pos'] = T._uniform(generator, ref, _PROP_BBOX_LO,
                                 _PROP_BBOX_HI, (3,))
    out['theta'] = T._uniform(generator, ref, -np.pi, np.pi)
    out['stack_flips'] = _flips(generator, ref, n)
    out['hint_flips'] = _flips(generator, ref, n)
    return out

  def apply(m_, d, draws):
    initial = draws['initial']
    # desired: same base, reversed order above it (bricks.py:358-372)
    tail = initial[:, 1:].flip(1)
    if randomize_desired_order:
      tail = torch.gather(tail, 1, draws['tail'])
    desired = torch.cat([initial[:, :1], tail], 1)
    d = bs.set_order(d, desired, n)
    d = bs.build_stack(m_, d, draws, initial, n)
    d = bs.pin_base(m_, d, initial[:, 0])
    return bs.place_hints(m_, d, draws['hint_flips'], desired, n)

  task.add_init_hook(T._episode_init(draw, apply))

  def order_of(d):
    mv = d.model_var or {}
    if 'duplo_order' in mv:
      return mv['duplo_order']
    return torch.arange(n, device=d.qpos.device).expand(d.qpos.shape[0], n)
  if randomize_desired_order or randomize_initial_order:
    task.add_observable('desired_order', ObservableSpec(
        fn=lambda m_, d: order_of(d).to(d.qpos.dtype)))
  # close_coef=0: the coarse term would penalize breaking up the initial
  # stack (reference bricks.py:404-414)
  task.set_reward(lambda m_, d: bs.stacking_reward(
      d, order_of(d).long(), n, close_coef=0.0))
  return T.make_env(task, batch_size, random, dtype)
