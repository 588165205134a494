"""Planar manipulator domain (reference: dm_control/suite/manipulator.py):
bring_ball, bring_peg, insert_ball and insert_peg.

Each task keeps only its own props (the ball or the peg, and the cup or
the slot where it inserts).  An episode places the target, and the
receptacle with it, at a random pose: per-lane `body_pos` and
`body_quat` in `Data.model_var`, read by the kinematics through
`smooth.mparam`.  The object starts in the hand, at the target or
anywhere, drawn collision-free (20 draws per lane), so every task is an
expensive init and BatchedEnv's auto-reset takes its states, the
target's pose included, from the reset pool.
"""

from __future__ import annotations

import functools
import math

import torch

from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch._src import smooth
from dm_control_tpu_torch._src.types import mirror
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import base
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import rewards

_CONTROL_TIMESTEP = .01
_P_IN_HAND = .1
_P_IN_TARGET = .1
_ARM_JOINTS = ['arm_root', 'arm_shoulder', 'arm_elbow', 'arm_wrist',
               'finger', 'fingertip', 'thumb', 'thumbtip']
_ALL_PROPS = frozenset(['ball', 'target_ball', 'cup', 'peg', 'target_peg',
                        'slot'])
_CLOSE = .01

# (use_peg, insert)
TASKS = {'bring_ball': (False, False), 'bring_peg': (True, False),
         'insert_ball': (False, True), 'insert_peg': (True, True)}


def prune(root, keep_body):
  """Remove the bodies keep_body(name) rejects, and the sensors that
  name what went with them (reference suite/manipulator.py:42-69)."""
  for parent in root.iter():
    for child in list(parent):
      if child.tag == 'body' and not keep_body(child.attrib.get('name')):
        parent.remove(child)
  kept = {el.attrib['name'] for el in root.iter() if 'name' in el.attrib}
  for sec in root.findall('sensor'):
    for el in list(sec):
      ref = (el.attrib.get('site') or el.attrib.get('joint')
             or el.attrib.get('body') or el.attrib.get('objname'))
      if ref and ref not in kept:
        sec.remove(el)
  return root


@functools.lru_cache(maxsize=None)
def _model(use_peg: bool, insert: bool, device: str):
  if use_peg:
    required = {'peg', 'target_peg'} | ({'slot'} if insert else set())
  else:
    required = {'ball', 'target_ball'} | ({'cup'} if insert else set())
  root = prune(common.load_xml_root('manipulator.xml'),
               lambda name: name not in _ALL_PROPS - required)
  return engine.model_from_root(root, device)


class Arm:
  """The arm's joints as both manipulator and stacker draw them: each
  angle uniform in its range ([-pi, pi] where unlimited), the finger
  matching the thumb."""

  def __init__(self, m):
    jid = [m.name2id('joint', j) for j in _ARM_JOINTS]
    self.qadr = [int(m.jnt_qposadr[j]) for j in jid]
    self.dadr = [int(m.jnt_dofadr[j]) for j in jid]
    self.lower = [float(m.jnt_range[j, 0]) if m.jnt_limited[j] else -math.pi
                  for j in jid]
    self.upper = [float(m.jnt_range[j, 1]) if m.jnt_limited[j] else math.pi
                  for j in jid]
    self.finger = int(m.jnt_qposadr[m.name2id('joint', 'finger')])
    self.thumb = int(m.jnt_qposadr[m.name2id('joint', 'thumb')])

  def sample(self, qpos, generator):
    qpos = qpos.clone()
    B = qpos.shape[0]
    u = torch.rand((B, len(self.qadr)), generator=generator,
                   dtype=qpos.dtype, device=qpos.device)
    lo = qpos.new_tensor(self.lower)
    qpos[:, self.qadr] = lo + (qpos.new_tensor(self.upper) - lo) * u
    qpos[:, self.finger] = qpos[:, self.thumb]
    return qpos

  def observation(self, d):
    jpos = d.qpos[:, self.qadr]
    return {'arm_pos': torch.stack([torch.sin(jpos), torch.cos(jpos)], -1),
            'arm_vel': d.qvel[:, self.dadr]}


def body_2d_pose(d, b, orientation=True):
  """(B, 4) x, z and the quaternion's w, y of body b ((B, 2) without
  the orientation)."""
  pos = torch.stack([d.xpos[:, b, 0], d.xpos[:, b, 2]], -1)
  if not orientation:
    return pos
  return torch.cat([pos, d.xquat[:, b][:, [0, 2]]], -1)


@functools.lru_cache(maxsize=None)
def _make_task(use_peg: bool, insert: bool,
               device: str) -> control.TaskDef:
  m = _model(use_peg, insert, device)
  arm = Arm(m)
  obj = 'peg' if use_peg else 'ball'
  obj_qadr = [int(m.jnt_qposadr[m.name2id('joint', f'{obj}_{c}')])
              for c in 'xzy']
  obj_dadr = [int(m.jnt_dofadr[m.name2id('joint', f'{obj}_{c}')])
              for c in 'xzy']
  b_target = m.name2id('body', 'target_peg' if use_peg else 'target_ball')
  b_obj = m.name2id('body', obj)
  b_hand = m.name2id('body', 'hand')
  b_recep = m.name2id('body', 'slot' if use_peg else 'cup') if insert else -1
  s_grasp = m.name2id('site', 'grasp')
  sites = {name: m.name2id('site', name) for name in m.names['site']}

  def init_episode(m_, d, generator):
    def sample(d_, gen):
      B = d_.qpos.shape[0]
      kw = dict(generator=gen, dtype=d_.qpos.dtype, device=d_.qpos.device)
      u = lambda lo, hi: lo + (hi - lo) * torch.rand(B, **kw)
      qpos = arm.sample(d_.qpos, gen)
      # the target (and the receptacle) at a random pose
      # (suite/manipulator.py:118-135)
      target_x, target_z = u(-.4, .4), u(.1, .4)
      angle = u(-math.pi / 3, math.pi / 3) if insert else u(-math.pi, math.pi)
      zero = torch.zeros_like(angle)
      quat = torch.stack([torch.cos(angle / 2), zero, torch.sin(angle / 2),
                          zero], -1)
      ref = d_.qpos
      body_pos = mirror(m_, ref, m_.body_pos).expand(B, m_.nbody, 3).clone()
      body_quat = mirror(m_, ref, m_.body_quat).expand(B, m_.nbody,
                                                       4).clone()
      for b in (b_target, b_recep) if insert else (b_target,):
        body_pos[:, b, 0], body_pos[:, b, 2] = target_x, target_z
        body_quat[:, b] = quat
      dk = d_.replace(qpos=qpos, model_var=dict(
          d_.model_var or {}, body_pos=body_pos, body_quat=body_quat))
      # the object in the hand, at the target, or anywhere
      # (suite/manipulator.py:137-157); the grasp site's pose under the new
      # arm angles from the kinematics
      kin = smooth.kinematics(m_, dk)
      grasp_x = kin.site_xpos[:, s_grasp, 0]
      grasp_z = kin.site_xpos[:, s_grasp, 2]
      grasp_angle = math.pi - torch.atan2(kin.site_xmat[:, s_grasp, 2, 0],
                                          kin.site_xmat[:, s_grasp, 0, 0])
      choice = torch.rand(B, **kw)
      in_hand = choice < _P_IN_HAND
      in_target = (choice >= _P_IN_HAND) & (choice < _P_IN_HAND + _P_IN_TARGET)
      anywhere = (u(-.5, .5), u(0., .7), u(0., 2 * math.pi))
      placed = [torch.where(in_hand, g, torch.where(in_target, t, a))
                for g, t, a in zip((grasp_x, grasp_z, grasp_angle),
                                   (target_x, target_z, angle), anywhere)]
      qpos[:, obj_qadr] = torch.stack(placed, -1)
      qvel = d_.qvel.clone()
      qvel[:, obj_dadr[0]] = torch.where(in_hand | in_target, 0.0,
                                         u(-5., 5.))
      return dk.replace(qpos=qpos, qvel=qvel)
    return base.collision_free_init(sample, m_, d, generator)

  def site_distance(d, s1, s2):
    return (d.site_xpos[:, sites[s1]] - d.site_xpos[:, sites[s2]]).norm(dim=-1)

  def get_observation(m_, d):
    obs = arm.observation(d)
    obs['touch'] = torch.log1p(d.sensordata)
    obs['hand_pos'] = body_2d_pose(d, b_hand)
    obs['object_pos'] = body_2d_pose(d, b_obj)
    obs['object_vel'] = d.qvel[:, obj_dadr]
    obs['target_pos'] = body_2d_pose(d, b_target)
    return obs

  def is_close(distance):
    return rewards.tolerance(distance, (0, _CLOSE), _CLOSE * 2)

  def get_reward(m_, d):
    if use_peg:
      grasping = (is_close(site_distance(d, 'peg_grasp', 'grasp'))
                  + is_close(site_distance(d, 'peg_pinch', 'pinch'))) / 2
      bringing = (is_close(site_distance(d, 'peg', 'target_peg'))
                  + is_close(site_distance(d, 'target_peg_tip', 'peg_tip'))
                  ) / 2
      return torch.maximum(bringing, grasping / 3)
    return is_close(site_distance(d, 'ball', 'target_ball'))

  return control.TaskDef(
      name=f'manipulator_{"peg" if use_peg else "ball"}', model=m,
      init_episode=init_episode, get_observation=get_observation,
      get_reward=get_reward, control_timestep=_CONTROL_TIMESTEP,
      expensive_init=True)


def make_task(task_name: str, device: str) -> control.TaskDef:
  if task_name not in TASKS:
    raise ValueError(f'unknown manipulator task {task_name!r}')
  return _make_task(*TASKS[task_name], device)
