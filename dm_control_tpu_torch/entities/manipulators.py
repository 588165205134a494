"""Manipulator entities (reference:
entities/manipulators/base.py:44,185 + kinova/jaco_arm.py:52,
jaco_hand.py:37).

The port of `dm_control_tpu/entities/manipulators.py`.  `JacoArm()`
builds the 7-DoF Kinova j2s7s300 as a `RobotArm` (the abstraction tier
in manipulators_base.py): uniform `joints`, `wrist_site`,
`randomize_arm_joints`, IK `set_site_to_xpos`.  The model integrates the
3-finger hand, so `JacoHand()` is a `RobotHand` view over the same
attachment (finger joints and pinch site) rather than a separately
attachable model; `set_grasp` and `tool_center_point` behave as in the
reference."""

from __future__ import annotations

import copy
import xml.etree.ElementTree as ET

import numpy as np
import torch

from dm_control_tpu_torch.composer.observation import ObservableSpec
from dm_control_tpu_torch.entities.manipulators_base import (DOWN_QUATERNION,
                                                             RobotArm,
                                                             RobotHand)

_ARM_JOINTS = tuple(f'jaco_joint_{i}' for i in range(1, 8))
_FINGER_JOINTS = ('jaco_joint_finger_1', 'jaco_joint_finger_2',
                  'jaco_joint_finger_3')


def _jaco_root_with_sites() -> ET.Element:
  """A copy of the jaco fragment plus wrist and pinch sites (the
  reference arm and hand models declare these in their MJCF:
  jaco_arm.xml wrist_site, jaco_hand.xml pinchsite).  The JAX package
  adds them to its cached fragment itself, so that its manipulation
  tasks built afterwards carry them too; the port leaves the tasks'
  fragment as it is."""
  from dm_control_tpu_torch.manipulation.tasks import _jaco_entity
  root = copy.deepcopy(_jaco_entity().mjcf_root)
  for body in root.iter('body'):
    if body.attrib.get('name') == 'jaco_link_7':
      ET.SubElement(body, 'site', dict(
          name='wrist_site', pos='0 0 0', size='0.01', group='4'))
      ET.SubElement(body, 'site', dict(
          name='pinch_site', pos='0 0 -0.16', size='0.01', group='4'))
      break
  else:
    raise ValueError('jaco_link_7 not found in the jaco model')
  return root


def JacoArm(name: str = 'jaco') -> RobotArm:
  """7-DoF Kinova Jaco j2s7s300 with integral 3-finger hand
  (reference kinova/jaco_arm.py:52)."""

  def joints(m, prefix):
    pref = prefix or name
    qs, ds = [], []
    for j in range(m.njnt):
      if (m.id2name('joint', j) or '').startswith(pref + '/'):
        qs.append(int(m.jnt_qposadr[j]))
        ds.append(int(m.jnt_dofadr[j]))
    return np.asarray(qs), np.asarray(ds)

  def obs_pos(m, prefix):
    qs, _ = joints(m, prefix)
    return ObservableSpec(fn=lambda m_, d: torch.cat(
        [torch.sin(d.qpos[:, qs]), torch.cos(d.qpos[:, qs])], -1))

  def obs_vel(m, prefix):
    _, ds = joints(m, prefix)
    return ObservableSpec(fn=lambda m_, d: d.qvel[:, ds])

  return RobotArm(mjcf_root=_jaco_root_with_sites(), name=name,
                  joint_names=_ARM_JOINTS,
                  wrist_site_name=f'{name}/wrist_site',
                  observables={'joints_pos': obs_pos,
                               'joints_vel': obs_vel})


def JacoHand(name: str = 'jaco') -> RobotHand:
  """RobotHand view over the integral j2s7s300 hand (reference
  kinova/jaco_hand.py:37): set_grasp drives the three finger joints,
  tool_center_point is the pinch site."""
  return RobotHand(mjcf_root=ET.Element('mujoco'), name=name,
                   finger_joint_names=_FINGER_JOINTS,
                   tool_center_point_name=f'{name}/pinch_site',
                   # the model's finger joints are unlimited; 0..1.1 rad
                   # spans open -> closed on the real hand
                   grasp_range=np.tile([0.0, 1.1], (3, 1)))


__all__ = ['JacoArm', 'JacoHand', 'RobotArm', 'RobotHand',
           'DOWN_QUATERNION']
