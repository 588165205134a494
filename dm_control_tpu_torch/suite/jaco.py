"""Jaco domain (reference: dm_control/suite/jaco.py): the 7-DoF Kinova
arm reaching for a target, the three `benchmarking` tasks.

The port of `dm_control_tpu/suite/jaco.py` (simulation only).  Its links
are collidable meshes (`mjcf/meshes.py`, the Frank-Wolfe colliders of
`_src/colliders.py`), integrated with RK4 at 1 ms under a 0.1 s control
step: 100 physics steps per control step.  Each episode draws the target
per lane (`geom_pos` in `Data.model_var`); `before_step` maps the agent's
7 joint targets (absolute, or steps relative to the current angles) to
the 13 position controls with the hand closed, and charges the action's
size and the virtual fence at the DH extremes of the requested pose
(`_jaco_penalty` in `Data.model_var`, added to the reward).
The 6-DoF model file, `jaco_j2s6s300_position.xml`, compiles through
`_model`; the reacher task takes the 7-DoF file only, as in the JAX
package, whose task cannot load the 6-DoF file.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch._src.types import mirror
from dm_control_tpu_torch.rl import control
from dm_control_tpu_torch.suite import common
from dm_control_tpu_torch.utils import rewards

_CONTROL_TIMESTEP = .1
_BIG_TARGET = .05
_SMALL_TARGET = .025
_XML_7DOF = 'jaco_j2s7s300_position.xml'

# DH parameters for the 7-DoF Jaco 2 (reference jaco.py:390-416)
_DH_LENGTHS = dict(D1=0.2755, D2=0.2050, D3=0.2050, D4=0.2073,
                   D5=0.1038, D6=0.1038, D7=0.1600, e2=0.0098)
_DH_A = np.zeros(7)
_DH_D = np.array([
    -_DH_LENGTHS['D1'], 0.0, -(_DH_LENGTHS['D2'] + _DH_LENGTHS['D3']),
    -_DH_LENGTHS['e2'], -(_DH_LENGTHS['D4'] + _DH_LENGTHS['D5']), 0.0,
    -(_DH_LENGTHS['D6'] + _DH_LENGTHS['D7'])])
_DH_ALPHA = np.array([np.pi / 2] * 6 + [np.pi])
_DH_THETA_SIGN = np.ones(7)
_DH_THETA_OFFSET = np.array([np.pi, 0, 0, 0, 0, 0, np.pi / 2])

_HOME_ANGLES = np.array([4.92, 2.839, 0.0, .758, 4.6366, 4.493, 5.0249,
                         1.1, 0.1, 1.1, 0.1, 1.1, 0.1])
_CLOSED_HAND = np.array([1.1, 0.1, 1.1, 0.1, 1.1, 0.1])
_FENCE = (('x', (-1, 1)), ('y', (-1, 1)), ('z', (0.05, 1.2)))

TASKS = ('position_reacher_7DOF', 'relative_position_reacher_7DOF',
         'configurable_reacher')


def dh_joint_positions(angles: torch.Tensor) -> torch.Tensor:
  """(B, 7, 3) world xyz of each joint from DH forward kinematics of the
  (B, 7) joint angles (reference DHtransformEL), as batched 4x4
  products."""
  B = angles.shape[0]
  kw = dict(dtype=angles.dtype, device=angles.device)
  tall = torch.diag(torch.tensor([1.0, -1.0, -1.0, 1.0], **kw)).expand(
      B, 4, 4)
  zero, one = torch.zeros(B, **kw), torch.ones(B, **kw)
  out = []
  for i in range(7):
    theta = _DH_THETA_SIGN[i] * angles[:, i] + _DH_THETA_OFFSET[i]
    ct, st = torch.cos(theta), torch.sin(theta)
    ca, sa = float(np.cos(_DH_ALPHA[i])), float(np.sin(_DH_ALPHA[i]))
    a, dd = float(_DH_A[i]), float(_DH_D[i])
    t = torch.stack([
        torch.stack([ct, -st * ca, st * sa, a * ct], -1),
        torch.stack([st, ct * ca, -ct * sa, a * st], -1),
        torch.stack([zero, sa * one, ca * one, dd * one], -1),
        torch.stack([zero, zero, zero, one], -1)], -2)
    tall = tall @ t
    out.append(tall[:, :3, 3])
  return torch.stack(out, 1)


@functools.lru_cache(maxsize=None)
def _model(xml_name: str, device: str):
  return engine.load_model(common.model_path(xml_name), device)


@functools.lru_cache(maxsize=None)
def _make_task(xml_name, relative_step, relative_rad_max, fence_t,
               target_type, fixed_target_t, target_size, action_penalty,
               degrees_of_freedom, device) -> control.TaskDef:
  if xml_name != _XML_7DOF:
    # The 6-DoF file compiles (`_model`), but the reacher task cannot run
    # on it, in the JAX package either: it declares no 'target' geom
    # (the JAX package's task raises KeyError there), its 12 joints do not
    # take the 13 home angles or the 7 arm joints, and its actuators are
    # velocity servos where the task sends position targets
    raise NotImplementedError(
        f'the jaco reacher task runs on {_XML_7DOF!r} only: {xml_name!r} '
        f'declares no target geom, 6 arm joints and velocity actuators '
        f'(its model loads through jaco._model)')
  m = _model(xml_name, device)
  fence = dict(fence_t)
  dof = degrees_of_freedom
  extreme_joints = np.array([4, 6, 7]) - 1
  radii = target_size + .15
  target_g = m.name2id('geom', 'target')
  arm_q = np.array([int(m.jnt_qposadr[j]) for j in range(7)])
  lo = np.array([max(min(fence['x']), -.8), max(min(fence['y']), -.8),
                 max(min(fence['z']), 0.1)])
  hi = np.array([min(max(fence['x']), .8), min(max(fence['y']), .8),
                 min(max(fence['z']), .8)])
  fence_lo = np.array([min(fence[k]) for k in 'xyz'])
  fence_hi = np.array([max(fence[k]) for k in 'xyz'])

  def init_episode(m_, d, generator):
    ref = d.qpos
    B = ref.shape[0]
    qpos = ref.clone()
    qpos[:, :13] = mirror(m_, ref, _HOME_ANGLES)
    if target_type == 'random':
      # rejection sample until tx + ty + tz <= 1.1 (reference
      # jaco.py:483-496 bounds the coordinates' sum): the lanes still over
      # it draw again from the generator, the others keep their draw
      lo_t, hi_t = mirror(m_, ref, lo), mirror(m_, ref, hi)
      target = ref.new_full((B, 3), float('inf'))
      todo = torch.ones(B, dtype=torch.bool, device=ref.device)
      while bool(todo.any()):
        n = int(todo.sum())
        u = torch.rand((n, 3), generator=generator, dtype=ref.dtype,
                       device=ref.device)
        target[todo] = lo_t + (hi_t - lo_t) * u
        todo = target.sum(-1) > 1.1
    else:
      target = mirror(m_, ref, np.asarray(fixed_target_t)).expand(B, 3)
    geom_pos = mirror(m_, ref, m_.geom_pos).expand(B, m_.ngeom, 3).clone()
    geom_pos[:, target_g] = target
    mv = dict(d.model_var or {}, geom_pos=geom_pos,
              _jaco_penalty=ref.new_zeros(B))
    return d.replace(qpos=qpos, model_var=mv)

  def before_step(m_, d, action):
    ref = d.qpos
    angles = ref[:, arm_q][:, :dof]
    if relative_step:
      use = torch.clamp(action[:, :dof], -relative_rad_max,
                        relative_rad_max) + angles
    else:
      use = torch.minimum(torch.maximum(action[:, :dof],
                                        angles - relative_rad_max),
                          angles + relative_rad_max)
    penalty = ref.new_zeros(ref.shape[0])
    if action_penalty:
      penalty = penalty - ((use - angles) ** 2).sum(-1)
    full = torch.cat([use, ref[:, arm_q][:, dof:7],
                      mirror(m_, ref, _CLOSED_HAND).expand(
                          ref.shape[0], 6)], -1)[:, :m_.nu]
    # the virtual fence at the DH extremes of the requested pose
    extremes = dh_joint_positions(full[:, :7])[:, extreme_joints]
    hit = ((extremes > mirror(m_, ref, fence_hi))
           | (extremes < mirror(m_, ref, fence_lo)))
    penalty = penalty - hit.any(-1).to(ref.dtype).sum(-1)
    mv = dict(d.model_var or {}, _jaco_penalty=penalty)
    return d.replace(ctrl=full, model_var=mv)

  def _target(m_, d):
    mv = d.model_var or {}
    if 'geom_pos' in mv:
      return mv['geom_pos'][:, target_g]
    return mirror(m_, d.qpos, m_.geom_pos[target_g]).expand(
        d.qpos.shape[0], 3)

  def _tool_position(d):
    return dh_joint_positions(d.qpos[:, arm_q])[:, -1]

  def get_observation(m_, d):
    return {'to_target': _target(m_, d) - _tool_position(d),
            'joint_angles': d.qpos[:, :m_.nu],
            'joint_forces': d.actuator_force,
            'joint_velocity': d.actuator_velocity}

  def get_reward(m_, d):
    distance = (_tool_position(d) - _target(m_, d)).norm(dim=-1)
    penalty = (d.model_var or {}).get('_jaco_penalty', 0.0)
    return rewards.tolerance(distance, (0, radii)) + penalty

  def action_bounds():
    if relative_step:
      return -relative_rad_max * np.ones(dof), relative_rad_max * np.ones(dof)
    rng = np.where(m.actuator_ctrllimited[:, None], m.actuator_ctrlrange,
                   [[-1.0, 1.0]])
    return rng[:dof, 0], rng[:dof, 1]

  return control.TaskDef(
      name='jaco', model=m, init_episode=init_episode,
      before_step=before_step, get_observation=get_observation,
      get_reward=get_reward, action_bounds=action_bounds,
      control_timestep=_CONTROL_TIMESTEP)


def configurable_reacher(device, xml_name=_XML_7DOF, action_penalty=True,
                         relative_step=True, relative_rad_max=.1, fence=None,
                         degrees_of_freedom=7, target_size=_BIG_TARGET,
                         target_type='random',
                         fixed_target_position=(.2, .2, .5)):
  """The reference's configurable reacher (its episode time limit goes to
  BatchedEnv's `time_limit`: 20 s)."""
  fence_t = _FENCE if fence is None else tuple(sorted(
      (k, tuple(v)) for k, v in fence.items()))
  return _make_task(xml_name, bool(relative_step), float(relative_rad_max),
                    fence_t, target_type, tuple(fixed_target_position),
                    float(target_size), bool(action_penalty),
                    int(degrees_of_freedom), device)


def make_task(task_name: str, device: str) -> control.TaskDef:
  """position_reacher_7DOF (absolute targets) and
  relative_position_reacher_7DOF (steps): 10 s episodes in the reference;
  configurable_reacher with its defaults (relative steps): 20 s."""
  if task_name == 'position_reacher_7DOF':
    return configurable_reacher(device, relative_step=False)
  if task_name == 'relative_position_reacher_7DOF':
    return configurable_reacher(device, relative_step=True)
  if task_name == 'configurable_reacher':
    return configurable_reacher(device)
  raise ValueError(f'unknown jaco task {task_name!r}')
