"""Control Suite tasks of the port (reference: dm_control/suite).

Ported so far: walker (stand, walk, run), finger (spin, turn_easy,
turn_hard), cheetah (run), hopper (stand, hop), pendulum (swingup),
reacher (easy, hard), cartpole (balance, balance_sparse, swingup,
swingup_sparse, two_poles, three_poles), acrobot (swingup,
swingup_sparse), point_mass (easy, hard), ball_in_cup (catch), swimmer
(swimmer6, swimmer15), fish (upright, swim), humanoid (stand, walk, run,
run_pure_state), humanoid_CMU (stand, run), quadruped (walk, run, escape,
fetch), manipulator (bring_ball, bring_peg, insert_ball, insert_peg),
stacker (stack_2, stack_4), lqr (lqr_2_1, lqr_6_2), jaco
(position_reacher_7DOF, relative_position_reacher_7DOF,
configurable_reacher) and dog (stand, walk, trot, run, fetch): every
domain of the JAX package.
"""

from __future__ import annotations

import importlib

from dm_control_tpu_torch._src.types import resolve_device
from dm_control_tpu_torch.rl import control

DOMAINS = ('walker', 'finger', 'cheetah', 'hopper', 'pendulum', 'reacher',
           'cartpole', 'acrobot', 'point_mass', 'ball_in_cup', 'swimmer',
           'fish', 'humanoid', 'humanoid_CMU', 'quadruped', 'manipulator',
           'stacker', 'lqr', 'jaco', 'dog')


def build_task(domain_name: str, task_name: str,
               device=None) -> control.TaskDef:
  """The functional TaskDef for (domain, task), with its Model on `device`
  (CUDA unless the caller passes device='cpu')."""
  device = str(resolve_device(device))
  if domain_name not in DOMAINS:
    raise NotImplementedError(f'domain {domain_name!r} is not ported yet')
  module = importlib.import_module(f'dm_control_tpu_torch.suite.{domain_name}')
  return module.make_task(task_name, device)
