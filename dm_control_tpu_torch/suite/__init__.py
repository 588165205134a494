"""Control Suite tasks of the port (reference: dm_control/suite).

Ported so far: walker (stand, walk, run) and finger (spin); the other
domains and tasks raise.
"""

from __future__ import annotations

from dm_control_tpu_torch._src.types import resolve_device
from dm_control_tpu_torch.rl import control


def build_task(domain_name: str, task_name: str,
               device=None) -> control.TaskDef:
  """The functional TaskDef for (domain, task), with its Model on `device`
  (CUDA unless the caller passes device='cpu')."""
  device = str(resolve_device(device))
  if domain_name == 'walker':
    from dm_control_tpu_torch.suite import walker
    return walker.make_task(task_name, device)
  if domain_name == 'finger':
    from dm_control_tpu_torch.suite import finger
    return finger.make_task(task_name, device)
  raise NotImplementedError(f'domain {domain_name!r} is not ported yet')
