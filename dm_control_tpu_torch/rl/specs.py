"""The dm_env surface's value types, without dm_env.

The port keeps its own `StepType`, `TimeStep` and array specs, with the
fields and methods of `dm_env.StepType`, `dm_env.TimeStep`,
`dm_env.specs.Array` and `dm_env.specs.BoundedArray` that the JAX
package's environments return, so that the port imports on a machine
without dm_env.  `action_spec` is the JAX package's
`rl/control.action_spec` (the reference dm_control/mujoco/engine.py:955).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, NamedTuple

import numpy as np


class StepType(enum.IntEnum):
  FIRST = 0
  MID = 1
  LAST = 2

  def first(self) -> bool:
    return self is StepType.FIRST

  def mid(self) -> bool:
    return self is StepType.MID

  def last(self) -> bool:
    return self is StepType.LAST


class TimeStep(NamedTuple):
  step_type: Any
  reward: Any
  discount: Any
  observation: Any

  def first(self) -> bool:
    return self.step_type == StepType.FIRST

  def mid(self) -> bool:
    return self.step_type == StepType.MID

  def last(self) -> bool:
    return self.step_type == StepType.LAST


@dataclasses.dataclass(frozen=True)
class Array:
  shape: tuple
  dtype: Any
  name: str = None


@dataclasses.dataclass(frozen=True)
class BoundedArray(Array):
  minimum: Any = None
  maximum: Any = None


def action_spec(model) -> BoundedArray:
  """BoundedArray over the actuators' control ranges (unbounded where an
  actuator's control is not limited)."""
  lo = np.where(model.actuator_ctrllimited, model.actuator_ctrlrange[:, 0],
                -np.inf)
  hi = np.where(model.actuator_ctrllimited, model.actuator_ctrlrange[:, 1],
                np.inf)
  return BoundedArray(
      shape=(model.nu,), dtype=np.float64, minimum=lo, maximum=hi,
      name='\t'.join(
          model.id2name('actuator', i) or str(i) for i in range(model.nu)))
