"""Tasks as structs of functions over batched (Model, Data).

The port of `dm_control_tpu/rl/control.py:TaskDef`.  The single-env
`dm_env` adapter of the JAX package is not ported; the batched runner
(`parallel.runner.BatchedEnv`) is the port's entry point.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from dm_control_tpu_torch._src.types import Data, Model


@dataclasses.dataclass
class TaskDef:
  """A task as a struct of functions over batched (Model, Data):

    init_episode(model, data, generator) -> Data   randomized initial state
    get_observation(model, data) -> dict[str, (B, ...) tensor]
    get_reward(model, data) -> (B,) tensor
    get_termination(model, data) -> (B,) bool tensor (optional)
    before_step(model, data, action) -> Data      (optional) the agent's
        action (B, na) to controls and per-lane task state (the reference
        Task.before_step); without it the action is the controls
    action_bounds() -> (minimum (na,), maximum (na,)) numpy (optional)
        the action's range where before_step takes another than the
        controls' (jaco's 7 arm joints, its relative steps)

  `init_episode` draws its randomness from the torch.Generator it is
  given, on the data's device.
  """
  name: str
  model: Model
  init_episode: Callable[[Model, Data, torch.Generator], Data]
  get_observation: Callable[[Model, Data], dict]
  get_reward: Callable[[Model, Data], torch.Tensor]
  get_termination: Optional[Callable[[Model, Data], torch.Tensor]] = None
  before_step: Optional[Callable[[Model, Data, torch.Tensor], Data]] = None
  action_bounds: Optional[Callable[[], tuple]] = None
  control_timestep: Optional[float] = None  # default: physics timestep
  # True when init_episode is expensive (finger's collision-free
  # rejection sampling): BatchedEnv then auto-resets done lanes from a
  # pool of initial states instead of running init_episode again.
  expensive_init: bool = False

  def n_sub_steps(self) -> int:
    if self.control_timestep is None:
      return 1
    dt = self.model.opt.timestep
    n = self.control_timestep / dt
    rounded = int(round(n))
    if abs(n - rounded) > 1e-6:
      raise ValueError(
          f'control_timestep {self.control_timestep} not divisible by '
          f'physics timestep {dt}')
    return rounded
