"""Batched environment runner with auto-reset.

The port of `dm_control_tpu/parallel/runner.py`.  One `step` advances B
environments in lockstep:

  actions (B, na) -> [task.before_step] -> physics substeps ->
  obs/reward/done -> auto-reset lanes

Auto-reset keeps the reference's episode semantics: a lane whose episode
ends (time limit, task termination, divergence) returns its terminal
observation and its integration state is re-initialized.  The JAX package
computes fresh states for every lane and lets XLA drop the unused ones;
eager PyTorch drops nothing, so fresh states are computed for the done
lanes only.  They go through `forward`, as in the JAX package, which sets
`qacc_warmstart`, one of the integration-state fields.  A task with an
expensive init (`TaskDef.expensive_init`) resets from a pool instead: the
initial batch's integration states, of which a done lane takes entry
`pool_index(episode_id, lane, B)`, the JAX package's lane permutation.
A lane's per-episode model overrides (`Data.model_var`, e.g. reacher's
target `geom_pos`) are part of its integration state: the pool and the
auto-reset carry them per lane with the rest.  A task's `before_step`
(jaco's) maps the actions to controls first, as the JAX package's
single-environment `control.Environment` does; its batched runner passes
actions on as controls and has no such adapter beside it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from dm_control_tpu_torch._src import forward as _forward
from dm_control_tpu_torch._src.types import Data, mirror
from dm_control_tpu_torch.rl.control import TaskDef


@dataclasses.dataclass
class RunnerState:
  """Batched carry: env states + per-lane bookkeeping."""
  data: Data                 # batched (leading axis B)
  step_count: torch.Tensor   # (B,) i4 control steps this episode
  episode_id: torch.Tensor   # (B,) i4
  # integration states of the initial batch (`forward.state_of`), for
  # expensive-init tasks
  reset_pool: Optional[Dict[str, Any]] = None


def pool_index(episode_id: torch.Tensor, lanes: torch.Tensor,
               batch_size: int) -> torch.Tensor:
  """Pool entry of each resetting lane: ((episode_id + 1) * 2654435761 +
  lane) mod B in uint32 arithmetic, so that lanes do not replay their own
  start state."""
  h = (episode_id.long() + 1) * 2654435761 + lanes.long()
  return (h & 0xFFFFFFFF) % batch_size


class BatchedEnv:
  """Batch-parallel environment for one TaskDef on the task's device."""

  def __init__(self, task: TaskDef, batch_size: int,
               time_limit: float = float('inf'),
               dtype: torch.dtype = torch.float32):
    self.task = task
    self.model = task.model
    self.device = self.model.device
    self.batch_size = batch_size
    self.dtype = dtype
    self.n_sub_steps = task.n_sub_steps()
    if time_limit == float('inf'):
      self.step_limit = np.iinfo(np.int32).max
    else:
      self.step_limit = int(round(time_limit / (
          self.model.opt.timestep * self.n_sub_steps)))
    # episode initialization draws (reset and auto-reset)
    self.generator = torch.Generator(device=self.device)
    self.reset_calls = 0      # auto-reset init_states calls made by step

  def init_states(self, n: int) -> Data:
    """n fresh, forward-synced initial states."""
    m = self.model
    d = _forward.make_data(m, n, self.dtype, self.device)
    d = self.task.init_episode(m, d, self.generator)
    return _forward.forward(m, d)

  def reset(self, seed: int = 0) -> RunnerState:
    self.generator.manual_seed(seed)
    B = self.batch_size
    zeros = torch.zeros(B, dtype=torch.int32, device=self.device)
    data = self.init_states(B)
    pool = None
    if self.task.expensive_init:
      pool = _forward.map_state(torch.clone, _forward.state_of(data))
    return RunnerState(data=data, step_count=zeros,
                       episode_id=zeros.clone(), reset_pool=pool)

  def step(self, state: RunnerState, actions: torch.Tensor):
    """Advance every lane one control step.

    Returns (new_state, (obs, reward, done, discount)); obs is the
    pre-reset observation of each lane."""
    m, task = self.model, self.task
    if task.before_step is not None:
      d = task.before_step(m, state.data, actions)
    else:
      d = state.data.replace(ctrl=actions)
    d = _forward.substeps(m, d, self.n_sub_steps)
    reward = task.get_reward(m, d)
    obs = task.get_observation(m, d)
    step_count = state.step_count + 1
    terminated = torch.zeros_like(d.diverged)
    if task.get_termination is not None:
      terminated = task.get_termination(m, d).to(torch.bool)
    done = terminated | (step_count >= self.step_limit) | d.diverged
    discount = torch.where(terminated | d.diverged, 0.0, 1.0).to(self.dtype)
    # a diverged lane's NaN state must not leak into the reward stream
    reward = torch.where(d.diverged, 0.0, reward)

    if bool(done.any()):
      lanes = done.nonzero().squeeze(1)
      if state.reset_pool is not None:
        idx = pool_index(state.episode_id[lanes], lanes, self.batch_size)
        fresh = _forward.map_state(lambda x: x[idx], state.reset_pool)
      else:
        self.reset_calls += 1
        fresh = _forward.state_of(self.init_states(int(lanes.numel())))

      def put(x, x_new):
        x = x.clone()
        x[lanes] = x_new
        return x

      d = d.replace(**_forward.map_state(put, _forward.state_of(d), fresh))
    return (RunnerState(data=d, step_count=torch.where(done, 0, step_count),
                        episode_id=state.episode_id + done.to(torch.int32),
                        reset_pool=state.reset_pool),
            (obs, reward, done, discount))

  def rollout_fn(self, n_steps: int):
    """A (state, generator) -> (state, rewards (n_steps, B)) loop.

    Actions are drawn uniformly in the control range, or in the task's
    `action_bounds` (throughput benchmarking); learners call `step` with
    their policy's actions."""
    m = self.model
    B, dtype = self.batch_size, self.dtype
    ref = torch.empty(0, dtype=dtype, device=self.device)
    if self.task.action_bounds is not None:
      lo, hi = (mirror(m, ref, np.asarray(b, np.float64))
                for b in self.task.action_bounds())
    else:
      lo = mirror(m, ref, np.where(m.actuator_ctrllimited,
                                   m.actuator_ctrlrange[:, 0], -1.0))
      hi = mirror(m, ref, np.where(m.actuator_ctrllimited,
                                   m.actuator_ctrlrange[:, 1], 1.0))
    na = lo.shape[0]

    def run(state: RunnerState, generator: torch.Generator):
      rewards = []
      for _ in range(n_steps):
        u = torch.rand((B, na), generator=generator, dtype=dtype,
                       device=self.device)
        state, (_, reward, _, _) = self.step(state, lo + (hi - lo) * u)
        rewards.append(reward)
      return state, torch.stack(rewards)

    return run
