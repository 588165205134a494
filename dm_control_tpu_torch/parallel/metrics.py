"""Runner observability: steps/s, resets/s, divergence counters.

The port of `dm_control_tpu/parallel/metrics.py`: the batched runner's
counters a trainer can log or assert on.  `update` takes torch tensors
(on any device) or numpy arrays.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch


def _sum(x) -> float:
  if isinstance(x, torch.Tensor):
    return float(x.double().sum())
  return float(np.sum(np.asarray(x)))


@dataclasses.dataclass
class Meter:
  """Accumulates throughput/episode statistics across runner steps."""
  batch_size: int
  t_start: float = dataclasses.field(default_factory=time.perf_counter)
  steps: int = 0
  episodes: int = 0
  divergences: int = 0
  reward_sum: float = 0.0

  def update(self, done, reward, diverged=None) -> None:
    self.steps += 1
    self.episodes += int(_sum(done))
    self.reward_sum += _sum(reward)
    if diverged is not None:
      self.divergences += int(_sum(diverged))

  def snapshot(self) -> Dict[str, float]:
    dt = max(time.perf_counter() - self.t_start, 1e-9)
    env_steps = self.steps * self.batch_size
    return dict(
        env_steps=env_steps,
        env_steps_per_sec=env_steps / dt,
        episodes=self.episodes,
        episodes_per_sec=self.episodes / dt,
        divergences=self.divergences,
        mean_reward=self.reward_sum / max(env_steps, 1),
        wall_seconds=dt,
    )
