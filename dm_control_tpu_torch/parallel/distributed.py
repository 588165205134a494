"""SAC training over one device's batched environments.

The port of `dm_control_tpu/parallel/distributed.py`'s `make_sac_trainer`
on one device.  The JAX package's mesh over hosts and devices
(`initialize`, `host_mesh`, `env_sharding`, `shard_batch`, `replicated`,
`host_fold_key`) and the gradient all-reduce across it wait for the
multi-card slice of the port (ROADMAP queue 1, item 6).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from dm_control_tpu_torch._src.types import resolve_device


def make_sac_trainer(domain: str, task_name: str, batch_size: int,
                     seed: int = 0, config=None,
                     device=None) -> Tuple[tuple, Callable]:
  """SAC training on one device: returns (carry, train_fn).

  carry = (sac_state, runner_state, replay, generator): the learner,
  `batch_size` lanes of (domain, task_name) reset with `seed`, an empty
  replay ring and the train step's generator (seeded with `seed`);
  `train_fn(carry) -> (carry, metrics)` is `sac.make_train_step`'s.  The
  device is CUDA unless the caller passes device='cpu'."""
  from dm_control_tpu_torch import suite
  from dm_control_tpu_torch.parallel.runner import BatchedEnv
  from dm_control_tpu_torch.rl import sac as sac_lib

  device = resolve_device(device)
  task = suite.build_task(domain, task_name, device=device)
  env = BatchedEnv(task, batch_size)
  cfg = config or sac_lib.SACConfig()
  sac = sac_lib.SAC(task, cfg)
  generator = torch.Generator(device=device)
  generator.manual_seed(seed)
  run_state = env.reset(seed)
  sac_state = sac.init(generator)
  replay = sac_lib.replay_init(cfg.replay_capacity, sac.obs_dim, sac.act_dim,
                               sac.dtype, device)
  carry = (sac_state, run_state, replay, generator)
  return carry, sac_lib.make_train_step(sac, env)
