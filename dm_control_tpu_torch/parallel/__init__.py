"""Batched environment runner."""

from dm_control_tpu_torch.parallel.runner import BatchedEnv, RunnerState  # noqa: F401
