"""Manipulation tier: single-arm (Jaco) prop tasks
(reference: dm_control/manipulation/).

The port of `dm_control_tpu/manipulation/`: `load(name)` over a tagged
registry, mirroring the reference entry point
(manipulation/__init__.py:64-79), with all 25 of the JAX package's names.
The 13 `_features` tasks run; the 12 `_vision` names raise
NotImplementedError, since their pixels observable needs the renderer.
"""

import torch

from dm_control_tpu_torch.manipulation import tasks as _tasks

ALL = tuple(sorted(_tasks.REGISTRY))
TAGS = tuple(sorted({t for tags in _tasks.TAGS.values() for t in tags}))


def get_environments_by_tag(tag):
  return tuple(sorted(n for n, tags in _tasks.TAGS.items() if tag in tags))


def load(environment_name, seed=None, batch_size=None, device=None,
         dtype=torch.float32):
  """The task's single-lane `Environment` (seeded by `seed`), or its
  `BatchedEnvironment` of `batch_size` lanes, on `device` (the card
  unless named)."""
  if environment_name not in _tasks.REGISTRY:
    raise ValueError(
        f'unknown environment {environment_name!r}; available: {ALL}')
  return _tasks.REGISTRY[environment_name](
      random=seed, batch_size=batch_size, device=device, dtype=dtype)
