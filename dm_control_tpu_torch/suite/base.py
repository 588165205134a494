"""Shared task machinery: batched episode randomizers and init helpers.

The port of `dm_control_tpu/suite/base.py` for what the ported domains
use.  Random draws come from an explicit torch.Generator on the data's
device; they do not reproduce `jax.random` streams (tests feed both
packages the same states instead).
"""

from __future__ import annotations

import math
from typing import Callable, List

import torch

from dm_control_tpu_torch._src import collision as _collision
from dm_control_tpu_torch._src import forward as _forward
from dm_control_tpu_torch._src import smooth as _smooth
from dm_control_tpu_torch._src.math import normalize
from dm_control_tpu_torch._src.types import Data, JointType, Model

# candidates drawn per lane by collision_free_init
_MAX_ATTEMPTS = 20


def randomize_limited_and_rotational_joints(
    m: Model, qpos: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
  """Randomize (B, nq) joint positions (reference randomizers.py:39-81):

    - limited hinge/slide: uniform within range
    - unlimited hinge: uniform in [-pi, pi]
    - unlimited ball/free quaternion: uniform on the 3-sphere
    - limited ball: not ported yet (raises)
    - free-joint translations: untouched
  """
  qpos = qpos.clone()
  B = qpos.shape[0]
  kw = dict(generator=generator, dtype=qpos.dtype, device=qpos.device)
  for j in range(m.njnt):
    jtype = JointType(int(m.jnt_type[j]))
    limited = bool(m.jnt_limited[j])
    qadr = int(m.jnt_qposadr[j])
    lo, hi = (float(v) for v in m.jnt_range[j])
    if jtype in (JointType.HINGE, JointType.SLIDE):
      if limited:
        qpos[:, qadr] = lo + (hi - lo) * torch.rand(B, **kw)
      elif jtype == JointType.HINGE:
        qpos[:, qadr] = -math.pi + 2 * math.pi * torch.rand(B, **kw)
    elif limited:
      raise NotImplementedError('limited ball joints are not ported yet')
    else:
      start = qadr + (3 if jtype == JointType.FREE else 0)
      qpos[:, start:start + 4] = normalize(torch.randn(B, 4, **kw))
  return qpos


def has_contacts(m: Model, d: Data) -> torch.Tensor:
  """(B,) True where any contact is active at d's qpos (runs kinematics)."""
  d = _collision.collide(m, _smooth.kinematics(m, d))
  if d.contact.dist.shape[1] == 0:
    return torch.zeros(d.qpos.shape[0], dtype=torch.bool,
                       device=d.qpos.device)
  return (d.contact.dist < d.contact.includemargin).any(-1)


def select_collision_free(m: Model, candidates: List[Data]) -> Data:
  """Per lane, the first collision-free candidate, else the last one.

  Returns the first candidate with the chosen candidates' integration
  state (`forward.state_of`) in each lane."""
  ok = ~torch.stack([has_contacts(m, dk) for dk in candidates])  # (A, B)
  first = torch.argmax(ok.to(torch.int32), dim=0)
  idx = torch.where(ok.any(0), first, len(candidates) - 1)
  lanes = torch.arange(idx.shape[0], device=idx.device)
  return candidates[0].replace(**_forward.map_state(
      lambda *xs: torch.stack(xs)[idx, lanes],
      *[_forward.state_of(dk) for dk in candidates]))


def settle(m: Model, d: Data, n_steps: int) -> Data:
  """Step physics n times with the given (zero) ctrl and reset time (e.g.
  cheetah's 200-step settling, reference suite/cheetah.py:76-80)."""
  d = _forward.forward(m, d)  # establish the step1-synced invariant
  for _ in range(n_steps):
    d = _forward.step(m, d)
  return d.replace(time=torch.zeros_like(d.time))


def collision_free_init(
    sample_fn: Callable[[Data, torch.Generator], Data], m: Model, d: Data,
    generator: torch.Generator) -> Data:
  """First collision-free sample among `_MAX_ATTEMPTS` candidates per lane
  (the last candidate where none is free): the reference's rejection
  sampling (e.g. suite/finger.py) with every lane's candidates drawn at
  once."""
  return select_collision_free(
      m, [sample_fn(d, generator) for _ in range(_MAX_ATTEMPTS)])
