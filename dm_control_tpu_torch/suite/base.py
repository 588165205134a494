"""Shared task machinery: batched episode randomizers.

The port of `dm_control_tpu/suite/base.py` for what walker uses.  Random
draws come from an explicit torch.Generator on the data's device; they do
not reproduce `jax.random` streams (tests feed both packages the same
states instead).
"""

from __future__ import annotations

import math

import torch

from dm_control_tpu_torch._src.math import normalize
from dm_control_tpu_torch._src.types import JointType, Model


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
