"""Soft-indicator reward primitives (torch).

The port of `dm_control_tpu/utils/rewards.py`: the reference's
`rewards.tolerance` with its sigmoid kernels, branch-free over tensors.
`bounds`, `margin` and `value_at_margin` are Python numbers.
"""

from __future__ import annotations

import numpy as np
import torch

_DEFAULT_VALUE_AT_MARGIN = 0.1


def _sigmoid(x, value_at_1: float, sigmoid: str):
  """Kernel value at normalized distance x (>= 0), equal to value_at_1 at 1."""
  v = value_at_1
  if sigmoid == 'gaussian':
    scale = np.sqrt(-2.0 * np.log(v))
    return torch.exp(-0.5 * (x * scale) ** 2)
  if sigmoid == 'hyperbolic':
    scale = np.arccosh(1.0 / v)
    return 1.0 / torch.cosh(x * scale)
  if sigmoid == 'long_tail':
    scale = np.sqrt(1.0 / v - 1.0)
    return 1.0 / ((x * scale) ** 2 + 1.0)
  if sigmoid == 'reciprocal':
    scale = 1.0 / v - 1.0
    return 1.0 / (x.abs() * scale + 1.0)
  if sigmoid == 'cosine':
    scale = np.arccos(2.0 * v - 1.0) / np.pi
    scaled = x * scale
    cos_val = torch.cos(np.pi * torch.clamp(scaled, -1.0, 1.0))
    return torch.where(scaled.abs() < 1, (1.0 + cos_val) / 2.0, 0.0)
  if sigmoid == 'linear':
    scaled = x * (1.0 - v)
    return torch.where(scaled.abs() < 1, 1.0 - scaled, 0.0)
  if sigmoid == 'quadratic':
    scaled = x * np.sqrt(1.0 - v)
    return torch.where(scaled.abs() < 1, 1.0 - scaled ** 2, 0.0)
  if sigmoid == 'tanh_squared':
    scale = np.arctanh(np.sqrt(1.0 - v))
    return 1.0 - torch.tanh(x * scale) ** 2
  raise ValueError(f'unknown sigmoid {sigmoid!r}')


def tolerance(x: torch.Tensor, bounds=(0.0, 0.0), margin=0.0,
              sigmoid: str = 'gaussian',
              value_at_margin: float = _DEFAULT_VALUE_AT_MARGIN):
  """Soft indicator: 1 inside [lower, upper], decaying outside over margin."""
  lower, upper = bounds
  if lower > upper:
    raise ValueError('lower bound must be <= upper bound')
  if margin < 0:
    raise ValueError('margin must be non-negative')
  in_bounds = (lower <= x) & (x <= upper)
  if margin == 0:
    return torch.where(in_bounds, 1.0, 0.0).to(x.dtype)
  d = torch.where(x < lower, lower - x, x - upper) / margin
  return torch.where(in_bounds, 1.0, _sigmoid(d, value_at_margin, sigmoid))
