"""Color variations: RGB / HSV / gray-level RGBA generators.

The port of `dm_control_tpu/composer/colors.py`, the functional analog of
the reference's composer/variation/colors.py:20-79 (RgbVariation,
HsvVariation, GrayVariation): each channel may itself be a Variation (or
a constant), evaluated with the caller's torch.Generator in channel
order, and the result is an RGBA tensor, (4,) or (..., 4) where the
channels draw per lane (`shape=(B,)`).
"""

from __future__ import annotations

import torch

from dm_control_tpu_torch.composer.variation import Variation, evaluate


def _channels(channels, generator, initial_value, current_value):
  return [torch.as_tensor(evaluate(c, generator, initial_value,
                                   current_value),
                          dtype=torch.get_default_dtype(),
                          device=generator.device if generator is not None
                          else None)
          for c in channels]


def hsv_to_rgb(h, s, v):
  """Branch-free HSV -> RGB (colorsys.hsv_to_rgb semantics)."""
  h, s, v = torch.broadcast_tensors(*(torch.as_tensor(
      x, dtype=torch.get_default_dtype()) if not isinstance(x, torch.Tensor)
      else x for x in (h, s, v)))
  h = h % 1.0
  i = torch.floor(h * 6.0)
  f = h * 6.0 - i
  p = v * (1.0 - s)
  q = v * (1.0 - s * f)
  t = v * (1.0 - s * (1.0 - f))
  i = i.to(torch.int64) % 6
  sector = torch.stack([i == k for k in range(6)])

  def select(*vals):
    return (sector.to(v.dtype) * torch.stack(vals)).sum(0)

  return select(v, q, p, p, t, v), select(t, v, v, q, p, p), select(
      p, p, t, v, v, q)


class RgbVariation(Variation):
  """Independent variations of R, G, B (+ alpha) -> RGBA."""

  def __init__(self, r, g, b, alpha=1.0):
    self._channels = (r, g, b, alpha)

  def __call__(self, generator, initial_value=None, current_value=None):
    return torch.stack(torch.broadcast_tensors(*_channels(
        self._channels, generator, initial_value, current_value)), -1)


class HsvVariation(Variation):
  """Independent variations of H, S, V (+ alpha) -> RGBA."""

  def __init__(self, h, s, v, alpha=1.0):
    self._channels = (h, s, v, alpha)

  def __call__(self, generator, initial_value=None, current_value=None):
    h, s, v, alpha = _channels(self._channels, generator, initial_value,
                               current_value)
    r, g, b = hsv_to_rgb(h, s, v)
    return torch.stack(torch.broadcast_tensors(r, g, b, alpha), -1)


class GrayVariation(HsvVariation):
  """Gray-level (+ alpha) variation -> RGBA."""

  def __init__(self, gray_level, alpha=1.0):
    super().__init__(h=0.0, s=0.0, v=gray_level, alpha=alpha)
