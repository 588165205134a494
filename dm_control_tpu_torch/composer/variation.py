"""Composable random-variation DSL (reference: composer/variation/).

The port of `dm_control_tpu/composer/variation.py`: the reference's
operator-overloaded Variation classes (variation/base.py:31-131,
distributions.py:32-190, noises.py:26-65, rotations.py) as functions of
a torch.Generator: `evaluate(v, generator, initial_value, current_value)`.
Draws come from the generator in evaluation order, on its device, at
torch's default floating dtype; `shape=(B,)` draws one value per lane.
"""

from __future__ import annotations

import operator

import numpy as np
import torch


def evaluate(value, generator, initial_value=None, current_value=None):
  """Resolve nested Variations / containers to concrete values."""
  if isinstance(value, Variation):
    return value(generator, initial_value, current_value)
  if isinstance(value, (tuple, list)):
    return type(value)(
        evaluate(v, generator, initial_value, current_value) for v in value)
  return value


class Variation:
  """Base: callable (generator, initial_value, current_value) -> value,
  with arithmetic composition mirroring the reference's operator
  overloads."""

  def __call__(self, generator, initial_value=None, current_value=None):
    raise NotImplementedError

  def _binary(self, other, op, swap=False):
    return _BinaryOp(self, other, op, swap)

  def __add__(self, o): return self._binary(o, operator.add)
  def __radd__(self, o): return self._binary(o, operator.add, True)
  def __sub__(self, o): return self._binary(o, operator.sub)
  def __rsub__(self, o): return self._binary(o, operator.sub, True)
  def __mul__(self, o): return self._binary(o, operator.mul)
  def __rmul__(self, o): return self._binary(o, operator.mul, True)
  def __truediv__(self, o): return self._binary(o, operator.truediv)
  def __rtruediv__(self, o): return self._binary(o, operator.truediv, True)
  def __pow__(self, o): return self._binary(o, operator.pow)
  def __neg__(self): return _UnaryOp(self, operator.neg)
  def __abs__(self): return _UnaryOp(self, abs)


class _BinaryOp(Variation):
  def __init__(self, a, b, op, swap=False):
    self._a, self._b, self._op, self._swap = a, b, op, swap

  def __call__(self, generator, initial_value=None, current_value=None):
    a = evaluate(self._a, generator, initial_value, current_value)
    b = evaluate(self._b, generator, initial_value, current_value)
    return self._op(b, a) if self._swap else self._op(a, b)


class _UnaryOp(Variation):
  def __init__(self, a, op):
    self._a, self._op = a, op

  def __call__(self, generator, initial_value=None, current_value=None):
    return self._op(evaluate(self._a, generator, initial_value,
                             current_value))


def _tensor(x, generator):
  return torch.as_tensor(x, dtype=torch.get_default_dtype(),
                         device=generator.device)


class _Distribution(Variation):
  """A torch sampler; args may themselves be Variations (reference
  distributions.py:32-64 semantics).  single_sample draws a scalar even
  when args are arrays (matching the reference flag)."""

  def __init__(self, *args, single_sample=False, shape=(), **kwargs):
    self._args = args
    self._kwargs = kwargs
    self._single = single_sample
    self._shape = tuple(shape)

  def _sample(self, generator, *args, **kwargs):
    raise NotImplementedError

  def _draw_shape(self, *args):
    if self._shape or self._single:
      return self._shape
    return np.broadcast_shapes(*(np.shape(a) for a in args))

  def __call__(self, generator, initial_value=None, current_value=None):
    args = [evaluate(a, generator, initial_value, current_value)
            for a in self._args]
    kwargs = {n: evaluate(v, generator, initial_value, current_value)
              for n, v in self._kwargs.items()}
    return self._sample(generator, *args, **kwargs)


def _rand(shape, generator):
  return torch.rand(shape, generator=generator, device=generator.device,
                    dtype=torch.get_default_dtype())


def _randn(shape, generator):
  return torch.randn(shape, generator=generator, device=generator.device,
                     dtype=torch.get_default_dtype())


class Uniform(_Distribution):
  def __init__(self, low=0.0, high=1.0, **kw):
    super().__init__(low, high, **kw)

  def _sample(self, generator, low, high):
    low, high = _tensor(low, generator), _tensor(high, generator)
    return low + (high - low) * _rand(self._draw_shape(low, high),
                                      generator)


class Normal(_Distribution):
  def __init__(self, loc=0.0, scale=1.0, **kw):
    super().__init__(loc, scale, **kw)

  def _sample(self, generator, loc, scale):
    return loc + scale * _randn(self._draw_shape(loc), generator)


class LogNormal(_Distribution):
  def __init__(self, mean=0.0, sigma=1.0, **kw):
    super().__init__(mean, sigma, **kw)

  def _sample(self, generator, mean, sigma):
    return torch.exp(mean + sigma * _randn(self._draw_shape(mean),
                                           generator))


class Exponential(_Distribution):
  def __init__(self, scale=1.0, **kw):
    super().__init__(scale, **kw)

  def _sample(self, generator, scale):
    e = torch.empty(self._draw_shape(scale), device=generator.device,
                    dtype=torch.get_default_dtype())
    return scale * e.exponential_(generator=generator)


class Bernoulli(_Distribution):
  def __init__(self, prob=0.5, **kw):
    super().__init__(prob, **kw)

  def _sample(self, generator, prob):
    return _rand(self._draw_shape(prob), generator) < _tensor(prob,
                                                              generator)


class Poisson(_Distribution):
  """Poisson counts (reference distributions.py:150-158)."""

  def __init__(self, lam=1.0, **kw):
    super().__init__(lam, **kw)

  def _sample(self, generator, lam):
    rate = _tensor(lam, generator).expand(self._draw_shape(lam))
    return torch.poisson(rate.contiguous(), generator=generator)


class UniformChoice(_Distribution):
  def __init__(self, choices, **kw):
    super().__init__(**kw)
    self._choices = choices

  def _sample(self, generator):
    choices = torch.as_tensor(self._choices, device=generator.device)
    i = torch.randint(0, len(choices), self._shape, generator=generator,
                      device=generator.device)
    return choices[i]


class UniformPointOnSphere(Variation):
  """Uniform direction in R^3 (reference distributions.py:150-160)."""

  def __call__(self, generator, initial_value=None, current_value=None):
    v = _randn((3,), generator)
    return v / torch.linalg.norm(v)


class BiasedRandomWalk(Variation):
  """OU-style random walk (reference distributions.py:163-190).  The
  reference mutates internal state; here the walk reads `current_value`
  and returns the next value, so batched lanes stay independent."""

  def __init__(self, stdev=0.1, timescale=10.0):
    self._stdev = stdev
    self._timescale = timescale

  def __call__(self, generator, initial_value=None, current_value=None):
    cur = 0.0 if current_value is None else current_value
    retention = np.exp(-1.0 / self._timescale)
    scale = self._stdev * np.sqrt(1 - retention ** 2)
    return retention * cur + scale * _randn(np.shape(cur), generator)


# -- noises (reference noises.py:26-65) --------------------------------------


class Additive(Variation):
  def __init__(self, distribution):
    self._d = distribution

  def __call__(self, generator, initial_value=None, current_value=None):
    cur = initial_value if current_value is None else current_value
    return cur + evaluate(self._d, generator, initial_value, current_value)


class Multiplicative(Variation):
  def __init__(self, distribution):
    self._d = distribution

  def __call__(self, generator, initial_value=None, current_value=None):
    cur = initial_value if current_value is None else current_value
    return cur * evaluate(self._d, generator, initial_value, current_value)


# -- rotations (reference rotations.py) ---------------------------------------


class UniformQuaternion(Variation):
  def __call__(self, generator, initial_value=None, current_value=None):
    q = _randn((4,), generator)
    return q / torch.linalg.norm(q)


class QuaternionFromAxisAngle(Variation):
  def __init__(self, axis, angle):
    self._axis, self._angle = axis, angle

  def __call__(self, generator, initial_value=None, current_value=None):
    axis = _tensor(evaluate(self._axis, generator, initial_value,
                            current_value), generator)
    angle = _tensor(evaluate(self._angle, generator, initial_value,
                             current_value), generator)
    axis = axis / torch.linalg.norm(axis)
    half = angle / 2
    return torch.cat([torch.cos(half)[None], axis * torch.sin(half)])
