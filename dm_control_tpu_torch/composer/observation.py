"""Batched observable pipeline: update intervals, delays, buffers.

The port of `dm_control_tpu/composer/observation.py`.  The reference's
Observable/Buffer/Updater semantics (dm_control/composer/observation/
observable/base.py:60-160, obs_buffer.py:29-186, updater.py:125-323) as
ring buffers carried per lane:

  * every observable has `update_interval` (in physics substeps),
    `buffer_size`, `delay` (substeps until a sample becomes visible),
    an optional `aggregator` over the buffer, and an optional `corruptor`
    applied at sampling time;
  * each buffer is a dict of tensors with the lanes on the leading axis:
    `values` (B, capacity, *shape), `visible_at` (B, capacity) and
    `write_idx` (B,); `update` advances them at each lane's own substep
    (B,) and `read` returns (B, ...) observations.

Out-of-order delayed arrivals (reference obs_buffer.py:118-186) reduce,
for deterministic integer delays, to a delay line: a sample taken at
substep t becomes visible at t + delay; the ring stores (value,
visible_at) and `read` masks out entries still in flight.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from dm_control_tpu_torch._src.types import Data, Model

_NEVER = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class ObservableSpec:
  """One observable: a batched read of (Model, Data) plus sampling config.

  fn(model, data) -> (B, *shape) tensor.
  aggregator(buffer (B, buffer_size, *shape)) -> (B, ...), over axis 1.
  corruptor(value (B, *shape), generator) -> (B, *shape).
  """
  fn: Callable[[Model, Data], torch.Tensor]
  update_interval: int = 1
  buffer_size: int = 1
  delay: int = 0
  aggregator: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
  corruptor: Optional[Callable[[torch.Tensor, torch.Generator],
                               torch.Tensor]] = None
  enabled: bool = True


def camera_observable(*args, **kwargs) -> ObservableSpec:
  """The JAX package's camera observable renders through its analytic
  raytracer, which the port does not have."""
  raise NotImplementedError(
      'camera_observable needs the renderer (render.render, cameras and '
      'pixels), which is not ported yet')


@dataclasses.dataclass(frozen=True)
class _Entry:
  name: str
  spec: ObservableSpec
  shape: tuple
  dtype: Any


class ObservationPipeline:
  """Compiled pipeline over a dict of ObservableSpec.

  `example_data` (any batch size) fixes each observable's per-lane shape
  and dtype."""

  def __init__(self, model: Model, specs: Dict[str, ObservableSpec],
               example_data: Data):
    self.model = model
    self._entries = []
    for name, spec in specs.items():
      if not spec.enabled:
        continue
      val = spec.fn(model, example_data)
      self._entries.append(_Entry(name=name, spec=spec,
                                  shape=tuple(val.shape[1:]),
                                  dtype=val.dtype))

  @property
  def shapes(self) -> Dict[str, tuple]:
    """Per-lane shape of each enabled observable's sample."""
    return {e.name: e.shape for e in self._entries}

  def _capacity(self, spec: ObservableSpec) -> int:
    """Ring capacity: requested history + room for in-flight (delayed)
    samples so pending writes never evict arrived values (the reference
    Buffer keeps arriving items separate, obs_buffer.py:53-118)."""
    in_flight = 0
    if spec.delay > 0:
      in_flight = spec.delay // max(spec.update_interval, 1) + 1
    return spec.buffer_size + in_flight

  def init_state(self, batch_size: int, device) -> Dict[str, dict]:
    """Empty ring buffers of `batch_size` lanes."""
    state = {}
    for e in self._entries:
      cap = self._capacity(e.spec)
      state[e.name] = dict(
          values=torch.zeros((batch_size, cap) + e.shape, dtype=e.dtype,
                             device=device),
          visible_at=torch.full((batch_size, cap), _NEVER,
                                dtype=torch.int32, device=device),
          write_idx=torch.zeros((batch_size,), dtype=torch.int32,
                                device=device))
    return state

  def update(self, state, d: Data, substep: torch.Tensor,
             generator: Optional[torch.Generator] = None):
    """Advance the buffers of every lane at its physics substep index
    `substep` (B,) (0-based); a corruptor draws from `generator`."""
    new_state = {}
    for e in self._entries:
      st = state[e.name]
      cap = self._capacity(e.spec)
      due = (substep % e.spec.update_interval) == 0
      val = e.spec.fn(self.model, d)
      if e.spec.corruptor is not None:
        val = e.spec.corruptor(val, generator)
      slots = torch.arange(cap, device=substep.device)
      hit = (slots == (st['write_idx'] % cap)[:, None]) & due[:, None]
      values = torch.where(hit.view(hit.shape + (1,) * len(e.shape)),
                           val[:, None].to(e.dtype), st['values'])
      visible = torch.where(hit, (substep + e.spec.delay).to(
          torch.int32)[:, None], st['visible_at'])
      new_state[e.name] = dict(values=values, visible_at=visible,
                               write_idx=st['write_idx'] + due.to(torch.int32))
    return new_state

  def read(self, state, substep: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Observation dict at each lane's substep (B,): the newest
    `buffer_size` samples whose delay has elapsed, chronological (oldest
    first), zero-padded; (B, *shape) where the buffer holds one."""
    out = {}
    for e in self._entries:
      st = state[e.name]
      cap = self._capacity(e.spec)
      bs = e.spec.buffer_size
      values = st['values']
      # chronological ring order (oldest write first)
      order = ((st['write_idx'][:, None]
                + torch.arange(cap, device=values.device)) % cap).long()
      vals = torch.take_along_dim(
          values, order.view(order.shape + (1,) * len(e.shape)), dim=1)
      vis = (torch.take_along_dim(st['visible_at'], order, dim=1)
             <= substep.to(torch.int32)[:, None])
      # rank from the end among ARRIVED entries: 0 = newest arrived
      rank_from_end = vis.to(torch.int32).flip(1).cumsum(1).flip(1) - 1
      ok = vis & (rank_from_end < bs)
      slot = bs - 1 - rank_from_end
      # buf[:, s] = the entry sent to slot s (at most one per slot)
      sel = ok[:, None, :] & (
          slot[:, None, :]
          == torch.arange(bs, device=values.device)[None, :, None])
      buf = torch.where(
          sel.view(sel.shape + (1,) * len(e.shape)), vals[:, None],
          torch.zeros((), dtype=e.dtype, device=values.device)
      ).sum(2).to(e.dtype)
      if e.spec.aggregator is not None:
        out[e.name] = e.spec.aggregator(buf)
      elif bs == 1:
        out[e.name] = buf[:, 0]
      else:
        out[e.name] = buf
    return out
