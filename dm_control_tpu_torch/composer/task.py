"""ComposerTask: compose entities into a compiled model + task functions.

The port of `dm_control_tpu/composer/task.py`, the functional analog of
dm_control.composer.Task (composer/task.py:44-318): a root entity (arena)
plus attached entities, compiled once through the port's MJCF compiler
and `setconst`; episode hooks and the reward and termination take batched
(Model, Data); observables come from the entities plus task-level
additions.  The Model's per-step arrays live on `device` (CUDA unless the
caller passes device='cpu').
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple
import xml.etree.ElementTree as ET

import torch

from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch._src.types import Data, Model
from dm_control_tpu_torch.composer.entity import Entity, attach
from dm_control_tpu_torch.composer.observation import ObservableSpec


@dataclasses.dataclass
class ComposerTask:
  """Arena + attached entities + reward/termination/init functions."""
  arena: Entity
  control_timestep: Optional[float] = None
  physics_timestep: Optional[float] = None
  device: Optional[str] = None

  def __post_init__(self):
    self._attachments: List[Tuple[Entity, dict]] = []
    self._observables: Dict[str, ObservableSpec] = {}
    # observables registered via add_observable(), kept separately so
    # they survive per-episode recompiles (recompile() rebuilds
    # _observables from entity factories; user specs are re-merged)
    self._user_observables: Dict[str, ObservableSpec] = {}
    self._reward_fn: Optional[Callable] = None
    self._termination_fn: Optional[Callable] = None
    self._init_fns: List[Callable] = []
    self._model: Optional[Model] = None

  # -- composition ---------------------------------------------------------

  def attach(self, entity: Entity, prefix: Optional[str] = None,
             site_body: Optional[str] = None, pos: Optional[str] = None):
    self._attachments.append(
        (entity, dict(prefix=prefix, site_body=site_body, pos=pos)))
    return self

  def add_observable(self, name: str, spec: ObservableSpec):
    self._user_observables[name] = spec
    if self._model is not None:
      self._observables[name] = spec
    return self

  def set_reward(self, fn: Callable[[Model, Data], torch.Tensor]):
    """fn(model, data) -> (B,) reward."""
    self._reward_fn = fn
    return self

  def set_termination(self, fn):
    """fn(model, data) -> (B,) bool."""
    self._termination_fn = fn
    return self

  def add_init_hook(self, fn):
    """fn(model, data, generator) -> Data, applied in order at episode
    init."""
    self._init_fns.append(fn)
    return self

  # -- compilation ---------------------------------------------------------

  def _entities(self):
    """(entity, prefix) of the arena (prefix None) and each attachment."""
    return [(self.arena, None)] + [
        (entity, kw.get('prefix') or entity.name)
        for entity, kw in self._attachments]

  @property
  def has_mjcf_hooks(self) -> bool:
    """True when any entity varies its MJCF per episode, so the
    environment must recompile each reset (ref environment.py:296)."""
    return any(e.mjcf_hook is not None for e, _ in self._entities())

  def step_hooks(self, stage: str):
    """[(fn, prefix)] for a step stage: before_step, before_substep,
    after_substep, after_step."""
    return [(getattr(e, f'{stage}_hook'), prefix)
            for e, prefix in self._entities()
            if getattr(e, f'{stage}_hook') is not None]

  def recompile(self, random_state=None) -> Model:
    """Re-run mjcf hooks on every entity fragment and rebuild the
    Model (per-episode MJCF variation, ref environment.py:296-323)."""
    self._model = None
    self._observables = {}
    return self.compile(random_state)

  def compile(self, random_state=None) -> Model:
    if self._model is not None:
      return self._model
    for entity, _ in self._entities():
      if entity.mjcf_hook is not None:
        entity.mjcf_hook(entity.mjcf_root, random_state)
    root = self.composed_root()
    self._model = engine.model_from_root(root, device=self.device)
    # entity observables resolve names post-compile
    for entity, prefix in self._entities()[1:]:
      for oname, factory in entity.observables.items():
        self._observables[f'{prefix}/{oname}'] = factory(self._model, prefix)
    for oname, factory in self.arena.observables.items():
      self._observables[oname] = factory(self._model, None)
    for entity, prefix in self._entities():
      if entity.after_compile_hook is not None:
        entity.after_compile_hook(self._model, prefix)
    # re-merge task-level observables (they survive recompiles)
    self._observables.update(self._user_observables)
    return self._model

  def composed_root(self) -> ET.Element:
    """The arena's fragment with every attachment grafted on, and the
    physics timestep where the task sets one: the MJCF that compiles."""
    root = copy.deepcopy(self.arena.mjcf_root)
    for entity, kw in self._attachments:
      attach(root, entity, **kw)
    if self.physics_timestep is not None:
      opt = root.find('option')
      if opt is None:
        opt = ET.SubElement(root, 'option')
      opt.set('timestep', str(self.physics_timestep))
    return root

  @property
  def model(self) -> Model:
    return self.compile()

  @property
  def observables(self) -> Dict[str, ObservableSpec]:
    self.compile()
    return dict(self._observables)

  def init_episode(self, m: Model, d: Data,
                   generator: torch.Generator) -> Data:
    for entity, prefix in self._entities()[1:]:
      if entity.init_hook is not None:
        d = entity.init_hook(m, d, generator, prefix)
    for fn in self._init_fns:
      d = fn(m, d, generator)
    return d

  def get_reward(self, m: Model, d: Data) -> torch.Tensor:
    if self._reward_fn is None:
      return torch.zeros_like(d.time)
    return self._reward_fn(m, d)

  def get_termination(self, m: Model, d: Data):
    if self._termination_fn is None:
      return None
    return self._termination_fn(m, d)
