"""Composer environments: the episode loop with the observation pipeline.

The port of `dm_control_tpu/composer/environment.py` (reference
composer/environment.py:271-403: hook dispatch and between-substep
observation updates).  Each control step runs the before_step hooks,
then per physics substep the before_substep hooks, one `forward.step`,
the after_substep hooks and `ObservationPipeline.update`; then the
after_step hooks, the reward, termination, divergence and the step limit.

`BatchedEnvironment` is the main path: B lanes of physics state and
observation buffers on the task's device.  A lane whose episode ends
(termination, divergence, time limit) returns its reward, and is reset
within the same step: the JAX package computes fresh states for every
lane and selects the done lanes' with `where`; eager PyTorch computes
them for the done lanes only, whole (every Data field, `model_var` and
the buffers), so the next step's acc stage reads a synced state.  The
observation returned is read after the reset, as in the JAX package.

`Environment` is the single-lane loop with the dm_env interface (the
port's own `rl.specs` types), over the same machinery at B = 1: it
recompiles the model each episode when an entity has an `mjcf_hook`
(reusing the running model with a `model_var` overlay when only
overlay-capable fields changed), and retries a divergent episode init up
to MAX_RESET_ATTEMPTS times (reference environment.py:296-323).

Randomness (init hooks, step hooks, corruptors) comes from one
torch.Generator per environment, on the model's device.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, NamedTuple
import warnings

import numpy as np
import torch

from dm_control_tpu_torch._src import forward as _forward
from dm_control_tpu_torch._src.types import Data
from dm_control_tpu_torch.composer.observation import ObservationPipeline
from dm_control_tpu_torch.composer.task import ComposerTask
from dm_control_tpu_torch.rl import specs


class Carry(NamedTuple):
  """BatchedEnvironment's state: physics, buffers, each lane's substep."""
  data: Data                  # (B, ...)
  obs_state: Dict[str, dict]  # ObservationPipeline buffers, (B, ...)
  substep: torch.Tensor       # (B,) i4 physics substeps this episode


_STAGES = ('before_step', 'before_substep', 'after_substep', 'after_step')


def _put_lanes(x, lanes: torch.Tensor, new):
  """x with rows `lanes` replaced by `new`'s rows, out of place, for a
  tensor, a dict of them or a dataclass of them (Data, Contact)."""
  if isinstance(x, torch.Tensor):
    return x.index_put((lanes,), new.to(x.dtype))
  if isinstance(x, dict):
    return {k: _put_lanes(v, lanes, new[k]) for k, v in x.items()}
  return dataclasses.replace(x, **{
      f.name: _put_lanes(getattr(x, f.name), lanes, getattr(new, f.name))
      for f in dataclasses.fields(x)})


class _Loop:
  """The control step and episode init both environments run."""

  def __init__(self, task: ComposerTask, model, dtype: torch.dtype):
    self.task, self.model, self.dtype = task, model, dtype
    self.device = model.device
    dt = model.opt.timestep
    ct = task.control_timestep or dt
    self.n_sub = max(1, int(round(ct / dt)))
    example = _forward.forward(
        model, _forward.make_data(model, 1, dtype, self.device))
    self.pipeline = ObservationPipeline(model, task.observables, example)
    self.hooks = {stage: task.step_hooks(stage) for stage in _STAGES}

  def run_hooks(self, stage, d, generator):
    for fn, prefix in self.hooks[stage]:
      d = fn(self.model, d, generator, prefix)
    return d

  def fresh(self, n: int, generator, overlay=None, check=False):
    """n forward-synced initial states and their buffers, updated at
    substep 0.  `overlay` ({Model field: array}) seeds every lane's
    `model_var`; `check` flags divergent inits."""
    m = self.model
    d = _forward.make_data(m, n, self.dtype, self.device)
    if overlay:
      mv = {k: torch.as_tensor(np.asarray(v), dtype=self.dtype,
                               device=self.device).expand(
                                   (n,) + np.shape(v)).clone()
            for k, v in overlay.items()}
      d = d.replace(model_var=mv)
      if 'qpos0' in mv:
        # make_data seeded qpos from the running model's qpos0
        d = d.replace(qpos=mv['qpos0'].clone())
    d = self.task.init_episode(m, d, generator)
    d = _forward.forward(m, d)
    if check:
      d = _forward._check_divergence(m, d)
    substep = torch.zeros((n,), dtype=torch.int32, device=self.device)
    obs_state = self.pipeline.update(
        self.pipeline.init_state(n, self.device), d, substep, generator)
    return d, obs_state

  def control_step(self, d: Data, obs_state, substep, action, generator):
    """One control step of every lane: (d, obs_state, substep, reward)."""
    m = self.model
    d = d.replace(ctrl=action.to(d.ctrl.dtype))
    d = self.run_hooks('before_step', d, generator)
    for _ in range(self.n_sub):
      d = self.run_hooks('before_substep', d, generator)
      d = _forward.step(m, d)
      d = self.run_hooks('after_substep', d, generator)
      obs_state = self.pipeline.update(obs_state, d, substep, generator)
      substep = substep + 1
    d = self.run_hooks('after_step', d, generator)
    return d, obs_state, substep, self.task.get_reward(m, d)


class Environment:
  """dm_env-shaped loop over a ComposerTask with buffered observables,
  one lane on the task's device.

  Between every physics substep the observation pipeline is advanced
  (reference composer/environment.py:363-373); observations are read from
  the delay buffers at control-step boundaries."""

  MAX_RESET_ATTEMPTS = 4  # ref composer/environment.py:296-323

  # model fields the engine reads through smooth.mparam(), i.e. the ones
  # a per-episode Data.model_var overlay can override
  OVERLAY_FIELDS = frozenset({
      'body_pos', 'body_quat', 'geom_pos', 'geom_rgba', 'hfield_data',
      'site_pos', 'wrap_prm', 'qpos0', 'qpos_spring'})

  def __init__(self, task: ComposerTask, time_limit: float = float('inf'),
               random=None, dtype: torch.dtype = torch.float32):
    self._task = task
    self._time_limit = time_limit
    self._dtype = dtype
    self._step_count = 0
    self._episode_count = 0
    seed = 0 if random is None else int(random)
    self._recompiles = task.has_mjcf_hooks
    self._base_model = None   # the model the running loop was built for
    self._overlay = {}        # model_var diff vs _base_model
    self._build(np.random.RandomState(seed))
    self._generator = torch.Generator(device=self._base_model.device)
    self._generator.manual_seed(seed)
    self._carry = None

  def _model_overlay_diff(self, new_m):
    """If `new_m` differs from the running base model only in
    overlay-capable array fields (same shapes everywhere), return the
    {field: value} diff; else None (full rebuild required)."""
    base = self._base_model
    if base is None:
      return None
    diff = {}
    for f in dataclasses.fields(type(base)):
      a, b = getattr(base, f.name), getattr(new_m, f.name)
      if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        if a is None or b is None or np.shape(a) != np.shape(b):
          return None
        if not np.array_equal(a, b):
          if f.name not in self.OVERLAY_FIELDS:
            return None
          diff[f.name] = b
      elif f.name == 'opt':
        if dataclasses.asdict(a) != dataclasses.asdict(b):
          return None
      elif f.name == 'names':
        if a != b:  # renames shift name->index maps: rebuild
          return None
      elif isinstance(a, (int, float, str, tuple)) and a != b:
        return None
    return diff

  def _build(self, random_state):
    """(Re)compile the task model and build the loop.  Called once at
    construction, and per episode when any entity has an mjcf_hook (the
    reference recompiles physics each episode, environment.py:296-323).
    When the recompiled model differs from the running one only in
    overlay-capable fields (poses, colors, hfield data), the running loop
    is kept and the new values ride a Data.model_var overlay."""
    task = self._task
    m = task.recompile(random_state) if self._recompiles else task.compile()
    diff = self._model_overlay_diff(m)
    if diff is not None:
      self._overlay = diff
      self._model = m
      return
    self._obs_spec = None  # spec may change shape after a real rebuild
    self._overlay = {}
    self._base_model = m
    self._model = m
    self._loop = _Loop(task, m, self._dtype)
    self._step_limit = (float('inf') if self._time_limit == float('inf')
                        else self._time_limit / (m.opt.timestep
                                                 * self._loop.n_sub))

  def reset(self) -> specs.TimeStep:
    self._episode_count += 1
    self._step_count = 0
    if self._recompiles:
      self._build(np.random.RandomState(self._episode_count))
    # retry failed episode inits (divergent initial state), as the
    # reference retries on PhysicsError (environment.py:296-323)
    for _ in range(self.MAX_RESET_ATTEMPTS):
      d, obs_state = self._loop.fresh(1, self._generator, self._overlay,
                                      check=True)
      if not bool(d.diverged[0]):
        break
    else:
      raise RuntimeError(
          f'episode initialization diverged in all '
          f'{self.MAX_RESET_ATTEMPTS} attempts')
    zero = torch.zeros((1,), dtype=torch.int32, device=self._loop.device)
    obs = self._loop.pipeline.read(obs_state, zero)
    self._carry = Carry(d, obs_state, zero + 1)
    return specs.TimeStep(specs.StepType.FIRST, None, None,
                          self._np_obs(obs))

  def step(self, action) -> specs.TimeStep:
    if self._carry is None:
      return self.reset()
    loop = self._loop
    action = torch.as_tensor(np.asarray(action), dtype=self._dtype,
                             device=loop.device).reshape(1, -1)
    d, obs_state, substep, reward = loop.control_step(
        *self._carry, action, self._generator)
    self._carry = Carry(d, obs_state, substep)
    obs = self._np_obs(loop.pipeline.read(obs_state, substep))
    self._step_count += 1
    reward = reward[0].detach().cpu().numpy()
    # multi-agent tasks return one reward per player
    reward = float(reward) if reward.ndim == 0 else reward
    term = self._task.get_termination(self._model, d)
    done_discount = None
    if term is not None and bool(term[0]):
      done_discount = 0.0
    if bool(d.diverged[0]):
      done_discount = 0.0
    if done_discount is not None:
      self._carry = None
      return specs.TimeStep(specs.StepType.LAST, reward, done_discount, obs)
    if self._step_count >= self._step_limit:
      self._carry = None
      return specs.TimeStep(specs.StepType.LAST, reward, 1.0, obs)
    return specs.TimeStep(specs.StepType.MID, reward, 1.0, obs)

  def _np_obs(self, obs):
    return collections.OrderedDict(
        (k, v[0].detach().cpu().numpy()) for k, v in obs.items())

  def action_spec(self) -> specs.BoundedArray:
    return specs.action_spec(self._model)

  def observation_spec(self):
    if getattr(self, '_obs_spec', None) is None:
      gen = torch.Generator(device=self._loop.device)
      gen.manual_seed(0)
      _, obs_state = self._loop.fresh(1, gen, self._overlay)
      obs = self._loop.pipeline.read(
          obs_state, torch.zeros((1,), dtype=torch.int32,
                                 device=self._loop.device))
      self._obs_spec = collections.OrderedDict(
          (k, specs.Array(shape=tuple(v.shape[1:]),
                          dtype=v[0].detach().cpu().numpy().dtype, name=k))
          for k, v in obs.items())
    return self._obs_spec

  @property
  def physics(self):
    """The running episode's Data (one lane), None between episodes."""
    return self._carry.data if self._carry is not None else None

  @property
  def task(self):
    return self._task


class BatchedEnvironment:
  """B independent lanes of (physics state + observation buffers) on the
  task's device, auto-reset on termination, divergence or the time limit.

  The suite path has parallel.runner.BatchedEnv; this is its composer
  analog with the buffered observable pipeline carried per lane (the
  reference composer has no batched path at all — every env is a
  separate Python object, composer/environment.py:271)."""

  def __init__(self, task: ComposerTask, batch_size: int,
               time_limit: float = float('inf'),
               dtype: torch.dtype = torch.float32):
    self._task = task
    if task.has_mjcf_hooks:
      warnings.warn(
          'BatchedEnvironment compiles the model once: per-episode MJCF '
          'variation (mjcf_hook) runs only at construction, not per '
          'reset. Use composer.Environment for per-episode recompiles.',
          stacklevel=2)
    m = task.compile(np.random.RandomState(0))
    self._model = m
    self._batch = batch_size
    self._loop = _Loop(task, m, dtype)
    self.n_sub_steps = self._loop.n_sub
    self.step_limit = (np.inf if time_limit == float('inf')
                       else int(round(time_limit / (m.opt.timestep
                                                    * self.n_sub_steps))))
    # episode-init, hook and corruptor draws (reset and auto-reset)
    self.generator = torch.Generator(device=m.device)
    self.reset_calls = 0    # auto-resets made by step

  @property
  def task(self):
    return self._task

  @property
  def model(self):
    return self._model

  @property
  def pipeline(self) -> ObservationPipeline:
    return self._loop.pipeline

  def reset(self, seed: int = 0) -> Carry:
    self.generator.manual_seed(seed)
    d, obs_state = self._loop.fresh(self._batch, self.generator)
    return Carry(d, obs_state, torch.ones((self._batch,), dtype=torch.int32,
                                          device=self._loop.device))

  def step(self, carry: Carry, actions: torch.Tensor):
    """carry, actions (B, nu) -> (carry, (obs dict, reward, done)); obs is
    read after the done lanes' reset."""
    loop, m = self._loop, self._model
    d, obs_state, substep, reward = loop.control_step(
        *carry, actions, self.generator)
    term = self._task.get_termination(m, d)
    done = d.diverged if term is None else term.to(torch.bool) | d.diverged
    if np.isfinite(self.step_limit):
      done = done | (substep >= self.step_limit * self.n_sub_steps)
    if bool(done.any()):
      self.reset_calls += 1
      lanes = done.nonzero().squeeze(1)
      fresh_d, fresh_obs = loop.fresh(int(lanes.numel()), self.generator)
      d = _put_lanes(d, lanes, fresh_d)
      obs_state = _put_lanes(obs_state, lanes, fresh_obs)
      substep = substep.index_put((lanes,), torch.ones_like(lanes,
                                                            dtype=torch.int32))
    obs = loop.pipeline.read(obs_state, substep)
    return Carry(d, obs_state, substep), (obs, reward, done)

  def action_spec(self) -> specs.BoundedArray:
    """Per-lane action spec (batch leading axis NOT included)."""
    return specs.action_spec(self._model)
