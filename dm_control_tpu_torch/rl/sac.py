"""Soft Actor-Critic learner over the port's batched environments.

The port of `dm_control_tpu/rl/sac.py`: twin-Q critics, a tanh-squashed
Gaussian actor, a learned temperature, a device-resident uniform replay
ring and a hand-written Adam, and one train step that runs act ->
`BatchedEnv.step` -> `replay_add` -> `replay_sample` -> `SAC.update`.

Acting and stepping run under `torch.no_grad()`: a graph through the
batch's physics would hold every intermediate of the step.  Randomness
comes from one explicit `torch.Generator` carried in the train step's
carry; `update` and `_sample_with_logp` also take the normal draws
themselves (`noise`), so that a caller can feed the draws another
implementation made.  The state is updated in place, as an optimizer
updates its parameters: `update` and `replay_add` return the object they
were given, with its tensors written.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dm_control_tpu_torch._src import forward as _forward
from dm_control_tpu_torch.parallel.runner import BatchedEnv
from dm_control_tpu_torch.rl.control import TaskDef

# Adam's constants (the JAX package's sac.py:232)
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


# ---------------------------------------------------------------------------
# MLP.
# ---------------------------------------------------------------------------


class MLP(nn.Module):
  """Linear layers with ReLU between them.  `nn.Linear` keeps its weight
  as (out, in): the transpose of the JAX package's `w` (`bridge` converts)."""

  def __init__(self, sizes: Sequence[int], dtype=torch.float32, device=None):
    super().__init__()
    self.layers = nn.ModuleList(
        nn.Linear(sizes[i], sizes[i + 1], dtype=dtype, device=device)
        for i in range(len(sizes) - 1))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(self.layers):
      x = layer(x)
      if i < len(self.layers) - 1:
        x = torch.relu(x)
    return x


def mlp_init(generator: torch.Generator, sizes: Sequence[int],
             dtype=torch.float32) -> MLP:
  """He-normal weights (N(0, 2 / fan_in)) from `generator`, zero biases,
  on the generator's device."""
  net = MLP(sizes, dtype=dtype, device=generator.device)
  with torch.no_grad():
    for layer in net.layers:
      fan_in = layer.in_features
      layer.weight.copy_(torch.randn(
          (layer.out_features, fan_in), generator=generator, dtype=dtype,
          device=generator.device) * math.sqrt(2.0 / fan_in))
      layer.bias.zero_()
  return net


def mlp_apply(net: nn.Module, x: torch.Tensor, final_act=None) -> torch.Tensor:
  x = net(x)
  return final_act(x) if final_act else x


# ---------------------------------------------------------------------------
# Replay ring buffer (device-resident).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Replay:
  obs: torch.Tensor       # (cap, obs_dim)
  action: torch.Tensor    # (cap, act_dim)
  reward: torch.Tensor    # (cap,)
  next_obs: torch.Tensor  # (cap, obs_dim)
  discount: torch.Tensor  # (cap,)
  ptr: int                # next row written
  size: int               # rows filled

  @property
  def capacity(self) -> int:
    return self.obs.shape[0]


def replay_init(capacity: int, obs_dim: int, act_dim: int,
                dtype=torch.float32, device=None) -> Replay:
  def z(*s):
    return torch.zeros(s, dtype=dtype, device=device)
  return Replay(obs=z(capacity, obs_dim), action=z(capacity, act_dim),
                reward=z(capacity), next_obs=z(capacity, obs_dim),
                discount=z(capacity), ptr=0, size=0)


def replay_add(buf: Replay, obs, action, reward, next_obs,
               discount) -> Replay:
  """Write a batch of B transitions at the ring pointer (wrapping at the
  capacity) and advance it.  The pointer and fill count are host integers
  (they follow from the batch's shape), so no step waits on the card."""
  cap, b = buf.capacity, obs.shape[0]
  idx = (buf.ptr + torch.arange(b, device=buf.obs.device)) % cap
  for name, x in (('obs', obs), ('action', action), ('reward', reward),
                  ('next_obs', next_obs), ('discount', discount)):
    getattr(buf, name)[idx] = x.to(buf.obs.dtype)
  buf.ptr = (buf.ptr + b) % cap
  buf.size = min(buf.size + b, cap)
  return buf


def replay_sample(buf: Replay, generator: torch.Generator, batch: int):
  """`batch` rows drawn uniformly from the filled part of the ring."""
  idx = torch.randint(0, max(buf.size, 1), (batch,), generator=generator,
                      device=buf.obs.device)
  return (buf.obs[idx], buf.action[idx], buf.reward[idx],
          buf.next_obs[idx], buf.discount[idx])


# ---------------------------------------------------------------------------
# SAC.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SACConfig:
  hidden: Tuple[int, ...] = (256, 256)
  gamma: float = 0.99
  tau: float = 0.005
  lr: float = 3e-4
  init_temperature: float = 0.1
  replay_capacity: int = 1 << 17
  learn_batch: int = 256
  seed: int = 0


@dataclasses.dataclass
class SACState:
  actor: MLP
  q1: MLP
  q2: MLP
  q1_target: MLP
  q2_target: MLP
  log_alpha: torch.Tensor     # () the temperature's log
  # Adam's first and second moments of the trained parameters, in the
  # order of `SAC.trained`: actor, q1, q2 (each layer's weight, bias),
  # log_alpha
  opt_m: List[torch.Tensor]
  opt_v: List[torch.Tensor]
  step: torch.Tensor          # () int32 updates made


class SAC:
  """SAC learner bound to a TaskDef's observation and action shapes, its
  tensors on the task's device at `dtype`."""

  def __init__(self, task: TaskDef, config: SACConfig = SACConfig(),
               dtype=torch.float32):
    self.task = task
    self.config = config
    self.dtype = dtype
    self.device = task.model.device
    # the observation's width at qpos0 (one lane)
    m = task.model
    d = _forward.forward(m, _forward.make_data(m, 1, torch.float32,
                                               self.device))
    self.obs_dim = int(self.obs_vector(task.get_observation(m, d)).shape[1])
    self.act_dim = m.nu
    self.target_entropy = -float(self.act_dim)

  def obs_vector(self, obs_dict) -> torch.Tensor:
    """(B, obs_dim): a batched observation dict flattened lane by lane."""
    return torch.cat([v.reshape(v.shape[0], -1) for v in obs_dict.values()],
                     dim=-1)

  def init(self, generator: Optional[torch.Generator] = None) -> SACState:
    if generator is None:
      generator = torch.Generator(device=self.device)
      generator.manual_seed(self.config.seed)
    h = list(self.config.hidden)
    o, a = self.obs_dim, self.act_dim
    actor = mlp_init(generator, [o] + h + [2 * a], self.dtype)
    q1 = mlp_init(generator, [o + a] + h + [1], self.dtype)
    q2 = mlp_init(generator, [o + a] + h + [1], self.dtype)
    log_alpha = torch.tensor(math.log(self.config.init_temperature),
                             dtype=self.dtype, device=self.device)
    state = SACState(actor=actor, q1=q1, q2=q2,
                     q1_target=_target(q1), q2_target=_target(q2),
                     log_alpha=log_alpha, opt_m=[], opt_v=[],
                     step=torch.zeros((), dtype=torch.int32,
                                      device=self.device))
    state.opt_m = [torch.zeros_like(p) for p in self.trained(state)]
    state.opt_v = [torch.zeros_like(p) for p in self.trained(state)]
    return state

  @staticmethod
  def trained(state: SACState) -> List[torch.Tensor]:
    """The parameters Adam updates, in the moments' order."""
    return (list(state.actor.parameters()) + list(state.q1.parameters())
            + list(state.q2.parameters()) + [state.log_alpha])

  # -- policy --------------------------------------------------------------

  def _dist(self, actor, obs):
    mu, log_std = mlp_apply(actor, obs).chunk(2, dim=-1)
    return mu, torch.clamp(log_std, -10.0, 2.0)

  def act(self, state: SACState, obs_vec, generator=None,
          deterministic=False, noise=None):
    mu, log_std = self._dist(state.actor, obs_vec)
    if deterministic:
      return torch.tanh(mu)
    eps = noise if noise is not None else torch.randn(
        mu.shape, generator=generator, dtype=mu.dtype, device=mu.device)
    return torch.tanh(mu + torch.exp(log_std) * eps)

  def _sample_with_logp(self, actor, obs, generator=None, noise=None):
    mu, log_std = self._dist(actor, obs)
    eps = noise if noise is not None else torch.randn(
        mu.shape, generator=generator, dtype=mu.dtype, device=mu.device)
    act = torch.tanh(mu + torch.exp(log_std) * eps)
    logp = torch.sum(
        -0.5 * (eps ** 2 + 2 * log_std + math.log(2 * math.pi))
        - torch.log(torch.clamp(1 - act ** 2, min=1e-6)), dim=-1)
    return act, logp

  # -- one learner update --------------------------------------------------

  def losses(self, state: SACState, batch, generator=None, noise=None):
    """(summed loss, metrics) of one update; the loss's graph reaches the
    trained parameters as the JAX package's `losses` does, its
    `stop_gradient`s as detached tensors."""
    obs, action, reward, next_obs, discount = batch
    cfg = self.config
    noise = noise if noise is not None else (None, None)

    def q_apply(q, params, o, a):
      x = torch.cat([o, a], dim=-1)
      if params is None:
        return q(x)[..., 0]
      return torch.func.functional_call(q, params, (x,))[..., 0]

    with torch.no_grad():
      next_a, next_logp = self._sample_with_logp(
          state.actor, next_obs, generator, noise[0])
      alpha = torch.exp(state.log_alpha)
      target_q = torch.minimum(q_apply(state.q1_target, None, next_obs, next_a),
                               q_apply(state.q2_target, None, next_obs, next_a))
      target = reward + cfg.gamma * discount * (target_q - alpha * next_logp)

    q1_pred = q_apply(state.q1, None, obs, action)
    q2_pred = q_apply(state.q2, None, obs, action)
    critic_loss = (torch.mean((q1_pred - target) ** 2)
                   + torch.mean((q2_pred - target) ** 2))
    a_new, logp = self._sample_with_logp(state.actor, obs, generator,
                                         noise[1])
    # the critics' parameters detached: the actor's gradient flows through
    # a_new only
    frozen = [{k: v.detach() for k, v in q.named_parameters()}
              for q in (state.q1, state.q2)]
    q_new = torch.minimum(q_apply(state.q1, frozen[0], obs, a_new),
                          q_apply(state.q2, frozen[1], obs, a_new))
    actor_loss = torch.mean(torch.exp(state.log_alpha.detach()) * logp - q_new)
    alpha_loss = -torch.mean(
        state.log_alpha * (logp + self.target_entropy).detach())
    metrics = dict(critic_loss=critic_loss.detach(),
                   actor_loss=actor_loss.detach(),
                   alpha_loss=alpha_loss.detach(),
                   alpha=torch.exp(state.log_alpha.detach()))
    return critic_loss + actor_loss + alpha_loss, metrics

  def gradients(self, state: SACState, batch, generator=None, noise=None):
    """(the summed loss's gradient of each of `trained(state)`, metrics).
    `noise`: the (next_obs, obs) normal draws, (B, act_dim) each, instead
    of draws from `generator`."""
    state.log_alpha.requires_grad_(True)
    try:
      with torch.enable_grad():
        loss, metrics = self.losses(state, batch, generator, noise)
        grads = torch.autograd.grad(loss, self.trained(state))
    finally:
      state.log_alpha.requires_grad_(False)
    return grads, metrics

  def update(self, state: SACState, batch, generator=None,
             noise=None) -> Tuple[SACState, Dict[str, torch.Tensor]]:
    """One gradient step of the summed loss with the JAX package's Adam
    (sac.py:230-245): lr_t = lr sqrt(1 - b2^t) / (1 - b1^t), p -= lr_t m /
    (sqrt(v) + eps), t in float32 as there; then the targets' Polyak
    averages.  `noise` as for `gradients`."""
    cfg = self.config
    params = self.trained(state)
    grads, metrics = self.gradients(state, batch, generator, noise)
    with torch.no_grad():
      state.step += 1
      t = state.step.to(torch.float32)
      lr_t = (cfg.lr * torch.sqrt(1 - _B2 ** t) / (1 - _B1 ** t)).to(
          self.dtype)
      for p, m, v, g in zip(params, state.opt_m, state.opt_v, grads):
        m.mul_(_B1).add_((1 - _B1) * g)
        v.mul_(_B2).add_((1 - _B2) * g * g)
        p.sub_(lr_t * m / (torch.sqrt(v) + _EPS))
      for target, q in ((state.q1_target, state.q1),
                        (state.q2_target, state.q2)):
        for tp, p in zip(target.parameters(), q.parameters()):
          tp.copy_((1 - cfg.tau) * tp + cfg.tau * p)
    return state, metrics


def _target(net: MLP) -> MLP:
  """A target network: a copy with its own tensors, no gradient."""
  return copy.deepcopy(net).requires_grad_(False)


def make_train_step(sac: SAC, env: BatchedEnv):
  """One fused actor + learner step over the batched env.

  carry = (sac_state, runner_state, replay, generator); each call: act ->
  env.step -> replay_add -> replay_sample -> sac.update, and returns
  (carry, metrics).  The generator's draws, in order: the actions' noise,
  the replay rows, the update's two noises.
  """
  task = sac.task
  m = task.model
  # actions in [-1, 1] map to the control range where limited, else [-1, 1]
  lo, hi = (torch.as_tensor(np.where(m.actuator_ctrllimited,
                                     m.actuator_ctrlrange[:, i], edge),
                            dtype=sac.dtype, device=sac.device)
            for i, edge in ((0, -1.0), (1, 1.0)))

  def train_step(carry):
    sac_state, run_state, replay, generator = carry
    with torch.no_grad():
      obs_vec = sac.obs_vector(task.get_observation(task.model,
                                                    run_state.data))
      actions = sac.act(sac_state, obs_vec, generator)
      scaled = lo + (actions + 1.0) * 0.5 * (hi - lo)
      run_state, (next_obs, reward, done, discount) = env.step(
          run_state, scaled)
      replay = replay_add(replay, obs_vec, actions, reward,
                          sac.obs_vector(next_obs), discount)
      batch = replay_sample(replay, generator, sac.config.learn_batch)
    sac_state, metrics = sac.update(sac_state, batch, generator)
    metrics['reward_mean'] = reward.mean()
    return (sac_state, run_state, replay, generator), metrics

  # the learner and the environments it drives
  train_step.sac, train_step.env = sac, env
  return train_step
