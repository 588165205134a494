"""Discrete LQR solution for the lqr domain: the analytic policy oracle.

The port of `dm_control_tpu/utils/lqr_solver.py`.  The dynamics Jacobians
A = dx'/dx and B = dx'/du come from reverse-mode autograd through the
engine's own step (`torch.autograd.functional.jacobian`, as the JAX
package takes `jax.jacobian`): the step's K1a factor and K1c solve carry
their derivative rules as autograd Functions (`_src/linalg.py`).  The
discrete algebraic Riccati equation is solved by the same numpy
fixed-point iteration.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from dm_control_tpu_torch._src import forward as _forward
from dm_control_tpu_torch._src import linalg
from dm_control_tpu_torch.rl.control import TaskDef


def linearize(task: TaskDef, dtype: torch.dtype = torch.float64,
              plain: bool = False):
  """(A, B) of the control step's map around the origin, state = [qpos;
  qvel], as numpy float64 arrays.

  One lane on the task's device at `dtype`.  On the card the step's K1
  calls launch the kernels (float32 only); `plain=True` runs their plain
  versions there instead (`linalg.plain`), which float64 on the card
  needs."""
  m = task.model
  nq, nv, nu = m.nq, m.nv, m.nu
  device = m.device

  def step_map(state, u):
    d = _forward.make_data(m, 1, dtype, device)
    d = d.replace(qpos=state[None, :nq], qvel=state[None, nq:],
                  ctrl=u[None])
    d = _forward.forward(m, d)  # establish the step1-synced invariant
    for _ in range(task.n_sub_steps()):
      d = _forward.step(m, d)
    return torch.cat([d.qpos[0], d.qvel[0]])

  x0 = torch.zeros(nq + nv, dtype=dtype, device=device)
  u0 = torch.zeros(nu, dtype=dtype, device=device)
  with linalg.plain() if plain else contextlib.nullcontext():
    a, b = torch.autograd.functional.jacobian(step_map, (x0, u0))
  return (a.detach().cpu().double().numpy(),
          b.detach().cpu().double().numpy())


def riccati_gain(a: np.ndarray, b: np.ndarray, nq: int,
                 control_cost_coef: float = 0.1,
                 iterations: int = 2000) -> np.ndarray:
  """K of u = -K [qpos; qvel] for x' = A x + B u under the cost |qpos|^2
  + control_cost_coef |u|^2 (the JAX package's `solve` after its
  linearize)."""
  n = a.shape[0]
  q = np.zeros((n, n))
  q[:nq, :nq] = np.eye(nq)  # reward penalizes position only
  r = control_cost_coef * np.eye(b.shape[1])

  p = q.copy()
  for _ in range(iterations):
    btp = b.T @ p
    k = np.linalg.solve(r + btp @ b, btp @ a)
    p_new = q + a.T @ p @ (a - b @ k)
    if np.abs(p_new - p).max() < 1e-12:
      p = p_new
      break
    p = p_new
  btp = b.T @ p
  return np.linalg.solve(r + btp @ b, btp @ a)


def solve(task: TaskDef, control_cost_coef: float = 0.1,
          iterations: int = 2000, **linearize_kw) -> np.ndarray:
  """Optimal feedback gain K: u = -K [qpos; qvel]."""
  a, b = linearize(task, **linearize_kw)
  return riccati_gain(a, b, task.model.nq, control_cost_coef, iterations)
