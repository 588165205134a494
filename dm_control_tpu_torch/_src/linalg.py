"""Batched small-matrix linear algebra for the engine.

The port of `dm_control_tpu/_src/linalg.py`.  The JAX package reaches its
Pallas kernels through `custom_vmap` dispatch and differentiates them
through `custom_jvp` rules (its linalg.py:157-222); here the batch axis
is explicit, and each entry point is a `torch.autograd.Function`:

  - forward: the kernel wrapper itself, CPU tensors taking the plain
    column-loop version, CUDA tensors the Hopper kernel (float32, n <=
    linalg_kernel.MAX_N) or an error.  Inside `plain()` the plain versions
    run on any device (the float64 path on the card).  Autograd never
    records the forward: the plain loops write in place.
  - backward: the transpose of the JAX package's JVP rule, written with
    torch ops (`torch.linalg.solve_triangular`, einsum) from the factor or
    solution the forward saved.  The JAX tangent path is plain
    `jax.scipy` code outside any Pallas kernel (`_plain_cho_solve`), and
    this is its counterpart, not a kernel.

The cotangents are those of the rules as written, for any (not only
symmetric) tangent of A and any (not only lower) tangent of L, which is
what `jax.vjp` of the JAX entry points gives:

  cholesky    L = chol(A):      A_bar = L^-T phi(L^T L_bar) L^-1,
              phi = the lower triangle with its diagonal halved
  cho_solve   x = (L L^T)^-1 b: g = (L L^T)^-1 x_bar, b_bar = g,
              L_bar = -(g x^T + x g^T) L
  solve_psd   x = A^-1 b:       g = A^-1 x_bar, b_bar = g, A_bar = -g x^T
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from dm_control_tpu_torch.ops import linalg_kernel

# true inside `plain()`: the forwards run the plain versions on any device
_PLAIN = contextvars.ContextVar('plain_k1', default=False)


@contextlib.contextmanager
def plain():
  """Inside, the entry points run K1's plain versions whatever the
  device: the caller's explicit choice of the float64 path on the card."""
  token = _PLAIN.set(True)
  try:
    yield
  finally:
    _PLAIN.reset(token)


def _tril_solve(l: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
  """(L L^T)^-1 t for lower L (B, n, n), t (B, n): two triangular solves
  (the JAX package's `_plain_cho_solve`)."""
  y = torch.linalg.solve_triangular(l, t[..., None], upper=False)
  return torch.linalg.solve_triangular(l.transpose(-1, -2), y,
                                       upper=True)[..., 0]


def _phi(x: torch.Tensor) -> torch.Tensor:
  """The lower triangle of x with its diagonal halved."""
  return torch.tril(x) - 0.5 * torch.diag_embed(
      torch.diagonal(x, dim1=-2, dim2=-1))


class _Cholesky(torch.autograd.Function):

  @staticmethod
  def forward(ctx, a):
    fn = (linalg_kernel.cholesky_plain if _PLAIN.get()
          else linalg_kernel.cholesky_batched)
    l = fn(a)
    ctx.save_for_backward(l)
    return l

  @staticmethod
  def backward(ctx, l_bar):
    (l,) = ctx.saved_tensors
    p = _phi(l.transpose(-1, -2) @ l_bar)
    x = torch.linalg.solve_triangular(l.transpose(-1, -2), p, upper=True)
    return torch.linalg.solve_triangular(l, x, upper=False, left=False)


class _ChoSolve(torch.autograd.Function):

  @staticmethod
  def forward(ctx, l, b):
    fn = (linalg_kernel.cho_solve_plain if _PLAIN.get()
          else linalg_kernel.cho_solve_batched)
    x = fn(l, b)
    ctx.save_for_backward(l, x)
    return x

  @staticmethod
  def backward(ctx, x_bar):
    l, x = ctx.saved_tensors
    g = _tril_solve(l, x_bar)
    l_bar = None
    if ctx.needs_input_grad[0]:
      l_bar = -(torch.einsum('Bi,Bj->Bij', g, x)
                + torch.einsum('Bi,Bj->Bij', x, g)) @ l
    return l_bar, g


class _SolvePsd(torch.autograd.Function):

  @staticmethod
  def forward(ctx, a, b):
    fn = (linalg_kernel.chol_solve_plain if _PLAIN.get()
          else linalg_kernel.chol_solve_batched)
    x = fn(a, b)
    # the JAX rule's primal-only factor (linalg.py:219): the tangent path
    # solves with chol(a), made in the backward by the forward's route
    ctx.plain = _PLAIN.get()
    ctx.save_for_backward(a, x)
    return x

  @staticmethod
  def backward(ctx, x_bar):
    a, x = ctx.saved_tensors
    l = (linalg_kernel.cholesky_plain if ctx.plain
         else linalg_kernel.cholesky_batched)(a)
    g = _tril_solve(l, x_bar)
    a_bar = None
    if ctx.needs_input_grad[0]:
      a_bar = -torch.einsum('Bi,Bj->Bij', g, x)
    return a_bar, g


def cholesky(a: torch.Tensor) -> torch.Tensor:
  """Lower Cholesky factor of (B, n, n) SPD matrices (K1a)."""
  return _Cholesky.apply(a)


def cho_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve A x = b given the lower Cholesky factor of A; b is (B, n)
  (K1c)."""
  return _ChoSolve.apply(l, b)


def solve_psd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """x = a^-1 b for SPD a, (B, n, n) @ (B, n) (K1b)."""
  return _SolvePsd.apply(a, b)
