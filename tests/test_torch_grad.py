"""Gradients through the port's step against the JAX package.

K1's entry points (`_src/linalg.py`) are autograd Functions whose
backward is the transpose of the JAX package's JVP rules: their
cotangents are held against `jax.vjp` of the JAX package's
`linalg.cholesky`, `cho_solve` and `solve_psd` on the same numpy SPD
inputs and cotangents (1e-10), and checked by `torch.autograd.gradcheck`
(SPD inputs through a symmetric parametrisation, lower factors through
`tril`: the forwards read only the lower triangle).  Then lqr's
`linearize` (reverse mode through the whole step) against the JAX
package's at float64 (1e-8), the Riccati gain against its `solve`, and
the closed loop's spectral radius.  The Newton solve has no gradient in
either package: it raises.  Float64 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dm_control_tpu import suite as jsuite
from dm_control_tpu._src import linalg as jlinalg
from dm_control_tpu.utils import lqr_solver as jlqr
from dm_control_tpu_torch import suite
from dm_control_tpu_torch._src import efc
from dm_control_tpu_torch._src import linalg
from dm_control_tpu_torch.ops import newton_kernel
from dm_control_tpu_torch.utils import lqr_solver

VJP_TOL = 1e-10
LQR_TOL = 1e-8


def _spd(rng, b, n):
  a = rng.randn(b, n, n)
  return a @ a.transpose(0, 2, 1) + n * np.eye(n)


def _sym(x):
  return 0.5 * (x + np.swapaxes(x, -1, -2))


def _jax_vjp(fn, args, cot):
  _, pull = jax.vjp(jax.vmap(fn), *(jnp.asarray(a) for a in args))
  return [np.asarray(c) for c in pull(jnp.asarray(cot))]


def _torch_vjp(fn, args, cot):
  ts = [torch.tensor(a, requires_grad=True) for a in args]
  torch.autograd.backward(fn(*ts), torch.from_numpy(cot))
  return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize('n', [1, 3, 9])
def test_k1_backward_matches_jax_vjp(n):
  rng = np.random.RandomState(n)
  B = 4
  A = _spd(rng, B, n)
  L = np.linalg.cholesky(A)
  b = rng.randn(B, n)
  errs = {}
  # cholesky: the cotangent of A, its symmetric part and in full
  cot = rng.randn(B, n, n)
  (ref,) = _jax_vjp(jlinalg.cholesky, [A], cot)
  (got,) = _torch_vjp(linalg.cholesky, [A], cot)
  errs['cholesky A (symmetric part)'] = np.abs(_sym(got) - _sym(ref)).max()
  errs['cholesky A'] = np.abs(got - ref).max()
  # cho_solve: the cotangents of L and b
  cot = rng.randn(B, n)
  ref = _jax_vjp(jlinalg.cho_solve, [L, b], cot)
  got = _torch_vjp(linalg.cho_solve, [L, b], cot)
  errs['cho_solve L'] = np.abs(got[0] - ref[0]).max()
  errs['cho_solve b'] = np.abs(got[1] - ref[1]).max()
  # solve_psd: the cotangents of A (symmetric part and in full) and b
  ref = _jax_vjp(jlinalg.solve_psd, [A, b], cot)
  got = _torch_vjp(linalg.solve_psd, [A, b], cot)
  errs['solve_psd A (symmetric part)'] = np.abs(_sym(got[0])
                                                - _sym(ref[0])).max()
  errs['solve_psd A'] = np.abs(got[0] - ref[0]).max()
  errs['solve_psd b'] = np.abs(got[1] - ref[1]).max()
  print(f'K1 backward vs jax.vjp n={n}: ' + ', '.join(
      f'{k} {e:.1e}' for k, e in errs.items()))
  assert max(errs.values()) <= VJP_TOL, errs


@pytest.mark.parametrize('n', [1, 3, 9])
def test_k1_gradcheck(n):
  rng = np.random.RandomState(10 + n)
  A = torch.from_numpy(_spd(rng, 2, n))
  S = (0.5 * A).requires_grad_()
  Lm = torch.linalg.cholesky(A).requires_grad_()
  b = torch.from_numpy(rng.randn(2, n)).requires_grad_()
  assert torch.autograd.gradcheck(
      lambda s: linalg.cholesky(s + s.transpose(1, 2)), (S,))
  assert torch.autograd.gradcheck(
      lambda l, r: linalg.cho_solve(torch.tril(l), r), (Lm, b))
  assert torch.autograd.gradcheck(
      lambda s, r: linalg.solve_psd(s + s.transpose(1, 2), r), (S, b))


def test_forward_keeps_the_wrappers_bits():
  """Through the Functions (with or without a gradient asked for) the
  forward is the plain version's, bit for bit, and `plain()` changes
  nothing on the CPU."""
  from dm_control_tpu_torch.ops import linalg_kernel as lk
  rng = np.random.RandomState(0)
  A = torch.from_numpy(_spd(rng, 3, 5))
  b = torch.from_numpy(rng.randn(3, 5))
  L = lk.cholesky_plain(A)
  for a in (A, A.clone().requires_grad_()):
    assert torch.equal(linalg.cholesky(a), L)
    assert torch.equal(linalg.solve_psd(a, b), lk.chol_solve_plain(A, b))
  assert torch.equal(linalg.cho_solve(L, b), lk.cho_solve_plain(L, b))
  with linalg.plain():
    assert torch.equal(linalg.cholesky(A), L)


def test_newton_solve_refuses_a_gradient():
  m = suite.build_task('reacher', 'easy', device='cpu').model
  lay = efc.layout(m)
  B, nefc, nv = 2, lay.nefc, m.nv
  z = lambda *s: torch.zeros((B,) + s, dtype=torch.float64)
  M = torch.eye(nv, dtype=torch.float64).expand(B, nv, nv).clone()
  args = [z(nefc, nv), M, z(nefc), z(nefc) + 1, z(nefc), z(nefc), z(nv),
          z(nv)]
  kw = dict(lay=lay, niter=5, ls_iter=3, tol=1e-8, meaninertia=1.0)
  newton_kernel.newton_solve_batched(*args, **kw)       # no gradient asked
  args[6] = args[6].requires_grad_()
  for solve in (newton_kernel.newton_solve_batched,
                newton_kernel.newton_solve_core):
    with pytest.raises(NotImplementedError, match='no gradient'):
      solve(*args, **kw)
  with torch.no_grad():
    newton_kernel.newton_solve_batched(*args, **kw)


@pytest.mark.parametrize('task_name', ['lqr_2_1', 'lqr_6_2'])
def test_lqr_linearize_matches_jax(task_name, monkeypatch):
  # the JAX package's linearize and solve as they are, their jacobians
  # compiled (run eagerly, every primitive compiles on its own: ~35 s per
  # task; compiled, ~3 s)
  jacobian = jax.jacobian
  monkeypatch.setattr(jax, 'jacobian',
                      lambda f, **kw: jax.jit(jacobian(f, **kw)))
  jtask = jsuite.build_task('lqr', task_name)
  task = suite.build_task('lqr', task_name, device='cpu')
  ja, jb = jlqr.linearize(jtask)
  a, b = lqr_solver.linearize(task)
  assert a.shape == ja.shape and b.shape == jb.shape
  errs = {'A': np.abs(a - ja).max(), 'B': np.abs(b - jb).max()}
  jk = jlqr.solve(jtask)
  k = lqr_solver.riccati_gain(a, b, task.model.nq)
  errs['K'] = np.abs(k - jk).max()
  radius = np.abs(np.linalg.eigvals(a - b @ k)).max()
  print(f'lqr {task_name}: max abs err ' + ', '.join(
      f'{n} {e:.1e}' for n, e in errs.items())
        + f'; spectral radius of A - BK {radius:.6f}')
  assert max(errs.values()) <= LQR_TOL, errs
  assert radius < 1.0
  # `solve` is linearize + riccati_gain
  assert np.array_equal(lqr_solver.solve(task), k)
