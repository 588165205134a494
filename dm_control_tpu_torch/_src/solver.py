"""Constraint solver: dense projected Newton on the soft-constraint QP.

The port of `dm_control_tpu/_src/solver.py`.  The problem is

  min_x  0.5 (x - a)' M (x - a) + sum_i c_i((J x - aref)_i)

with quadratic (equality), one-sided quadratic (limits, pyramid edges) and
Huber (friction loss) row costs, and a per-contact cone cost for elliptic
contacts.  The route follows the layout alone, as the JAX package's
`_get_core` does:
  - nv <= newton_kernel.MAX_NV: `newton_kernel.newton_solve_batched`, the
    Hopper kernels on the card (K2, or K2-ell for elliptic cones; they
    raise where one environment's problem does not fit a block), the
    batched torch core on the CPU;
  - nv > MAX_NV: `newton_kernel.newton_solve_core`, the counterpart of the
    JAX package's XLA core (its route for such layouts, solver.py:262-333)
    with K1b as its Newton step's factor-and-solve on the card.
Then, where the model asks for it (`opt.noslip_iterations`, dog), the
noslip sweeps refine the friction forces (`_noslip`).
"""

from __future__ import annotations

import numpy as np
import torch

from dm_control_tpu_torch._src import efc
from dm_control_tpu_torch._src.types import Data, DisableBit, Model, mirror
from dm_control_tpu_torch.ops import newton_kernel

LS_ITERATIONS = 12


def effective_tol(tol: float, dtype) -> float:
  """Termination tolerance with a float32 resolution floor.

  Suite models ship opt.tolerance = 1e-8, an f64 setting: at f32 the
  scaled cost improvement never resolves below ~1e-6, so without the
  floor every lane burns the full opt.iterations.  Kernel and torch core
  read the same value."""
  if dtype == torch.float32:
    return max(float(tol), 1e-6)
  return float(tol)


def solve(m: Model, d: Data) -> Data:
  """Compute qacc (and efc forces) from qacc_smooth + constraint rows."""
  lay = efc.layout(m)
  nefc = d.efc_J.shape[1]
  if nefc == 0 or m.nv == 0 or m.opt.disableflags & DisableBit.CONSTRAINT:
    return d.replace(qacc=d.qacc_smooth, qacc_warmstart=d.qacc_smooth,
                     qfrc_constraint=torch.zeros_like(d.qacc_smooth))
  dtype = d.qpos.dtype
  warm = (d.qacc_smooth if m.opt.disableflags & DisableBit.WARMSTART
          else d.qacc_warmstart)
  args = (d.efc_J, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss,
          d.efc_active.to(dtype), d.qacc_smooth, warm)
  kw = dict(niter=max(int(m.opt.iterations), 1), ls_iter=LS_ITERATIONS,
            tol=effective_tol(m.opt.tolerance, dtype),
            meaninertia=float(m.stat_meaninertia or 1.0))
  if m.nv > newton_kernel.MAX_NV:
    x, force = newton_kernel.newton_solve_core(*args, lay=lay, **kw)
  else:
    x, force = newton_kernel.newton_solve_batched(*args, lay=lay, **kw)
  if int(m.opt.noslip_iterations) > 0:
    x, force = _noslip(m, lay, d, x, force)
  qfrc_constraint = torch.einsum('Bev,Be->Bv', d.efc_J, force)
  return d.replace(qacc=x, qfrc_constraint=qfrc_constraint,
                   efc_force=force, qacc_warmstart=x)


def _noslip(m: Model, lay: efc.Layout, d: Data, x, force):
  """Post-solver friction refinement (the JAX package's `_noslip`, the
  reference's mj_noslip semantics): opt.noslip_iterations damped Jacobi
  sweeps on the unregularized residuals of the friction rows, each
  clamped to its cone section at the main solve's normal forces: a dof's
  friction-loss row to |f| <= frictionloss, a pyramid pair to |f+ - f-|
  <= f+ + f-, an elliptic contact's friction rows to the ellipse mu f_n
  scale; then x = qacc_smooth + (M^-1 J')' f.

  M^-1 J' comes from the step's factor d.qLD by one `torch.cholesky_solve`
  over the (B, nv, nefc) rows: the counterpart of the JAX package's
  `cho_solve_direct` (solver.py:196-198), which it computes outside any
  Pallas kernel; it is not K1c."""
  J, ref = d.efc_J, d.qpos
  minv_jt = torch.cholesky_solve(J.transpose(1, 2), d.qLD)    # (B, nv, nefc)
  diag_a = torch.clamp(torch.einsum('Bev,Bve->Be', J, minv_jt), min=1e-12)
  fric = mirror(m, ref, np.flatnonzero(lay.types == efc.FRICTION))
  c = lay.contact
  pyr = mirror(m, ref, c.pyr_row.reshape(-1, 2) if c is not None
               else np.zeros((0, 2), np.int64))
  ip, im = pyr[:, 0], pyr[:, 1]
  ell = [(mirror(m, ref, rows), mirror(m, ref, mu),
          mirror(m, ref, scale[:, 1:]))
         for _, (rows, mu, scale) in lay.ell_groups.items()]
  fl = d.efc_frictionloss[:, fric]

  def qacc_of(f):
    return d.qacc_smooth + torch.einsum('Bve,Be->Bv', minv_jt, f)

  for _ in range(int(m.opt.noslip_iterations)):
    jar = torch.einsum('Bev,Bv->Be', J, qacc_of(force)) - d.efc_aref
    jar = torch.where(d.efc_active, jar, 0.0)
    f = force.clone()
    if fric.numel():
      upd = f[:, fric] - jar[:, fric] / diag_a[:, fric]
      f[:, fric] = torch.clamp(upd, min=-fl, max=fl)
    if ip.numel():
      s = f[:, ip] + f[:, im]               # the pyramid's "normal" budget
      u = f[:, ip] - f[:, im]
      slip = 0.5 * (jar[:, ip] - jar[:, im])
      u = u - slip / (0.5 * (diag_a[:, ip] + diag_a[:, im]))
      u = torch.clamp(u, min=-s, max=s)
      f[:, ip] = 0.5 * (s + u)
      f[:, im] = 0.5 * (s - u)
    for rows, mu, scale in ell:
      fr = rows[:, 1:]
      fn = f[:, rows[:, 0]]
      upd = f[:, fr] - jar[:, fr] / diag_a[:, fr]
      # clamped to the cone's section at the current normal force
      lim = (mu * fn)[..., None] * scale
      norm = torch.sqrt(torch.clamp(
          ((upd / torch.clamp(lim, min=1e-12)) ** 2).sum(-1), min=1e-12))
      f[:, fr] = upd * torch.clamp(1.0 / norm, max=1.0)[..., None]
    force = f
  return qacc_of(force), force
