"""Constraint solver: dense projected Newton on the soft-constraint QP.

The port of `dm_control_tpu/_src/solver.py`.  The problem is

  min_x  0.5 (x - a)' M (x - a) + sum_i c_i((J x - aref)_i)

with quadratic (equality), one-sided quadratic (limits, pyramid edges) and
Huber (friction loss) row costs, and a per-contact cone cost for elliptic
contacts.  The batched solve is `ops.newton_kernel.newton_solve_batched`:
the Hopper kernels on the card (K2, or K2-ell for elliptic cones; they
raise past their limits), the batched torch core on the CPU.
"""

from __future__ import annotations

import torch

from dm_control_tpu_torch._src import efc
from dm_control_tpu_torch._src.types import Data, DisableBit, Model
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
  if int(m.opt.noslip_iterations) > 0:
    raise NotImplementedError('noslip is not ported yet')
  dtype = d.qpos.dtype
  warm = (d.qacc_smooth if m.opt.disableflags & DisableBit.WARMSTART
          else d.qacc_warmstart)
  args = (d.efc_J, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss,
          d.efc_active.to(dtype), d.qacc_smooth, warm)
  kw = dict(niter=max(int(m.opt.iterations), 1), ls_iter=LS_ITERATIONS,
            tol=effective_tol(m.opt.tolerance, dtype),
            meaninertia=float(m.stat_meaninertia or 1.0))
  x, force = newton_kernel.newton_solve_batched(*args, lay=lay, **kw)
  qfrc_constraint = torch.einsum('Bev,Be->Bv', d.efc_J, force)
  return d.replace(qacc=x, qfrc_constraint=qfrc_constraint,
                   efc_force=force, qacc_warmstart=x)
