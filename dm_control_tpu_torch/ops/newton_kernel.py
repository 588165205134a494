"""Batched projected-Newton constraint solve: CUDA kernel, plain twin, and
the core for layouts past the kernel's dofs.

The port of `dm_control_tpu/ops/newton_kernel.py` (K2).  Per environment
it minimises 0.5 (x - a)' M (x - a) + sum_i c_i((J x - aref)_i) with the
reference's exit rule and returns qacc (B, nv) and the row forces
(B, nefc).

A CPU tensor goes to `newton_solve_plain`, the batched torch core (the
counterpart of `solver._solve_core_xla`, with one done mask per lane in
place of the single-environment while loop).  A CUDA tensor goes to the
kernel in `csrc/newton_kernel.cu` or raises.  Its launches count as K2
on layouts without elliptic cones and as K2-ell (the TPU kernel's
`ell_terms` branch) on layouts with them.  The kernel runs one warp per
environment with its problem in shared memory and reads the batch-first
tensors as they are: one dof per lane and J in shared memory up to nv 32,
two dofs per lane and J read from device memory past it.  Elliptic
contacts of every condim the TPU kernel takes (3, 4 and 6, mixed in one
layout) go to one instantiation per layout's largest condim (C = 3, or 6
where any contact has 4 or 6 rows).  Its own limits replace the TPU
kernel's VMEM gate: nv <= MAX_NV (the TPU kernel's own limit) and one
environment's problem within a block's shared memory (`launch_config`);
anything else raises on the card.

Layouts past MAX_NV (dog's nv 79 and 85) take `newton_solve_core`: the
JAX package's own route for them (`solver._get_core`'s `fits` gate sends
them to `_solve_core_xla`, solver.py:262-333), whose Newton step
`linalg.solve_psd` runs the Pallas K1b kernel under the environment
vmap.  Here it is `newton_solve_plain` with its factor-and-solve given
as `linalg_kernel.chol_solve_batched`: K1b on the card, launched once per
iteration of the batch's loop, the plain twin on the CPU.  It is that
route, not a fallback: `newton_solve_batched` still raises past MAX_NV.
"""

from __future__ import annotations

import numpy as np
import torch

from dm_control_tpu_torch._src import efc
from dm_control_tpu_torch.ops import build
from dm_control_tpu_torch.ops import linalg_kernel

# dofs the kernel takes (csrc/newton_kernel.cu MAX_NV): one per lane up
# to LANE_NV, two per lane past it
MAX_NV = 64
LANE_NV = 32
# environments (warps) per block, at most (csrc/newton_kernel.cu MAX_WARPS)
MAX_WARPS = 4
# dynamic shared memory one block may use on sm_90 (227 KB)
SMEM_LIMIT = 232448
# the largest elliptic condims the kernel is instantiated for
# (csrc/newton_kernel.cu newton_kernel<S, C>)
CONE_WIDTHS = (3, 6)

# launches of each kernel since the last reset_launches() (plain-version
# calls do not count): K2 and K2-ell
LAUNCHES = {'newton_solve_batched': 0, 'newton_solve_ell': 0}
# `newton_solve_core`'s calls and the iterations of their batch loops
# since the last reset_launches(): one chol_solve_batched (K1b) each
CORE_LOOPS = {'calls': 0, 'loops': 0}


def reset_launches() -> None:
  for k in LAUNCHES:
    LAUNCHES[k] = 0
  for k in CORE_LOOPS:
    CORE_LOOPS[k] = 0


# ---------------------------------------------------------------------------
# Plain version: the batched torch core.
# ---------------------------------------------------------------------------


def _diag_terms(jar, d_, fl, active, is_eq, is_fr, is_one):
  """Per-row force / quadratic-zone weight / per-lane cost (B, nefc)."""
  f_eq = -d_ * jar
  f_one = torch.where(jar < 0, f_eq, 0.0)
  f_fr = torch.maximum(torch.minimum(f_eq, fl), -fl)
  on = active > 0
  f = torch.where(is_eq, f_eq, torch.where(is_fr, f_fr,
                                           torch.where(is_one, f_one, 0.0)))
  f = torch.where(on, f, 0.0)
  quad_fr = d_ * jar.abs() <= fl
  quad = is_eq | (is_fr & quad_fr) | (is_one & (jar < 0))
  w = torch.where(quad & on, d_, 0.0)
  c_quad = 0.5 * d_ * jar * jar
  lin = fl * jar.abs() - 0.5 * fl * fl / torch.clamp(d_, min=1e-14)
  c_fr = torch.where(quad_fr, c_quad, lin)
  c_one = torch.where(jar < 0, c_quad, 0.0)
  c = torch.where(is_eq, c_quad, torch.where(is_fr, c_fr,
                                             torch.where(is_one, c_one, 0.0)))
  cost = torch.where(on, c, 0.0).sum(-1)
  return f, w, cost


def _select(cond, a, b):
  """Per-lane choice between two (diagonal weights, elliptic blocks)."""
  (wa, ba), (wb, bb) = a, b
  w = torch.where(cond, wa, wb)
  c4 = cond.reshape(-1, 1, 1, 1)
  return w, [(rows, torch.where(c4, Wa, Wb))
             for (rows, Wa), (_, Wb) in zip(ba, bb)]


def _ell_terms(jar, d_, active, groups):
  """Elliptic-cone contacts: row forces, cost and cone Hessian blocks.

  The batched counterpart of `solver._ell_terms` of the JAX package, for
  any condim.  `groups` holds (rows (ncg, k) long, mu (ncg,), s (ncg, k))
  per condim.  Each contact's residuals y = jar * s, with normal n and
  tangential norm t, fall in one of three zones:

    top    (n >= mu t):   no force, no cost
    bottom (mu n <= -t):  0.5 D (n^2 + t^2), fully quadratic
    middle:               0.5 D (mu t - n)^2 / (1 + mu^2)

  Returns the (B, nefc) row forces (zero outside elliptic rows), the
  (B,) cost, and per group (rows, W (B, ncg, k, k)): the Hessian of the
  cost in the raw residuals jar.
  """
  f = torch.zeros_like(jar)
  cost = jar.new_zeros(jar.shape[0])
  blocks = []
  for rows, mu, s in groups:
    k = rows.shape[1]
    dn = d_[:, rows[:, 0]]                       # (B, ncg)
    ac = active[:, rows[:, 0]]
    y = jar[:, rows] * s                         # (B, ncg, k)
    n = y[..., 0]
    t2 = (y[..., 1:] ** 2).sum(-1)
    t = torch.sqrt(torch.clamp(t2, min=1e-30))
    mu2p1 = 1.0 + mu * mu
    top = n >= mu * t
    bottom = mu * n <= -t
    mid = ~top & ~bottom

    u = y[..., 1:] / t[..., None]
    fn_mid = dn * (mu * t - n) / mu2p1
    f_mid = torch.cat([fn_mid[..., None], (-mu * fn_mid)[..., None] * u], -1)
    f_sc = torch.where(bottom[..., None], -dn[..., None] * y,
                       torch.where(mid[..., None], f_mid, 0.0))
    f[:, rows] = f_sc * s * ac[..., None]

    c_bot = 0.5 * dn * (n * n + t2)
    c_mid = 0.5 * dn * (mu * t - n) ** 2 / mu2p1
    c = torch.where(bottom, c_bot, torch.where(mid, c_mid, 0.0))
    cost = cost + (c * ac).sum(-1)

    # W = D I at the bottom; in the middle
    #   D / (1 + mu^2) v v' + mu fn / t (P - e e'),
    # v = (1, -mu u), e = (0, u), P = diag(0, 1, .., 1)
    eye = torch.eye(k, dtype=jar.dtype, device=jar.device)
    p_fr = torch.diag(torch.cat([eye.new_zeros(1), eye.new_ones(k - 1)]))
    v = torch.cat([torch.ones_like(n)[..., None], -mu[:, None] * u], -1)
    e = torch.cat([torch.zeros_like(n)[..., None], u], -1)
    w_mid = ((dn / mu2p1)[..., None, None] * v[..., :, None] * v[..., None, :]
             + (mu * fn_mid / t)[..., None, None]
             * (p_fr - e[..., :, None] * e[..., None, :]))
    w_sc = torch.where(bottom[..., None, None], dn[..., None, None] * eye,
                       torch.where(mid[..., None, None], w_mid, 0.0))
    W = w_sc * s[:, :, None] * s[:, None, :] * ac[..., None, None]
    blocks.append((rows, W))
  return f, cost, blocks


def _ell_groups(lay_groups, device, dtype):
  """(rows, mu, scale) tensors of every elliptic group of a layout."""
  return [(torch.as_tensor(rows, dtype=torch.long, device=device),
           torch.as_tensor(mu, dtype=dtype, device=device),
           torch.as_tensor(scale, dtype=dtype, device=device))
          for _, (rows, mu, scale) in sorted(lay_groups.items())]


def newton_solve_plain(J, M, aref, d_, fl, active, a, warm, *, types, niter,
                       ls_iter, tol, meaninertia, ell_groups=None,
                       return_iters=False, chol_solve=None,
                       return_loops=False):
  """Batched projected Newton with per-lane exit (plain torch).

  J (B, nefc, nv), M (B, nv, nv), aref/d_/fl/active (B, nefc) with active
  as 0/1 floats, a/warm (B, nv); `types` the (nefc,) row types and
  `ell_groups` the layout's elliptic groups ({condim: (rows, mu,
  scale)}, `efc.Layout.ell_groups`).  A lane that meets the exit rule is
  frozen while the others iterate, which is the single-environment loop's
  result lane by lane.  Each iteration's Newton step solves H d = -grad
  for the whole batch with `chol_solve(H, grad)` (default
  `linalg_kernel.chol_solve_plain`, the factor and the substitutions of
  the plain K1 versions).  With `return_loops`, the loop's iteration
  count (the largest lane's, 0 where every lane starts done) comes last.
  """
  chol_solve = chol_solve or linalg_kernel.chol_solve_plain
  B, nefc, nv = J.shape
  types = torch.as_tensor(types, device=J.device)
  is_eq = types == efc.EQUALITY
  is_fr = types == efc.FRICTION
  is_one = types == efc.ONESIDED
  ell = _ell_groups(ell_groups or {}, J.device, J.dtype)
  scale = 1.0 / (max(meaninertia, 1e-12) * max(nv, 1))
  eye_reg = 1e-12 * torch.eye(nv, dtype=J.dtype, device=J.device)

  def mv(A, x):
    return torch.einsum('buv,bv->bu', A, x)

  def terms(jar):
    """Row forces, diagonal weights, cost and elliptic Hessian blocks."""
    f, w, c = _diag_terms(jar, d_, fl, active, is_eq, is_fr, is_one)
    if not ell:
      return f, w, c, []
    f_e, c_e, blocks = _ell_terms(jar, d_, active, ell)
    return f + f_e, w, c + c_e, blocks

  def eval_point(x, jar):
    f, w, c, blocks = terms(jar)
    mxa = mv(M, x - a)
    cost = 0.5 * ((x - a) * mxa).sum(-1) + c
    grad = mxa - torch.einsum('bev,be->bv', J, f)
    return (w, blocks), cost, grad, mxa

  # start from the better of qacc_smooth / warmstart
  jar_a = mv(J, a) - aref
  jar_w = mv(J, warm) - aref
  w_a, cost_a, grad_a, mxa_a = eval_point(a, jar_a)
  w_w, cost_w, grad_w, mxa_w = eval_point(warm, jar_w)
  use_warm = (cost_w < cost_a)[:, None]
  x = torch.where(use_warm, warm, a)
  jar = torch.where(use_warm, jar_w, jar_a)
  w = _select(use_warm, w_w, w_a)
  grad = torch.where(use_warm, grad_w, grad_a)
  mxa = torch.where(use_warm, mxa_w, mxa_a)
  cost = torch.minimum(cost_w, cost_a)
  done = ~(scale * torch.linalg.vector_norm(grad, dim=-1) >= tol)
  iters = torch.zeros(B, dtype=torch.int32, device=J.device)

  it = 0
  while it < niter and not bool(done.all()):
    wd, blocks = w
    h = M + torch.einsum('bev,be,beu->bvu', J, wd, J) + eye_reg
    for rows, W in blocks:
      Jc = J[:, rows]                             # (B, ncg, k, nv)
      h = h + torch.einsum('bcjv,bcjk,bckw->bvw', Jc, W, Jc)
    delta = -chol_solve(h, grad)
    djar = mv(J, delta)
    dmd = (delta * mv(M, delta)).sum(-1)
    gma = (delta * mxa).sum(-1)

    alpha = torch.ones_like(dmd)
    lo = torch.zeros_like(dmd)
    hi = torch.full_like(dmd, 4.0)
    for _ in range(ls_iter):
      f_a, w_a, _, blocks_a = terms(jar + alpha[:, None] * djar)
      dp = gma + alpha * dmd - (f_a * djar).sum(-1)
      ddp = dmd + (w_a * djar * djar).sum(-1)
      for rows, W in blocks_a:
        dj = djar[:, rows]                        # (B, ncg, k)
        ddp = ddp + torch.einsum('bcj,bcjk,bck->b', dj, W, dj)
      lo = torch.where(dp < 0, torch.maximum(lo, alpha), lo)
      hi = torch.where(dp > 0, torch.minimum(hi, alpha), hi)
      alpha_n = alpha - dp / torch.clamp(ddp, min=1e-14)
      inside = (alpha_n > lo) & (alpha_n < hi)
      if J.dtype == torch.float64:
        # a Newton step that leaves alpha where it is stays, where the
        # JAX package bisects: at the minimizer, where rounding has just
        # made alpha the bracket's end, the search then leaves it and the
        # solve can stop far from its optimum without improving.  float32
        # keeps the JAX package's rule, as K2's kernel does.
        inside = inside | (alpha_n == alpha)
      alpha = torch.where(inside, alpha_n, 0.5 * (lo + hi))

    x_new = x + alpha[:, None] * delta
    jar_new = jar + alpha[:, None] * djar
    w_n, cost_n, grad_n, mxa_n = eval_point(x_new, jar_new)
    improved = (cost_n < cost) & ~done
    sel = improved[:, None]
    x = torch.where(sel, x_new, x)
    jar = torch.where(sel, jar_new, jar)
    w = _select(sel, w_n, w)
    grad = torch.where(sel, grad_n, grad)
    mxa = torch.where(sel, mxa_n, mxa)
    new_cost = torch.where(improved, cost_n, cost)
    improvement = scale * (cost - new_cost)
    cost = new_cost
    gradient = scale * torch.linalg.vector_norm(grad, dim=-1)
    keep = (improvement >= tol) & (gradient >= tol)
    iters += (~done).to(torch.int32)
    done = done | ~keep
    it += 1

  # exact final forces (outputs are a pure function of x)
  f, _, _, _ = terms(mv(J, x) - aref)
  return (x, f) + ((iters,) if return_iters else ()) + (
      (it,) if return_loops else ())


def _no_gradient(name, *tensors) -> None:
  """Raise where autograd would record the solve: neither the kernel nor
  the torch core has a derivative rule, as the JAX package's
  `pallas_call` has no JVP."""
  if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
    raise NotImplementedError(
        f'{name}: the Newton solve has no gradient; call it under '
        'torch.no_grad() or on inputs that do not require grad')


def newton_solve_core(J, M, aref, d_, fl, active, a, warm, *, lay,
                      niter: int, ls_iter: int, tol: float,
                      meaninertia: float, return_iters: bool = False):
  """The Newton solve of layouts past MAX_NV: the counterpart of the JAX
  package's `_solve_core_xla`, which that package runs for them on the
  TPU (solver.py:262-333), with its Newton step's factor-and-solve the K1b
  wrapper `linalg_kernel.chol_solve_batched`, as its `linalg.solve_psd`
  dispatches to the Pallas K1b there.  On the card that launches K1b once
  per iteration of the batch's loop (float32, nv <= linalg_kernel.MAX_N;
  it raises otherwise); on the CPU it takes the plain twin.  Adds one
  call and the loop's iterations to CORE_LOOPS, from which the K1b
  launches follow exactly.  Arguments and results as
  `newton_solve_batched`'s.  Raises NotImplementedError where an input
  requires grad.
  """
  _no_gradient('newton_solve_core', J, M, aref, d_, fl, active, a, warm)
  out = newton_solve_plain(
      J, M, aref, d_, fl, active, a, warm, types=lay.types,
      ell_groups=lay.ell_groups, niter=niter, ls_iter=ls_iter, tol=tol,
      meaninertia=meaninertia, return_iters=return_iters,
      chol_solve=linalg_kernel.chol_solve_batched, return_loops=True)
  CORE_LOOPS['calls'] += 1
  CORE_LOOPS['loops'] += out[-1]
  return out[:-1]


# ---------------------------------------------------------------------------
# Kernel wrapper.
# ---------------------------------------------------------------------------


def launch_config(nefc: int, nv: int, ncg: int,
                  cmax: int = 3) -> tuple[int, int]:
  """(warps per block, dynamic shared bytes) of the kernel for a layout.

  Mirrors the kernel's shared-memory carve (`block_words`, `warp_words`
  in csrc/newton_kernel.cu, which checks the bytes again): per block the
  row types and scales and the contact table (cmax rows, mu and, where
  cmax > 3, the row count per contact); per warp J (only where nv <=
  LANE_NV; past it J stays in device memory), M and H with rows padded
  to an odd stride, seven row vectors and the live-row list, the contact
  blocks (cmax^2 each), flags and live-contact list, and four dof
  vectors, all 4-byte words.  Takes MAX_WARPS environments per block,
  fewer where they do not fit, and raises where one does not.
  """
  if cmax not in CONE_WIDTHS:
    raise ValueError(f'cmax={cmax}: the kernel takes {CONE_WIDTHS}')
  ld = nv | 1
  block = 2 * nefc + (cmax + 1) * ncg + (ncg if cmax > 3 else 0)
  warp = ((nefc * ld if nv <= LANE_NV else 0) + 2 * nv * ld + 8 * nefc
          + (cmax * cmax + 2) * ncg + 4 * nv)
  fit = (SMEM_LIMIT // 4 - block) // warp
  if fit < 1:
    raise ValueError(
        f'newton kernel: one environment (nefc={nefc}, nv={nv}, ncg={ncg}, '
        f'cmax={cmax}) '
        f'needs {4 * (block + warp)} bytes of shared memory, over the '
        f'{SMEM_LIMIT} a block has')
  warps = min(MAX_WARPS, fit)
  return warps, 4 * (block + warps * warp)


def _types_on(lay: efc.Layout, device) -> torch.Tensor:
  key = ('types_i32', str(device))
  t = lay._cache.get(key)
  if t is None:
    t = torch.as_tensor(lay.types, dtype=torch.int32, device=device)
    lay._cache[key] = t
  return t


def cone_width(lay: efc.Layout) -> int:
  """The kernel's C for a layout: 3, or 6 where an elliptic contact has
  more than 3 rows."""
  return 3 if max(lay.ell_groups, default=3) <= 3 else 6


def cone_tables(lay: efc.Layout):
  """K2-ell's per-layout tables in numpy: the elliptic contacts of every
  condim flattened in condim order (the TPU kernel's `_Static`), each
  contact's rows (ncg, C) int32 (normal row first, padded past its own
  row count with its normal row), its row count (ncg,) int32, mu (ncg,)
  and the (nefc,) row scales (1 outside elliptic rows), float32."""
  C = cone_width(lay)
  rows_c, k_c, mu_c = [], [], []
  s_row = np.ones(lay.nefc, np.float32)
  for k, (rows, mu, scale) in sorted(lay.ell_groups.items()):
    padded = np.repeat(rows[:, :1], C, axis=1)
    padded[:, :k] = rows
    rows_c.append(padded)
    k_c.append(np.full(len(rows), k))
    mu_c.append(mu)
    s_row[rows] = scale
  cat = lambda x, shape: np.concatenate(x) if x else np.zeros(shape)
  return (cat(rows_c, (0, C)).astype(np.int32), cat(k_c, 0).astype(np.int32),
          cat(mu_c, 0).astype(np.float32), s_row)


def _cones_on(lay: efc.Layout, device):
  """`cone_tables` as tensors on `device`."""
  key = ('cones', str(device))
  t = lay._cache.get(key)
  if t is None:
    t = tuple(torch.as_tensor(x, device=device) for x in cone_tables(lay))
    lay._cache[key] = t
  return t


def newton_solve_batched(J, M, aref, d_, fl, active, a, warm, *, lay,
                         niter: int, ls_iter: int, tol: float,
                         meaninertia: float, return_iters: bool = False):
  """Batched Newton solve: the CUDA kernel on CUDA tensors.

  Args (batch-first): J (B, nefc, nv), M (B, nv, nv), aref/d_/fl/active
  (B, nefc) with active as 0/1 floats, a/warm (B, nv); lay: the model's
  efc.Layout.  Returns qacc (B, nv), force (B, nefc) and, if asked, the
  per-lane iteration count (B,).  Raises NotImplementedError where an
  input requires grad, on any device.
  """
  _no_gradient('newton_solve_batched', J, M, aref, d_, fl, active, a, warm)
  kw = dict(niter=niter, ls_iter=ls_iter, tol=tol, meaninertia=meaninertia,
            return_iters=return_iters)
  if J.device.type == 'cpu':
    return newton_solve_plain(J, M, aref, d_, fl, active, a, warm,
                              types=lay.types, ell_groups=lay.ell_groups,
                              **kw)
  if J.device.type != 'cuda':
    raise ValueError(f'newton_solve_batched: tensors on {J.device}')
  if J.dim() != 3:
    raise ValueError(f'J must be (B, nefc, nv), got {tuple(J.shape)}')
  B, nefc, nv = J.shape
  if not 1 <= nv <= MAX_NV:
    raise ValueError(f'nv={nv} outside the kernel limit 1..{MAX_NV}')
  if nefc != lay.nefc or nefc < 1:
    raise ValueError(f'nefc={nefc} does not match the layout ({lay.nefc})')
  if not 1 <= B < 2 ** 31 or niter < 1 or ls_iter < 0:
    raise ValueError('batch, niter or ls_iter outside the kernel limits')
  shapes = {'M': (M, (B, nv, nv)), 'aref': (aref, (B, nefc)),
            'D': (d_, (B, nefc)), 'frictionloss': (fl, (B, nefc)),
            'active': (active, (B, nefc)), 'a': (a, (B, nv)),
            'warm': (warm, (B, nv)), 'J': (J, (B, nefc, nv))}
  for name, (t, shape) in shapes.items():
    if t.device != J.device or t.dtype != torch.float32:
      raise TypeError(f'{name}: kernel takes float32 on {J.device}, got '
                      f'{t.dtype} on {t.device}')
    if tuple(t.shape) != shape:
      raise ValueError(f'{name}: shape {tuple(t.shape)} != {shape}')

  cones = _cones_on(lay, J.device) if lay.ell_groups else None
  ncg = cones[0].shape[0] if cones else 0
  cmax = cone_width(lay)
  warps, smem = launch_config(nefc, nv, ncg, cmax)
  # batch-first as the port holds them: no transposing copy
  ins = [t.contiguous() for t in (J, M, aref, d_, fl, active, a, warm)]
  x = torch.empty((B, nv), dtype=torch.float32, device=J.device)
  f = torch.empty((B, nefc), dtype=torch.float32, device=J.device)
  iters = torch.empty((B,), dtype=torch.int32, device=J.device)
  scale = 1.0 / (max(meaninertia, 1e-12) * max(nv, 1))
  ptrs = [t.data_ptr() for t in cones] if cones else [None] * 4
  lib = build.library()
  err = lib.dmc_newton_solve(
      *[t.data_ptr() for t in ins], _types_on(lay, J.device).data_ptr(),
      *ptrs, x.data_ptr(), f.data_ptr(), iters.data_ptr(), nefc, nv, ncg,
      cmax, B, int(niter), int(ls_iter), float(tol), float(scale), warps,
      smem, torch.cuda.current_stream().cuda_stream)
  build.check(err, 'dmc_newton_solve')
  LAUNCHES['newton_solve_ell' if ncg else 'newton_solve_batched'] += 1
  if return_iters:
    return x, f, iters
  return x, f
