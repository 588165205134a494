#!/usr/bin/env python3
"""End-to-end proof that the PyTorch/CUDA port runs on one NVIDIA H100.

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit:

    python3 chip_smoke.py

It drives only the port (`dm_control_tpu_torch`), never JAX, in phases;
any failure exits non-zero and no phase catches its own failure:

  1. build: compiles every kernel under dm_control_tpu_torch/csrc/ with
     nvcc for sm_90a (one nvcc per source, all started together);
  2. kernels: holds each kernel against its plain PyTorch version on the
     card at float32: K1a/b/c (batched Cholesky factor, fused solve,
     substitution) at finger's (4096, 3, 3), walker's (4096, 9, 9) and at
     n = 27, 56, 96 (MAX_N), bound 1e-4 scaled by max(1, |ref|); for each
     also the launch configuration (lanes per environment), the first
     4093 lanes alone and a second launch giving the full batch's bits,
     K1c on K1a's L giving K1b's bits, K1a's L contiguous, exactly 0 above
     the diagonal and unchanged when A's upper triangle is NaN, and K1c's
     x unchanged when L's is; K2 (Newton solve) on walker's solver inputs
     at batch 4096 made by the port, against the plain float32 solve and
     the plain float64 optimum: mean <= 1e-4, max <= 5e-2 and <= 10% of
     lanes above 1e-3 (tests/test_pallas.py), each error scaled by
     max(1, the lane's largest |ref|);
     K2-ell (the Newton solve's elliptic-cone branch) on finger-spin
     solver inputs at batch 4096 rich in contacts (joint angles drawn by
     the port's randomizer, kept where they touch, random velocities so
     that contacts slide), with the same bounds against plain float32
     and float64, converged and after one Newton iteration (which
     depends on the Hessian's and the line search's cone terms); for
     both, the launch configuration (one warp per environment), and the
     first 4093 lanes alone (no multiple of the warps per block) and a
     second launch must give the full batch's bits;
  3. reference: one control step of REF_LANES = 256 walker-walk lanes,
     and of 256 finger-spin lanes in contact, on the card at float32
     against the port's float64 CPU path (plain versions) from the same
     state, every run recording its discrete choices at every substep
     (contact activity and normals, limit activity, the solve's warmstart
     choice and its rows' and cones' zones): each lane within REF_TOL =
     1e-2 (max scaled error of qpos and qvel) is held; one over it is
     excused where its first differing choice stood within BAND * EPS32 *
     scale of its threshold in the float64 run, and fails otherwise (a
     lane whose choices all matched is held to REF_TOL unchanged); the
     kernels' run may excuse at most twice the lanes that the same step
     with K1 as plain PyTorch excuses, plus one;
  4. rollout: BatchedEnv(walker-walk, batch_size=4096) on the card, three
     runs of reset and 50 control steps (500 physics substeps) through
     `rollout_fn`; then
     BatchedEnv(finger-spin, 4096), three runs of reset and 50 control
     steps (100 substeps): every state finite, rewards in [0, 1], each
     kernel's launch count exactly its expected count per control step;
     then finger-spin with an episode limit of 3 control steps, which
     sends every lane through the reset pool;
  5. timing: each kernel and its plain version with CUDA events at the
     main path's shapes, and, for K1, the one torch.linalg call that
     computes the same function (`library_ms`, never used by the port);
     the Newton rows carry the largest iteration count of their inputs
     (`max_iters`), which sets a launch's time.  K1 rows are at walker's
     (4096, 9, 9) with finger's (4096, 3, 3) beside them (`finger`), and
     add `kernel_ms` (CUDA events around 50 back-to-back launches of the
     ctypes entry on pre-made buffers, no wrapper work between them),
     `device_ms` and `kernels_per_call` (the CUDA kernels of one wrapper
     call and their device time, torch.profiler; each must launch exactly
     one), and the launch configuration; then walker's K1 time per
     control step, 11 K1a + 10 K1b + 10 K1c.

Output: the card's name and power limit (nvidia-smi), env-steps/s of
walker-walk@4096 and finger-spin@4096 (each the median of three runs), one
`{"kernels": [...]}` JSON line, and last the
`{"ok": true, "device": {...}}` line.  The nvcc/ptxas log of the build
is in dm_control_tpu_torch/_build/build.log; its register and spill lines
are printed.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time

BATCH = 4096
CONTROL_STEPS = 50
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s
# outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# expected launches per walker control step (n_sub = 10): step1 runs 9x in
# the substep loop, 1x as the sync and 1x at the end of step(); the acc
# stage and euler run 9x in the loop and 1x in step()
PER_STEP = {'cholesky_batched': 11, 'cho_solve_batched': 10,
            'chol_solve_batched': 10, 'newton_solve_batched': 10,
            'newton_solve_ell': 0}
# launches of one forward() (an auto-reset of done lanes)
PER_RESET = {'cholesky_batched': 1, 'cho_solve_batched': 1,
             'chol_solve_batched': 0, 'newton_solve_batched': 1,
             'newton_solve_ell': 0}
# expected launches per finger-spin control step (n_sub = 2): step1 runs
# 1x in the substep loop, 1x as the sync and 1x at the end of step(); the
# acc stage (solve_m, then the solve, which is K2-ell: finger's contacts
# are elliptic) and euler (damped joints: K1b) run 1x in the loop and 1x
# in step().  Its auto-resets come from the reset pool: no launches.
FINGER_PER_STEP = {'cholesky_batched': 3, 'cho_solve_batched': 2,
                   'chol_solve_batched': 2, 'newton_solve_batched': 0,
                   'newton_solve_ell': 2}
FINGER_RUNS = 3
WALKER_RUNS = 3
REPLACES = {
    'cholesky_batched': 'dm_control_tpu/ops/linalg_kernel.py:118',
    'chol_solve_batched': 'dm_control_tpu/ops/linalg_kernel.py:142',
    'cho_solve_batched': 'dm_control_tpu/ops/linalg_kernel.py:166',
    'newton_solve_batched': 'dm_control_tpu/ops/newton_kernel.py:491',
    'newton_solve_ell': 'dm_control_tpu/ops/newton_kernel.py:207',
}
SOURCES = {
    'cholesky_batched': 'dm_control_tpu_torch/csrc/linalg_kernel.cu',
    'chol_solve_batched': 'dm_control_tpu_torch/csrc/linalg_kernel.cu',
    'cho_solve_batched': 'dm_control_tpu_torch/csrc/linalg_kernel.cu',
    'newton_solve_batched': 'dm_control_tpu_torch/csrc/newton_kernel.cu',
    'newton_solve_ell': 'dm_control_tpu_torch/csrc/newton_kernel.cu',
}
# K2's bounds (tests/test_pallas.py) on the lane-scaled error
K2_MEAN, K2_MAX, K2_LANES = 1e-4, 5e-2, 0.1


def log(msg):
  print(msg, flush=True)


def scaled_err(x, ref):
  return (x - ref).abs() / ref.abs().clamp(min=1.0)


def lane_scaled_err(x, ref):
  """|x - ref| over max(1, the lane's largest |ref|), for (B, n) solves.

  A float32 solve is accurate relative to the size of its lane's vector,
  not of each component: where a lane's qacc reaches ~1e3, a component
  near 1 carries ~1e3 * 6e-8 * cond of rounding whatever the solver."""
  return (x - ref).abs() / ref.abs().amax(dim=1, keepdim=True).clamp(min=1.0)


def cuda_ms(fn, reps):
  """Mean device time of fn() over reps launches (CUDA events)."""
  import torch
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def device_kernels(fn, reps):
  """(CUDA kernels per call, their device ms per call) of fn() over reps
  calls under torch.profiler."""
  import torch
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for _ in range(reps):
      fn()
    torch.cuda.synchronize()
  kernels = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
  return (len(kernels) / reps,
          sum(e.device_time for e in kernels) / reps / 1e3)


def bound_ms(nbytes, flops):
  t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32
  return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else 'operations'


def newton_flops(nefc, nv, ls_iter, iters, cones=None):
  """FLOPs the Newton solve needs for these lanes' iteration counts: the
  warmstart choice and final forces (3 J products and 2 row sweeps), then
  per iteration the H = M + J'WJ build, the Cholesky and substitutions,
  J delta, the line search sweeps, the new cost and the gradient.

  `cones` (B,), each lane's active elliptic contacts, adds K2-ell's work
  on them: ~60 FLOPs to evaluate one contact's zone, force, cost and 3x3
  block, done 3x at the start and end and (ls_iter + 3)x per iteration
  (gradient, Hessian, line search, new cost); per iteration also its
  J_c' W_c J_c (9 nv + 3 nv (nv + 1) multiply-adds), its J' f (6 nv) and
  its line-search phi'/phi'' terms (24 per step)."""
  start = 3 * 2 * nefc * nv + 2 * nv * nv + 2 * 8 * nefc
  per_iter = (nefc * nv * (nv + 1) + nv ** 3 / 3 + 2 * nv * nv
              + 2 * nefc * nv + 2 * nv * nv + ls_iter * 10 * nefc
              + 2 * nv * nv + 8 * nefc + 2 * nv * nv + 2 * nefc * nv)
  total = len(iters) * start + iters.double().sum().item() * per_iter
  if cones is not None:
    cone_iter = (60 * (ls_iter + 3) + 18 * nv + 6 * nv * (nv + 1)
                 + 6 * nv + 24 * ls_iter)
    total += (cones.double() * (3 * 60 + iters.double() * cone_iter)
              ).sum().item()
  return float(total)


def k2_check(what, x, ref, gate, bounds=None):
  """Print the lane-scaled error of x against ref, and the
  component-scaled one for the record; with `gate`, assert the K2 bounds
  (or `bounds`, (mean, max, lanes)) on the lane-scaled one.  Returns the
  lane-scaled (mean, max, lanes above 1e-3)."""
  B = x.shape[0]
  stats = {}
  for how, err in (('lane-scaled', lane_scaled_err(x, ref)),
                   ('component-scaled', scaled_err(x, ref))):
    mean, mx = err.mean().item(), err.max().item()
    lanes_bad = int((err.max(dim=1).values > 1e-3).sum())
    stats[how] = (mean, mx, lanes_bad)
    log(f'#   {what}, {how}: mean {mean:.2e} max {mx:.2e} '
        f'lanes>1e-3 {lanes_bad}')
  if gate:
    b_mean, b_max, b_lanes = bounds or (K2_MEAN, K2_MAX, int(K2_LANES * B))
    mean, mx, lanes_bad = stats['lane-scaled']
    assert mean <= b_mean, f'{what}: mean {mean:.2e} > {b_mean:.2e}'
    assert mx <= b_max, f'{what}: max {mx:.2e} > {b_max:.2e}'
    assert lanes_bad <= b_lanes, f'{what}: {lanes_bad} lanes > {b_lanes}'
  return stats['lane-scaled']


def ell_gates(what, x_k, x_p, x_64):
  """K2's bounds on the kernel's x_k against the plain float32 solve x_p
  and the plain float64 one x_64.  Where plain float32 itself misses a
  bound against float64, the kernel is held to no more than 2x plain
  float32's own error on that statistic."""
  k2_check(f'{what} kernel vs plain float32', x_k, x_p, gate=True)
  p32 = k2_check(f'{what} plain float32 vs plain float64', x_p.double(),
                 x_64, gate=False)
  limits = (K2_MEAN, K2_MAX, int(K2_LANES * x_k.shape[0]))
  bounds = tuple(lim if p <= lim else 2 * p for p, lim in zip(p32, limits))
  if bounds != limits:
    log(f'#   plain float32 misses a K2 bound against float64: the kernel '
        f'is held to (mean, max, lanes) <= {bounds}')
  k2_check(f'{what} kernel vs plain float64', x_k.double(), x_64,
           gate=True, bounds=bounds)


def newton_launch(nk, what, lay, nv, B):
  """Print the Newton kernel's launch configuration for a layout."""
  ncg = len(lay.ell_groups[3][0]) if lay.ell_groups else 0
  warps, smem = nk.launch_config(lay.nefc, nv, ncg)
  log(f'# phase kernels: {what} launch: {warps} warps (one environment '
      f'each) per block, {smem} bytes of dynamic shared memory, '
      f'{-(-B // warps)} blocks of {32 * warps} threads')


def newton_bits(nk, what, args, lay, kw, full):
  """The first B - 3 lanes alone (no multiple of the warps per block)
  and a second launch of the whole batch must give `full`'s bits (x,
  forces, iterations): one warp per environment, sums in a fixed order."""
  import torch
  n = args[0].shape[0] - 3
  again = nk.newton_solve_batched(*args, lay=lay, return_iters=True, **kw)
  part = nk.newton_solve_batched(*[a[:n] for a in args], lay=lay,
                                 return_iters=True, **kw)
  for name, x, y, z in zip(('qacc', 'forces', 'iterations'), full, again,
                           part):
    assert torch.equal(x, y), f'{what}: two launches differ in {name}'
    assert torch.equal(x[:n], z), f'{what}: {n} lanes alone differ in {name}'
  log(f'# phase kernels: {what}: the first {n} lanes alone and a second '
      f'launch give the full batch\'s bits (qacc, forces, iterations)')


def k1_bits(lk, A, b, L, x, xc):
  """The K1 kernel's launch configuration, printed; for K1a, K1b and K1c
  (on K1a's L: `xc`) the first B - 3 lanes alone and a second launch must
  give the full batch's bits (each environment's result depends on its own
  inputs alone); K1c on K1a's L must give K1b's bits (the same factor, the
  same substitution); K1a's L must be exactly 0 above the diagonal and
  unchanged when A's upper triangle is NaN, and K1c's x unchanged when L's
  is (only lower triangles are read)."""
  import torch
  B, n, _ = A.shape
  envs, threads, smem = lk.launch_config(n)
  log(f'# phase kernels: K1 (cholesky_batched, chol_solve_batched, '
      f'cho_solve_batched) n={n} launch: {threads // envs} lanes per '
      f'environment, {envs} environments per block of {threads} threads, '
      f'{smem} bytes of dynamic shared memory, {-(-B // envs)} blocks')
  m = B - 3
  for what, x_full, fn, mat in (
      ('cholesky_batched', L, lambda a, v: lk.cholesky_batched(a), A),
      ('chol_solve_batched', x, lk.chol_solve_batched, A),
      ('cho_solve_batched', xc, lk.cho_solve_batched, L)):
    assert torch.equal(fn(mat, b), x_full), f'{what} n={n}: two launches differ'
    assert torch.equal(fn(mat[:m], b[:m]), x_full[:m]), (
        f'{what} n={n}: {m} lanes alone differ')
  assert torch.equal(xc, x), f'K1c n={n}: on K1a\'s L it is not K1b'
  assert L.is_contiguous(), f'K1a n={n}: L is not contiguous'
  assert bool((torch.triu(L, 1) == 0).all()), f'K1a n={n}: L above diagonal'
  upper = torch.ones(n, n, dtype=torch.bool, device=A.device).triu(1)
  assert torch.equal(lk.cholesky_batched(A.masked_fill(upper, float('nan'))),
                     L), f'K1a n={n}: L depends on the upper triangle'
  assert torch.equal(lk.cho_solve_batched(L.masked_fill(upper, float('nan')),
                                          b), xc), (
      f'K1c n={n}: x depends on the upper triangle of L')
  log(f'# phase kernels: K1 n={n}: cho_solve_batched(cholesky_batched(A), b)'
      f' gives chol_solve_batched(A, b)\'s bits; for each, the first {m} '
      f'lanes alone and a second launch give the full batch\'s bits; L is '
      f'contiguous, 0 above the diagonal, and no upper entry of A or L is '
      f'read')


@contextlib.contextmanager
def recording(record):
  """Inside, every physics step's acc stage of the port (its contacts,
  constraint rows, warmstart and solve) calls record(before, after) with
  the Data going into and out of it; the step itself is unchanged."""
  from dm_control_tpu_torch._src import forward
  acc = forward._acc_stage

  def probed(m, d, skipsensor=False):
    out = acc(m, d, skipsensor=skipsensor)
    record(d, out)
    return out

  forward._acc_stage = probed
  try:
    yield
  finally:
    forward._acc_stage = acc


def one_step(m, data, lanes, ctrl, n_sub, dtype, dev, record=False):
  """qpos and qvel after one control step (n_sub substeps) of `data`'s
  `lanes` under `ctrl`, run by the port's model m at dtype on dev; with
  `record`, also the discrete choices of every substep (`branches`, on the
  CPU) under 'branches'."""
  from dm_control_tpu_torch._src import efc
  from dm_control_tpu_torch._src import forward
  small = {f: x[lanes].to(dev, dtype) if x.is_floating_point()
           else x[lanes].to(dev) for f, x in forward.state_of(data).items()}
  d = forward.make_data(m, ctrl.shape[0], dtype, dev).replace(**small)
  seen = []
  lay = efc.layout(m)
  keep = lambda before, after: seen.append(
      {q: tuple(t.cpu() for t in v)
       for q, v in branches(m, lay, before, after).items()})
  with recording(keep) if record else contextlib.nullcontext():
    d = forward.substeps(m, d.replace(ctrl=ctrl.to(dev, dtype)), n_sub)
  out = {'qpos': d.qpos, 'qvel': d.qvel}
  if record:
    out['branches'] = seen
  return out


# -- the reference-step gate ---------------------------------------------------
# One control step on the card at float32 is held against the float64 CPU
# path lane by lane.  A lane on which every discrete choice of every
# substep (`branches`) came out as in the float64 run is held to REF_TOL.
# A lane whose choices differ may be further off: it took another branch
# of the physics.  It is excused where, at its first differing substep,
# the first quantity that differs (in pipeline order) stood within BAND *
# EPS32 * scale of its threshold in the float64 run on every differing
# element: a choice that float32 rounding flips.  Any other lane over
# REF_TOL fails; the excused lanes are counted against the same step run
# with K1 as plain PyTorch (`gate_failures`).  PERF.md derives BAND and
# shows what flips.
REF_TOL = 1e-2
EPS32 = 2.0 ** -23          # float32 spacing at 1 (torch.finfo().eps)
BAND = 64
REF_LANES = 256             # lanes of each task the gate holds
REF_SEED = 2                # the reference generator's seed
# pipeline order: collision, limits, then the solve's warmstart choice and
# the zones of its rows and cones at the solution
QUANTITIES = ('contact', 'contact core', 'contact normal', 'limit',
              'warmstart', 'row zone', 'cone top', 'cone bottom')
# two runs' normals of one contact differ where they are further apart
NORMAL_ANGLE = 0.1
# the separation below which math.normalize clamps (its eps): a pair whose
# cores cross takes its normal and contact point from rounding there
CORE_EPS = 1e-12


def branches(m, lay, before, after):
  """The discrete choices one physics step's acc stage made, lane by lane.

  `before` / `after`: the Data going into / out of the acc stage.  For each
  quantity of QUANTITIES the model has: (state (B, k), value (B, k),
  scale (B, k)), state being the predicate the pipeline applies to value
  (< 0 or <= 0; for normals the direction itself), computed at the run's
  dtype, and scale the size of the terms value is computed from, so that
  value's rounding is ~ eps * scale:
    contact    dist - margin < 0 per candidate contact (constraint.py);
               scale max(1, |contact position|)
    contact core  the separation of the two geoms' cores, dist + their
               radii, < CORE_EPS: where math.normalize clamps it, the pair's
               normal and contact point are rounding's; same scale
    contact normal  the normal of each active contact, a direction (two
               runs' differ past NORMAL_ANGLE): decided by the separation
               of the cores, same scale
    limit      dist - margin < 0 per joint limit; scale max(1, |dist| +
               |range|)
    warmstart  cost(warm) - cost(qacc_smooth) < 0 (the solve's start);
               scale the costs' first-order rounding: their quadratic
               terms, and each row's |force| times its jar's scale
    row zone   at the solution x, active one-sided rows jar < 0, friction-
               loss rows D |jar| - fl <= 0 (newton_kernel._diag_terms); jar
               = J x - aref, scale sum |J| |x| + |aref| plus |J| times x's
               own rounding scale through the solve (times D, plus fl)
    cone top / cone bottom: active elliptic contacts, mu t - n <= 0 and
               mu n + t <= 0 (newton_kernel._ell_terms), on the scaled
               residuals; scale the same sums for n and t
  """
  import numpy as np
  import torch
  from dm_control_tpu_torch._src import efc
  from dm_control_tpu_torch._src.types import DisableBit
  from dm_control_tpu_torch.ops import newton_kernel as nk
  d = after
  out = {}
  if lay.contact is not None and lay.contact.ncon:
    con = d.contact
    v = con.dist - con.includemargin
    scale = con.pos.abs().amax(-1).clamp(min=1.0)
    out['contact'] = (v < 0, v, scale)
    radius = torch.as_tensor(m.geom_size[:, 0], dtype=v.dtype,
                             device=v.device)
    radius = torch.where(torch.as_tensor(m.geom_type == 0, device=v.device),
                         0.0, radius)                      # planes
    sep = con.dist + radius[con.geom1.long()] + radius[con.geom2.long()]
    out['contact core'] = (sep < CORE_EPS, sep - CORE_EPS, scale)
    normal = torch.where((v < 0)[..., None], con.frame[..., 0, :],
                         float('nan'))
    out['contact normal'] = (normal, sep, scale)
  lo = len(lay.fric_dof)
  hi = lo + len(lay.lim_jnt)
  if hi > lo:
    pos = d.efc_pos[:, lo:hi]
    v = pos - d.efc_margin[:, lo:hi]
    rng = torch.as_tensor(np.abs(m.jnt_range[lay.lim_jnt]).max(-1),
                          dtype=v.dtype, device=v.device)
    out['limit'] = (v < 0, v, (pos.abs() + rng).clamp(min=1.0))
  if lay.nefc == 0:
    return out
  J, aref, D, fl = d.efc_J, d.efc_aref, d.efc_D, d.efc_frictionloss
  on = d.efc_active
  act = on.to(J.dtype)
  types = torch.as_tensor(lay.types, device=J.device)
  is_eq, is_fr = types == efc.EQUALITY, types == efc.FRICTION
  is_one = types == efc.ONESIDED
  groups = nk._ell_groups(lay.ell_groups, J.device, J.dtype)
  mv = lambda A, x: torch.einsum('buv,bv->bu', A, x)

  def jar_scale(x):
    return torch.einsum('buv,bv->bu', J.abs(), x.abs()) + aref.abs()

  def cost(x):
    """The solve's cost at x, and its first-order rounding scale: the
    quadratic's terms, and each row's |force| times its jar's scale."""
    jar = mv(J, x) - aref
    f, _, c = nk._diag_terms(jar, D, fl, act, is_eq, is_fr, is_one)
    if groups:
      f_e, c_e, _ = nk._ell_terms(jar, D, act, groups)
      f, c = f + f_e, c + c_e
    xa = x - d.qacc_smooth
    quad = 0.5 * (xa * mv(d.qM, xa)).sum(-1)
    scale = (xa.abs() * mv(d.qM.abs(), xa.abs())).sum(-1)
    return quad + c, scale + (f.abs() * jar_scale(x)).sum(-1)

  warm = (d.qacc_smooth if m.opt.disableflags & DisableBit.WARMSTART
          else before.qacc_warmstart)
  (c_warm, s_warm), (c_smooth, s_smooth) = cost(warm), cost(d.qacc_smooth)
  out['warmstart'] = ((c_warm < c_smooth)[:, None],
                      (c_warm - c_smooth)[:, None],
                      (s_warm + s_smooth)[:, None])
  # the zones at the solution x: their values come through the solve, so
  # their scale adds x's first-order rounding, |H^-1| times the gradient's
  # terms' sizes |M| (|x| + |a|) + |J'| |f| (H the solve's Hessian at x)
  x = d.qacc
  jar = mv(J, x) - aref
  f, w, _ = nk._diag_terms(jar, D, fl, act, is_eq, is_fr, is_one)
  h = d.qM + torch.einsum('bev,be,beu->bvu', J, w, J)
  if groups:
    f_e, _, blocks = nk._ell_terms(jar, D, act, groups)
    f = f + f_e
    for rows, W in blocks:
      h = h + torch.einsum('bcjv,bcjk,bckw->bvw', J[:, rows], W, J[:, rows])
  g_terms = (mv(d.qM.abs(), x.abs() + d.qacc_smooth.abs())
             + torch.einsum('bev,be->bv', J.abs(), f.abs()))
  x_res = mv(torch.linalg.inv(h).abs(), g_terms)
  jscale = jar_scale(x) + mv(J.abs(), x_res)
  inf = torch.full_like(jar, float('inf'))
  v_fr = D * jar.abs() - fl
  out['row zone'] = (
      on & ((is_one & (jar < 0)) | (is_fr & (v_fr <= 0))),
      torch.where(is_one, jar, torch.where(is_fr, v_fr, inf)),
      torch.where(is_one, jscale, torch.where(is_fr, D * jscale + fl, inf)))
  tops, bottoms = [], []
  for rows, mu, s in groups:
    y = jar[:, rows] * s
    ys = jscale[:, rows] * s.abs()
    n, t = y[..., 0], torch.sqrt(torch.clamp((y[..., 1:] ** 2).sum(-1),
                                             min=1e-30))
    scale = ys[..., 0] + mu * ys[..., 1:].norm(dim=-1)
    c_on = on[:, rows[:, 0]]
    v_top, v_bot = mu * t - n, mu * n + t
    tops.append((c_on & (v_top <= 0), v_top, scale))
    bottoms.append((c_on & (v_bot <= 0), v_bot, scale))
  for q, parts in (('cone top', tops), ('cone bottom', bottoms)):
    if parts:
      out[q] = tuple(torch.cat(x, dim=1) for x in zip(*parts))
  return out


def first_differences(test, ref):
  """For each lane, where the discrete choices of run `test` first differ
  from those of run `ref` (lists of `branches` per substep, the same
  lanes): None where they never do, else (substep, quantity, element,
  distance), distance being the largest |value| / (EPS32 * scale) of the
  reference run over that quantity's differing elements at that substep."""
  import torch
  B = next(iter(ref[0].values()))[0].shape[0]
  first = [None] * B
  for s, (bt, br) in enumerate(zip(test, ref)):
    for q in QUANTITIES:
      if q not in br:
        continue
      if bt[q][0].is_floating_point():     # directions
        cos = (bt[q][0] * br[q][0]).sum(-1)
        diff = cos < math.cos(NORMAL_ANGLE)
      else:
        diff = bt[q][0] != br[q][0]
      v, scale = br[q][1].double(), br[q][2].double()
      dist = torch.where(diff, v.abs() / (EPS32 * scale), 0.0).amax(dim=1)
      for lane in torch.nonzero(diff.any(dim=1)).flatten().tolist():
        if first[lane] is None:
          element = int(torch.nonzero(diff[lane])[0])
          first[lane] = (s, q, element, float(dist[lane]))
  return first


def lane_verdicts(err, first, band):
  """Each lane's verdict from its largest scaled error `err` (B,) and its
  `first_differences` entry:
    'held'     err <= REF_TOL;
    'excused'  over REF_TOL, its first differing choice within `band`
               (x EPS32 x scale) of its threshold in the reference run;
    'failed'   any other lane: over REF_TOL with every choice matched, or
               with the first differing one outside the band.
  """
  out = []
  for e, f in zip(err.tolist(), first):
    if e <= REF_TOL:
      out.append('held')
    elif f is not None and f[3] <= band:
      out.append('excused')
    else:
      out.append('failed')
  return out


def gate_failures(run, plain):
  """What fails the reference gate for the `lane_verdicts` of a float32
  run of the step, given those of another float32 run of it on the same
  lanes (K1 as plain PyTorch): any failed lane; more than twice the lanes
  the plain run excuses, plus one.  Returns the failures' descriptions
  (none: passed)."""
  out = []
  if 'failed' in run:
    out.append(f'{run.count("failed")} lanes failed')
  n, n_plain = run.count('excused'), plain.count('excused')
  if n > 2 * n_plain + 1:
    out.append(f'{n} lanes excused, the plain run {n_plain}')
  return out


def reference_controls(gen, ref_gen, nu, lanes, dev):
  """Controls of the reference step's `lanes` lanes, uniform in [-1, 1]:
  the first 64 from `gen` (the lanes the gate held before it held more),
  the rest from `ref_gen`, so that `gen` makes the same draws as then."""
  import torch
  first = torch.rand((64, nu), generator=gen, device=dev) * 2 - 1
  rest = torch.rand((lanes - 64, nu), generator=ref_gen, device=dev) * 2 - 1
  return torch.cat([first, rest])


# K1's wrappers and the plain versions `plain_k1` sends them to
K1_PLAIN = {'cholesky_batched': 'cholesky_plain',
            'chol_solve_batched': 'chol_solve_plain',
            'cho_solve_batched': 'cho_solve_plain'}


@contextlib.contextmanager
def plain_k1(lk):
  """Inside, K1's wrappers (module `lk`) run their plain versions on any
  device: the float32 card path with K1 as plain PyTorch."""
  saved = {k: getattr(lk, k) for k in K1_PLAIN}
  for k, plain in K1_PLAIN.items():
    setattr(lk, k, getattr(lk, plain))
  try:
    yield
  finally:
    for k, fn in saved.items():
      setattr(lk, k, fn)


def reference_gate(what, m, m_cpu, data, ctrl, n_sub, lk):
  """Phase reference for one task: one control step of the first
  ctrl.shape[0] lanes of `data` on the card at float32 (model m), through
  the K1 kernels and with K1 plain (`plain_k1`), each against the float64
  CPU path (m_cpu), every run recording its discrete choices (`branches`);
  each lane's verdict (`lane_verdicts`), and the kernels' run held to the
  plain run's (`gate_failures`).  Returns the kernels' run's largest
  errors {qpos, qvel}."""
  import torch
  lanes = slice(0, ctrl.shape[0])
  ref = one_step(m_cpu, data, lanes, ctrl, n_sub, torch.float64, 'cpu',
                 record=True)
  runs = {'kernels': one_step(m, data, lanes, ctrl, n_sub, torch.float32,
                              ctrl.device, record=True)}
  with plain_k1(lk):
    runs['plain'] = one_step(m, data, lanes, ctrl, n_sub, torch.float32,
                             ctrl.device, record=True)
  counts, largest, gated = {}, {}, {}
  for route, out in runs.items():
    errs = {f: scaled_err(out[f].cpu().double(), ref[f]).amax(dim=1)
            for f in ('qpos', 'qvel')}
    err = torch.maximum(errs['qpos'], errs['qvel'])
    first = first_differences(out['branches'], ref['branches'])
    verdicts = lane_verdicts(err, first, BAND)
    gated[route] = verdicts
    counts[route] = {v: verdicts.count(v)
                     for v in ('held', 'excused', 'failed')}
    matched = torch.tensor([f is None for f in first])
    largest[route] = {f: e.max().item() for f, e in errs.items()}
    log(f'# phase reference: {what}, K1 {route}, {len(first)} lanes, float32 '
        f'card vs float64 CPU: max scaled err qpos {largest[route]["qpos"]:.2e}'
        f' qvel {largest[route]["qvel"]:.2e}; lanes whose choices all '
        f'matched {int(matched.sum())}, their largest error '
        f'{err[matched].max().item() if matched.any() else 0:.2e}; '
        f'{counts[route]}')
    for lane in torch.nonzero(err > REF_TOL).flatten().tolist():
      f = first[lane]
      where = ('every choice matched' if f is None else
               f'first differing choice at substep {f[0]}: {f[1]} element '
               f'{f[2]}, float64 value {f[3]:.3g} x EPS32 x scale from its '
               f'threshold')
      log(f'#   {what}, K1 {route}: lane {lane} error {err[lane].item():.2e}'
          f' {verdicts[lane]}: {where}')
  failures = gate_failures(gated['kernels'], gated['plain'])
  assert not failures, f'{what} reference gate: {"; ".join(failures)}'
  return largest['kernels']


def finger_solver_inputs(m, lay, B, gen, dev):
  """finger-spin solver inputs for B lanes in contact, float32 on dev.

  Joint angles are drawn by the port's randomizer and kept where
  `has_contacts` is true (~9% of draws); the joint velocities are
  N(0, 2^2) so that contacts slide, the controls uniform.  The pipeline
  then runs up to the solve.  Returns (solver args, the forward Data)."""
  import torch
  from dm_control_tpu_torch._src import forward
  from dm_control_tpu_torch.suite import base
  kept = []
  while sum(len(q) for q in kept) < B:
    d = forward.make_data(m, 8 * B, torch.float32, dev)
    q = base.randomize_limited_and_rotational_joints(m, d.qpos, gen)
    kept.append(q[base.has_contacts(m, d.replace(qpos=q))])
  q = torch.cat(kept)[:B]
  v = 2 * torch.randn((B, m.nv), generator=gen, device=dev)
  u = 2 * torch.rand((B, m.nu), generator=gen, device=dev) - 1
  d = forward.make_data(m, B, torch.float32, dev).replace(qpos=q, qvel=v,
                                                          ctrl=u)
  d = forward.step1(m, d, skipsensor=True)
  d = forward.actuation(m, d)
  d = forward.fwd_acceleration(m, d)
  args = (d.efc_J, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss,
          d.efc_active.to(torch.float32), d.qacc_smooth, d.qacc_smooth)
  return args, d


def cone_zones(lay, J, aref, active, x):
  """Active elliptic contacts at the solution x, and the shares of them
  in the top, bottom and middle zones."""
  import torch
  rows, mu, scale = lay.ell_groups[3]
  jar = torch.einsum('bev,bv->be', J, x) - aref
  rows_t = torch.as_tensor(rows, device=J.device)
  y = jar[:, rows_t] * torch.as_tensor(scale, dtype=J.dtype, device=J.device)
  mu_t = torch.as_tensor(mu, dtype=J.dtype, device=J.device)
  n, t = y[..., 0], y[..., 1:].norm(dim=-1).clamp(min=1e-15)
  on = active[:, rows_t[:, 0]] > 0
  top, bottom = n >= mu_t * t, mu_t * n <= -t
  mid = ~top & ~bottom
  count = int(on.sum())
  return on, {z: int((mask & on).sum()) / max(count, 1)
              for z, mask in (('top', top), ('bottom', bottom),
                              ('mid', mid))}


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; the port\'s chip check needs one',
          file=sys.stderr)
    return 2
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  from dm_control_tpu_torch import suite
  from dm_control_tpu_torch._src import forward
  from dm_control_tpu_torch._src import solver
  from dm_control_tpu_torch._src import efc
  from dm_control_tpu_torch.ops import build
  from dm_control_tpu_torch.ops import linalg_kernel as lk
  from dm_control_tpu_torch.ops import newton_kernel as nk
  from dm_control_tpu_torch.parallel import BatchedEnv
  from dm_control_tpu_torch.parallel import runner

  dev = torch.device('cuda')
  name = torch.cuda.get_device_name(0)
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip()
  log(f'# torch {torch.__version__} cuda {torch.version.cuda} on {name}')

  # -- 1. build ---------------------------------------------------------------
  t0 = time.perf_counter()
  build.library()
  log(f'# phase build: {time.perf_counter() - t0:.1f} s (nvcc '
      f'{build.build_seconds if build.build_seconds is not None else 0:.1f} s)')
  for line in build.build_log.splitlines():
    if 'registers' in line or 'spill' in line:
      log('#   ' + line.strip())

  # -- 2. kernels against their plain versions ----------------------------------
  gen = torch.Generator(device=dev)
  gen.manual_seed(0)

  def spd(n, g):
    a = torch.randn((BATCH, n, n), generator=g, device=dev)
    return a @ a.transpose(1, 2) + n * torch.eye(n, device=dev)

  # n = 3 and MAX_N draw from a generator of their own, so that every
  # later phase sees the same draws of `gen` as before they were added
  k1_gen = torch.Generator(device=dev)
  k1_gen.manual_seed(1)
  k1_err = {}
  for n, g in ((9, gen), (27, gen), (56, gen), (3, k1_gen),
               (lk.MAX_N, k1_gen)):
    A = spd(n, g)
    b = torch.randn((BATCH, n), generator=g, device=dev)
    L_ref = lk.cholesky_plain(A)
    pairs = {
        'cholesky_batched': (lk.cholesky_batched(A), L_ref),
        'chol_solve_batched': (lk.chol_solve_batched(A, b),
                               lk.chol_solve_plain(A, b)),
        'cho_solve_batched': (lk.cho_solve_batched(L_ref, b),
                              lk.cho_solve_plain(L_ref, b)),
    }
    torch.cuda.synchronize()
    for k, (x, ref) in pairs.items():
      err = scaled_err(x, ref).max().item()
      k1_err[k, n] = (x - ref).abs().max().item()
      log(f'# phase kernels: {k} n={n}: max scaled err {err:.2e}')
      assert err <= 1e-4, f'{k} at n={n}: {err:.2e} > 1e-4'
    k1_bits(lk, A, b, pairs['cholesky_batched'][0],
            pairs['chol_solve_batched'][0],
            lk.cho_solve_batched(pairs['cholesky_batched'][0], b))

  task = suite.build_task('walker', 'walk')        # CUDA by default
  m = task.model
  lay = efc.layout(m)
  env = BatchedEnv(task, BATCH)
  state = env.reset()
  state, _ = env.rollout_fn(40)(state, gen)   # falls onto the floor
  d = forward.step1(m, state.data, skipsensor=True)
  d = forward.actuation(m, d)
  d = forward.fwd_acceleration(m, d)
  k2_args = (d.efc_J, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss,
             d.efc_active.to(torch.float32), d.qacc_smooth, d.qacc_warmstart)
  k2_kw = dict(niter=int(m.opt.iterations), ls_iter=solver.LS_ITERATIONS,
               tol=solver.effective_tol(m.opt.tolerance, torch.float32),
               meaninertia=float(m.stat_meaninertia))
  x_k, f_k, iters = nk.newton_solve_batched(*k2_args, lay=lay,
                                            return_iters=True, **k2_kw)
  x_p, f_p = nk.newton_solve_plain(*k2_args, types=lay.types, **k2_kw)
  # the plain version at float64 on the same inputs, at the model's own
  # tolerance: the optimum both float32 solves approximate
  x_64, _ = nk.newton_solve_plain(
      *[a.double() for a in k2_args], types=lay.types,
      **dict(k2_kw, tol=solver.effective_tol(m.opt.tolerance, torch.float64)))
  active_lanes = int(d.efc_active[:, 6:].any(dim=1).sum())
  log(f'# phase kernels: newton_solve_batched B={BATCH} nefc={lay.nefc} '
      f'nv={m.nv}: lanes in contact {active_lanes}; iterations mean '
      f'{iters.float().mean().item():.2f} max {int(iters.max())}')
  assert active_lanes >= BATCH // 4, 'K2 inputs: too few lanes in contact'
  assert torch.isfinite(f_k).all() and torch.isfinite(x_k).all()
  # The bounds of tests/test_pallas.py (mean <= 1e-4, max <= 5e-2, <= 10%
  # of lanes above 1e-3), on the lane-scaled error (`lane_scaled_err`),
  # against the plain float32 solve and against the float64 optimum.  The
  # component-scaled readings are printed for the record: on walker's
  # first floor impacts they fail 5e-2 for the plain float32 solve itself
  # against float64, so they measure float32, not the kernel.
  k2_check('K2 kernel vs plain float32', x_k, x_p, gate=True)
  k2_check('K2 kernel vs plain float64', x_k.double(), x_64, gate=True)
  k2_check('K2 plain float32 vs plain float64', x_p.double(), x_64,
           gate=False)
  k2_err = (x_k - x_p).abs().max().item()
  newton_launch(nk, 'newton_solve_batched', lay, m.nv, BATCH)
  newton_bits(nk, 'newton_solve_batched', k2_args, lay, k2_kw,
              (x_k, f_k, iters))

  # K2-ell on finger-spin inputs rich in contacts, same bounds (ell_gates).
  f_task = suite.build_task('finger', 'spin')      # CUDA by default
  fm = f_task.model
  f_lay = efc.layout(fm)
  ell_args, f_d = finger_solver_inputs(fm, f_lay, BATCH, gen, dev)
  ell_kw = dict(niter=int(fm.opt.iterations), ls_iter=solver.LS_ITERATIONS,
                tol=solver.effective_tol(fm.opt.tolerance, torch.float32),
                meaninertia=float(fm.stat_meaninertia))
  nk.reset_launches()
  xe_k, fe_k, ell_iters = nk.newton_solve_batched(
      *ell_args, lay=f_lay, return_iters=True, **ell_kw)
  assert nk.LAUNCHES == {'newton_solve_batched': 0, 'newton_solve_ell': 1}
  plain_kw = dict(types=f_lay.types, ell_groups=f_lay.ell_groups)
  xe_p, fe_p, ell_iters_p = nk.newton_solve_plain(
      *ell_args, **plain_kw, return_iters=True, **ell_kw)
  xe_64, fe_64 = nk.newton_solve_plain(
      *[a.double() for a in ell_args], **plain_kw,
      **dict(ell_kw, tol=solver.effective_tol(fm.opt.tolerance,
                                              torch.float64)))
  on, zones = cone_zones(f_lay, ell_args[0].double(), ell_args[2].double(),
                         ell_args[5], xe_64)
  cones = on.sum(dim=1)
  lanes_on = float((cones > 0).double().mean())
  log(f'# phase kernels: newton_solve_ell B={BATCH} nefc={f_lay.nefc} '
      f'nv={fm.nv} ncg={len(f_lay.ell_groups[3][0])}: lanes with an active '
      f'elliptic row {lanes_on:.4f}; active contacts {int(cones.sum())} '
      f'(mean {cones.double().mean().item():.2f} per lane), zones at the '
      f'float64 optimum top {zones["top"]:.4f} bottom '
      f'{zones["bottom"]:.4f} mid {zones["mid"]:.4f}; iterations mean '
      f'{ell_iters.float().mean().item():.2f} max {int(ell_iters.max())} '
      f'(plain float32: mean {ell_iters_p.float().mean().item():.2f} max '
      f'{int(ell_iters_p.max())}; lanes above 20: kernel '
      f'{int((ell_iters > 20).sum())}, plain {int((ell_iters_p > 20).sum())}; '
      f'lanes with the same count '
      f'{float((ell_iters == ell_iters_p).double().mean()):.4f})')
  assert lanes_on >= 0.9, 'K2-ell inputs: too few lanes in contact'
  assert zones['bottom'] >= 0.01 and zones['mid'] >= 0.01, zones
  assert torch.isfinite(fe_k).all() and torch.isfinite(xe_k).all()
  ell_gates('K2-ell', xe_k, xe_p, xe_64)
  for what, f, ref in (('kernel vs plain float32', fe_k, fe_p),
                       ('kernel vs plain float64', fe_k.double(), fe_64),
                       ('plain float32 vs plain float64', fe_p.double(),
                        fe_64)):
    err = lane_scaled_err(f, ref)
    log(f'#   K2-ell forces, {what} (record): lane-scaled mean '
        f'{err.mean().item():.2e} max {err.max().item():.2e}')
  ell_err = (xe_k - xe_p).abs().max().item()
  newton_launch(nk, 'newton_solve_ell', f_lay, fm.nv, BATCH)
  newton_bits(nk, 'newton_solve_ell', ell_args, f_lay, ell_kw,
              (xe_k, fe_k, ell_iters))
  # The optimum does not depend on the Hessian or on the line search's
  # phi'': a wrong cone block there changes only the path to it.  One
  # Newton iteration does.  With no line-search step it lands on
  # a - H^-1 grad (the cone blocks of H); with one, alpha = 1 - phi'(1) /
  # phi''(1) (the cone blocks of phi'').  Where the step is exact, phi'(1)
  # is rounding and alpha_n rounds to 1.0 in float32, which the guarded
  # Newton's strict bracket test sends to the bisection midpoint, 2.5 or
  # 0.5, lane by lane: so the one-step iterate is held only on the lanes
  # where the float64 line search moves alpha off 1, where phi'' sets it.
  one = {}
  for ls in (0, 1):
    kw1 = dict(ell_kw, niter=1, ls_iter=ls)
    one[ls] = (
        nk.newton_solve_batched(*ell_args, lay=f_lay, **kw1)[0],
        nk.newton_solve_plain(*ell_args, **plain_kw, **kw1)[0],
        nk.newton_solve_plain(
            *[a.double() for a in ell_args], **plain_kw,
            **dict(kw1, tol=solver.effective_tol(fm.opt.tolerance,
                                                 torch.float64)))[0])
  moved = lane_scaled_err(one[0][2], ell_args[6].double()).amax(dim=1) > 1e-3
  off = lane_scaled_err(one[1][2], one[0][2]).amax(dim=1) > 1e-3
  log(f'# phase kernels: newton_solve_ell, one Newton iteration: lanes '
      f'whose step moves qacc {float(moved.double().mean()):.4f}; lanes '
      f'whose one line-search step moves alpha off 1 '
      f'{float(off.double().mean()):.4f}')
  assert float(moved.double().mean()) >= 0.5, 'K2-ell one step: no step'
  assert float(off.double().mean()) >= 0.2, 'K2-ell one step: alpha at 1'
  ell_gates('K2-ell one iteration, no line search,', *one[0])
  ell_gates('K2-ell one iteration, one line-search step, alpha off 1,',
            *(x[off] for x in one[1]))

  # -- 3. against the float64 CPU path -----------------------------------------
  # REF_LANES lanes of walker's state after the 40-step rollout, and of the
  # finger-spin lanes in contact; the first 64 lanes' controls from `gen`
  t0 = time.perf_counter()
  ref_gen = torch.Generator(device=dev)
  ref_gen.manual_seed(REF_SEED)
  for what, model, data, n_sub in (
      ('walker-walk', m, state.data, env.n_sub_steps),
      ('finger-spin', fm, f_d, f_task.n_sub_steps())):
    ctrl = reference_controls(gen, ref_gen, model.nu, REF_LANES, dev)
    cpu = suite.build_task(*what.split('-'), device='cpu').model
    reference_gate(what, model, cpu, data, ctrl, n_sub, lk)
  log(f'# phase reference: {time.perf_counter() - t0:.1f} s')

  # -- 4. the main path: walker-walk@4096 rollout, three runs -----------------
  run = env.rollout_fn(CONTROL_STEPS)
  w_sps = []
  for i in range(WALKER_RUNS):
    state = env.reset(seed=i)
    torch.cuda.synchronize()
    lk.reset_launches()
    nk.reset_launches()
    resets0 = env.reset_calls
    t0 = time.perf_counter()
    state, rewards = run(state, gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(lk.LAUNCHES, **nk.LAUNCHES)
    resets = env.reset_calls - resets0
    w_sps.append(BATCH * CONTROL_STEPS / dt)
    log(f'# phase rollout: walker-walk@{BATCH} run {i} x {CONTROL_STEPS} '
        f'control steps in {dt:.2f} s ({w_sps[-1]:.1f} env-steps/s); '
        f'auto-reset calls {resets}; launches {launches}; mean reward '
        f'{rewards.mean().item():.4f}')
    for f in forward._STATE_FIELDS[:-1]:
      x = getattr(state.data, f)
      assert x.dtype == torch.bool or torch.isfinite(x).all(), f'{f} not finite'
    assert tuple(rewards.shape) == (CONTROL_STEPS, BATCH)
    assert bool(((rewards >= 0) & (rewards <= 1)).all()), 'reward outside [0,1]'
    for k, n in launches.items():
      want = PER_STEP[k] * CONTROL_STEPS + PER_RESET[k] * resets
      assert n == want, f'{k}: {n} launches, expected {want}'
  log(f'# walker-walk@{BATCH} env-steps/s: '
      f'{sorted(w_sps)[len(w_sps) // 2]:.1f} (median of {WALKER_RUNS} runs: '
      f'{", ".join(f"{v:.1f}" for v in w_sps)})')

  # -- 4b. the main path: finger-spin@4096 rollout, three runs ------------------
  f_env = BatchedEnv(f_task, BATCH)
  f_run = f_env.rollout_fn(CONTROL_STEPS)
  f_sps = []
  for i in range(FINGER_RUNS):
    state = f_env.reset(seed=i)
    torch.cuda.synchronize()
    lk.reset_launches()
    nk.reset_launches()
    resets0 = f_env.reset_calls
    t0 = time.perf_counter()
    state, rewards = f_run(state, gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    f_launches = dict(lk.LAUNCHES, **nk.LAUNCHES)
    f_sps.append(BATCH * CONTROL_STEPS / dt)
    log(f'# phase rollout: finger-spin@{BATCH} run {i} x {CONTROL_STEPS} '
        f'control steps in {dt:.2f} s ({f_sps[-1]:.1f} env-steps/s); '
        f'launches {f_launches}; mean reward {rewards.mean().item():.4f}')
    for f, x in forward.state_of(state.data).items():
      assert x.dtype == torch.bool or torch.isfinite(x).all(), f'{f} not finite'
    assert tuple(rewards.shape) == (CONTROL_STEPS, BATCH)
    assert bool(((rewards >= 0) & (rewards <= 1)).all()), 'finger reward'
    assert f_env.reset_calls == resets0        # resets come from the pool
    for k, n in f_launches.items():
      want = FINGER_PER_STEP[k] * CONTROL_STEPS
      assert n == want, f'finger {k}: {n} launches, expected {want}'
  log(f'# finger-spin@{BATCH} env-steps/s: '
      f'{sorted(f_sps)[len(f_sps) // 2]:.1f} (median of {FINGER_RUNS} runs: '
      f'{", ".join(f"{v:.1f}" for v in f_sps)})')
  launches['newton_solve_ell'] = f_launches['newton_solve_ell']

  # -- 4c. finger-spin's reset pool on the card -------------------------------
  # An episode limit of 0.06 s (3 control steps) sends every lane through
  # the pool at the third step: each lane's integration state is then pool
  # entry runner.pool_index(0, lane, B), and init_states is not called.
  p_env = BatchedEnv(f_task, BATCH, time_limit=0.06)
  state = p_env.reset(seed=FINGER_RUNS)
  torch.cuda.synchronize()
  lk.reset_launches()
  nk.reset_launches()
  resets0 = p_env.reset_calls
  state, rewards = p_env.rollout_fn(3)(state, gen)
  torch.cuda.synchronize()
  p_launches = dict(lk.LAUNCHES, **nk.LAUNCHES)
  taken = runner.pool_index(torch.zeros_like(state.episode_id),
                            torch.arange(BATCH, device=dev), BATCH)
  log(f'# phase rollout: finger-spin@{BATCH} x 3 control steps, episode '
      f'limit 0.06 s: episodes ended {int(state.episode_id.sum())}; '
      f'init_states resets {p_env.reset_calls - resets0}; launches '
      f'{p_launches}')
  assert bool((state.episode_id == 1).all() and (state.step_count == 0).all())
  assert p_env.reset_calls == resets0, 'finger reset outside the pool'
  for f, x in forward.state_of(state.data).items():
    assert torch.equal(x, state.reset_pool[f][taken]), f'pool {f}'
  assert bool(((rewards >= 0) & (rewards <= 1)).all()), 'finger reward'
  for k, n in p_launches.items():
    want = FINGER_PER_STEP[k] * 3
    assert n == want, f'finger pool run {k}: {n} launches, expected {want}'

  # -- 5. timing at the main path's shapes ----------------------------------------
  lib = build.library()
  stream = torch.cuda.current_stream().cuda_stream
  rows = []

  def k1_rows(A, b, counts):
    """K1a/b/c timings on one task's (B, n, n) qM and (B, n) vector; the
    `kernel_ms` entries run the ctypes entries on pre-made buffers."""
    B, n, _ = A.shape
    cfg = lk.launch_config(n)
    L = lk.cholesky_batched(A)
    l_out, x_out = torch.empty_like(A), torch.empty_like(b)
    mat, vec = B * n * n * 4, B * n * 4
    calls = {
        'cholesky_batched': (
            lambda: lk.cholesky_batched(A), lambda: lk.cholesky_plain(A),
            lambda: torch.linalg.cholesky(A),
            lambda: lib.dmc_cholesky(A.data_ptr(), l_out.data_ptr(), n, B,
                                     *cfg, stream),
            2 * mat, B * n ** 3 / 3),
        'chol_solve_batched': (
            lambda: lk.chol_solve_batched(A, b),
            lambda: lk.chol_solve_plain(A, b),
            lambda: torch.linalg.solve(A, b),
            lambda: lib.dmc_chol_solve(A.data_ptr(), b.data_ptr(),
                                       x_out.data_ptr(), n, B, *cfg, stream),
            mat + 2 * vec, B * (n ** 3 / 3 + 2 * n * n)),
        'cho_solve_batched': (
            lambda: lk.cho_solve_batched(L, b),
            lambda: lk.cho_solve_plain(L, b),
            lambda: torch.cholesky_solve(b[..., None], L),
            lambda: lib.dmc_cho_solve(L.data_ptr(), b.data_ptr(),
                                      x_out.data_ptr(), n, B, *cfg, stream),
            mat + 2 * vec, B * 2 * n * n)}
    out = {}
    for k, (fn, plain, library, entry, nbytes, flops) in calls.items():
      build.check(entry(), k)
      kernels, device_ms = device_kernels(fn, 20)
      assert kernels == 1, f'{k} n={n}: {kernels} CUDA kernels per call'
      b_ms, b_by = bound_ms(nbytes, flops)
      out[k] = dict(
          launches=counts[k], max_abs_err=k1_err[k, n], ms=cuda_ms(fn, 50),
          plain_ms=cuda_ms(plain, 5), bound_ms=b_ms, bound_by=b_by,
          library_ms=cuda_ms(library, 50), kernel_ms=cuda_ms(entry, 50),
          device_ms=device_ms, kernels_per_call=kernels, shape=[B, n, n],
          envs=cfg[0], threads=cfg[1], smem_bytes=cfg[2])
      log(f'# phase timing: {k} n={n}: {out[k]}')
    return out

  walker_k1 = k1_rows(d.qM.contiguous(), d.qfrc_smooth.contiguous(),
                      launches)
  finger_k1 = k1_rows(f_d.qM.contiguous(), f_d.qfrc_smooth.contiguous(),
                      f_launches)
  for k in ('cholesky_batched', 'chol_solve_batched', 'cho_solve_batched'):
    rows.append(dict(name=k, route='cuda', source=SOURCES[k],
                     replaces=REPLACES[k], **walker_k1[k],
                     finger=finger_k1[k]))
  per_step = {what: sum(PER_STEP[k] * walker_k1[k][what]
                        for k in walker_k1)
              for what in ('ms', 'kernel_ms', 'device_ms')}
  log(f'# phase timing: walker K1 per control step (11 K1a + 10 K1b + 10 '
      f'K1c): wrapper {per_step["ms"]:.6g} ms, ctypes launches '
      f'{per_step["kernel_ms"]:.6g} ms, device {per_step["device_ms"]:.6g} ms')

  def row(k, fn, plain, library, nbytes, flops, err, reps=50, plain_reps=5,
          **extra):
    ms = cuda_ms(fn, reps)
    b_ms, b_by = bound_ms(nbytes, flops)
    rows.append(dict(
        name=k, route='cuda', source=SOURCES[k], replaces=REPLACES[k],
        launches=launches[k], max_abs_err=err, ms=ms,
        plain_ms=cuda_ms(plain, plain_reps), bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(library, reps) if library is not None else None,
        **extra))
    log(f'# phase timing: {k}: {ms:.6g} ms per call, bound {b_ms:.6g} ms '
        f'({b_by}), plain {rows[-1]["plain_ms"]:.6g} ms, library '
        f'{rows[-1]["library_ms"]} ms; {extra or ""}')

  n, nv, nefc = m.nv, m.nv, lay.nefc
  k2_bytes = BATCH * 4 * (nefc * nv + nv * nv + 4 * nefc + 2 * nv
                          + nv + nefc)
  row('newton_solve_batched',
      lambda: nk.newton_solve_batched(*k2_args, lay=lay, **k2_kw),
      lambda: nk.newton_solve_plain(*k2_args, types=lay.types, **k2_kw),
      None, k2_bytes,
      newton_flops(nefc, nv, solver.LS_ITERATIONS, iters), k2_err,
      reps=10, plain_reps=2, max_iters=int(iters.max()))
  f_nv, f_nefc = fm.nv, f_lay.nefc
  ncg = len(f_lay.ell_groups[3][0])
  ell_bytes = (BATCH * 4 * (f_nefc * f_nv + f_nv * f_nv + 4 * f_nefc
                            + 2 * f_nv + f_nv + f_nefc)
               + 4 * (3 * ncg + ncg + f_nefc))
  row('newton_solve_ell',
      lambda: nk.newton_solve_batched(*ell_args, lay=f_lay, **ell_kw),
      lambda: nk.newton_solve_plain(*ell_args, **plain_kw, **ell_kw),
      None, ell_bytes,
      newton_flops(f_nefc, f_nv, solver.LS_ITERATIONS, ell_iters,
                   cones=cones.to(ell_iters.device)), ell_err,
      reps=10, plain_reps=2, max_iters=int(ell_iters.max()))

  log(smi)
  log(json.dumps({'kernels': rows}, allow_nan=False))
  log(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
