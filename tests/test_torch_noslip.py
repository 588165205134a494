"""noslip and the Newton solve past the kernel's dofs: the port against the
JAX package, float64 on the CPU.

noslip (`solver._noslip`, dog's `noslip_iterations` 4): two small models
built here, each run through `forward` (its solve and noslip sweeps) in
both packages from the same seeded states, qacc, efc_force and
qfrc_constraint within TOL = 1e-6 scaled by max(1, the lane's largest
|ref|):
  - pyramidal: a box on a plane (condim-3 pyramids at its corners), a
    ball of condim 6 (the torsional and rolling pyramid rows) and a hinge
    with friction loss (a dof friction row);
  - elliptic: the same bodies under cone="elliptic" (the cone sections
    of condim 3 and 6).
The bodies slide and spin, so the sweeps move the friction forces: the
same step without noslip lands elsewhere.

The core (`newton_kernel.newton_solve_core`, the route past MAX_NV): with
K1b's wrapper replaced by a recording stand-in (the plain twin, counting
its calls), it gives `newton_solve_plain`'s bits, calls the stand-in once
per iteration of the batch loop, and reports that count in CORE_LOOPS;
`solver.solve` sends a model past MAX_NV there and the others to the
kernel's wrapper.  On the card (`cuda` marker) the core launches K1b once
per loop iteration, holds its plain float32 twin within K2's bounds, and
the kernel's wrapper still raises past MAX_NV.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dm_control_tpu._src import engine as jengine
from dm_control_tpu._src import forward as jforward
from dm_control_tpu_torch._src import efc
from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch._src import forward
from dm_control_tpu_torch._src import solver
from dm_control_tpu_torch.ops import linalg_kernel
from dm_control_tpu_torch.ops import newton_kernel as nk

B = 16
# both packages' Newton solves stop at opt.tolerance (1e-8), so their
# iterates, and what noslip makes of them, may differ by about that times
# the problem's conditioning: the domain tests' bound
TOL = 1e-6

NOSLIP_XML = """<mujoco>
  <option noslip_iterations="4" timestep="0.005" cone="{cone}"/>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 .1" friction=".9 .02 .01"/>
    <body name="box" pos="0 0 .05"><freejoint/>
      <geom type="box" size=".05 .04 .05" condim="3" mass="1"/></body>
    <body name="ball" pos=".3 0 .05"><freejoint/>
      <geom type="sphere" size=".05" condim="6" friction=".8 .03 .02"
            mass=".5"/></body>
    <body name="arm" pos="-.3 0 .3">
      <joint name="hinge" type="hinge" axis="0 1 0" frictionloss=".5"
             damping=".1"/>
      <geom type="capsule" fromto="0 0 0 .2 0 0" size=".02" contype="0"
            conaffinity="0" mass=".3"/></body>
  </worldbody>
</mujoco>"""


def _states(m, rng):
  """B states: the box and the ball 0 to 1 mm into the floor at random
  yaws, sliding and spinning; the hinge at a random angle and speed."""
  qpos = np.tile(np.asarray(m.qpos0, np.float64), (B, 1))
  qvel = np.zeros((B, m.nv))
  for body, (q, v, h) in enumerate(((0, 0, 0.05), (7, 6, 0.05))):
    yaw = rng.uniform(-np.pi, np.pi, B)
    qpos[:, q:q + 3] = np.stack([rng.uniform(-0.1, 0.1, B) + 0.3 * body,
                                 rng.uniform(-0.1, 0.1, B),
                                 h - rng.uniform(0, 1e-3, B)], -1)
    qpos[:, q + 3:q + 7] = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw,
                                     np.sin(yaw / 2)], -1)
    qvel[:, v:v + 2] = 0.5 * rng.randn(B, 2)
    qvel[:, v + 3:v + 6] = 2.0 * rng.randn(B, 3)
  qpos[:, 14] = rng.uniform(-1, 1, B)
  qvel[:, 12] = 2.0 * rng.randn(B)
  return qpos, qvel


def _lane_err(x, ref):
  x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
  return float((np.abs(x - ref).max(1)
                / np.maximum(1.0, np.abs(ref).max(1))).max())


@pytest.mark.parametrize('cone', ['pyramidal', 'elliptic'])
def test_noslip_matches_jax(cone):
  """One `forward` of the noslip model in both packages from the same
  states: qacc, efc_force and qfrc_constraint within TOL; every friction
  kind of the model present and active on some lane; the step without
  noslip's sweeps differs from it."""
  xml = NOSLIP_XML.format(cone=cone)
  jm = jengine.load_model_from_string(xml)
  m = engine.load_model_from_string(xml, device='cpu')
  lay = efc.layout(m)
  assert int(m.opt.noslip_iterations) == 4
  if cone == 'elliptic':
    assert sorted(lay.ell_groups) == [3, 6]
  else:
    # the box's 4 corners on the floor (condim 3: 4 rows each), the ball
    # on the floor and against the box (condim 6: 10 rows each)
    assert lay.contact.pyr_row.size == 4 * 4 + 2 * 10
  assert (lay.types == efc.FRICTION).sum() == 1
  qpos, qvel = _states(m, np.random.RandomState(31))
  d0 = jforward.make_data(jm)
  jd = jax.jit(jax.vmap(lambda q, v: jforward.forward(
      jm, d0.replace(qpos=q, qvel=v))))(jnp.asarray(qpos), jnp.asarray(qvel))
  start = forward.make_data(m, B, torch.float64, 'cpu').replace(
      qpos=torch.tensor(qpos), qvel=torch.tensor(qvel))
  d = forward.forward(m, start)
  errs = {f: _lane_err(getattr(d, f).numpy(), getattr(jd, f))
          for f in ('qacc', 'efc_force', 'qfrc_constraint')}
  print(f'noslip, {cone}: max lane-scaled err '
        + ', '.join(f'{k} {e:.2e}' for k, e in errs.items()))
  assert all(e <= TOL for e in errs.values()), errs
  on = d.efc_active.numpy()
  assert on[:, lay.types == efc.FRICTION].any()
  assert on[:, lay.types != efc.FRICTION].any(1).all()
  m0 = copy.copy(m)
  m0.opt = dataclasses.replace(m.opt, noslip_iterations=0)
  d_off = forward.forward(m0, start)
  moved = _lane_err(d_off.qacc.numpy(), d.qacc.numpy())
  print(f'noslip, {cone}: qacc moved by the sweeps, lane-scaled {moved:.2e}')
  assert moved > 1e-3


def _core_inputs():
  """Solver inputs (float64, CPU) of the pyramidal noslip model's states,
  taken from the port's step (its rows, mass matrix and warmstart)."""
  m = engine.load_model_from_string(NOSLIP_XML.format(cone='pyramidal'),
                                    device='cpu')
  qpos, qvel = _states(m, np.random.RandomState(32))
  d = forward.forward(m, forward.make_data(m, B, torch.float64, 'cpu')
                      .replace(qpos=torch.tensor(qpos),
                               qvel=torch.tensor(qvel)))
  args = (d.efc_J, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss,
          d.efc_active.to(torch.float64), d.qacc_smooth, d.qacc_smooth)
  kw = dict(niter=int(m.opt.iterations), ls_iter=solver.LS_ITERATIONS,
            tol=solver.effective_tol(m.opt.tolerance, torch.float64),
            meaninertia=float(m.stat_meaninertia))
  return m, efc.layout(m), args, kw


def test_core_with_injected_chol_solve_matches_plain(monkeypatch):
  """The core with K1b's wrapper replaced by a recording stand-in gives
  `newton_solve_plain`'s bits (x, forces, iterations), calls the stand-in
  once per iteration of the batch loop, on the whole batch's Hessians,
  and reports those iterations in CORE_LOOPS."""
  _, lay, args, kw = _core_inputs()
  calls = []

  def recording(h, g):
    calls.append(tuple(h.shape))
    return linalg_kernel.chol_solve_plain(h, g)

  monkeypatch.setattr(linalg_kernel, 'chol_solve_batched', recording)
  nk.reset_launches()
  x, f, iters = nk.newton_solve_core(*args, lay=lay, return_iters=True, **kw)
  x_p, f_p, iters_p, loops = nk.newton_solve_plain(
      *args, types=lay.types, ell_groups=lay.ell_groups, return_iters=True,
      return_loops=True, **kw)
  assert torch.equal(x, x_p) and torch.equal(f, f_p)
  assert torch.equal(iters, iters_p)
  assert loops == int(iters.max()) >= 2
  nv = args[1].shape[1]
  assert calls == [(B, nv, nv)] * loops
  assert nk.CORE_LOOPS == {'calls': 1, 'loops': loops}
  assert nk.LAUNCHES == {'newton_solve_batched': 0, 'newton_solve_ell': 0}
  print(f'core: {loops} loop iterations, iterations per lane '
        f'{iters.tolist()}')
  nk.reset_launches()
  assert nk.CORE_LOOPS == {'calls': 0, 'loops': 0}


FREE_BODIES_XML = """<mujoco>
  <worldbody>
    <geom type="plane" size="5 5 .1"/>
    {bodies}
  </worldbody>
</mujoco>"""


def test_solve_routes_past_max_nv_to_the_core(monkeypatch):
  """`solver.solve` sends a model of 11 free bodies (nv 66 > MAX_NV) to the
  core and the noslip model (nv 13) to the kernel's wrapper, by the layout
  alone."""
  bodies = ''.join(
      f'<body pos="{i % 4 * .3} {i // 4 * .3} .049"><freejoint/>'
      f'<geom type="sphere" size=".05"/></body>' for i in range(11))
  wide = engine.load_model_from_string(
      FREE_BODIES_XML.format(bodies=bodies), device='cpu')
  small = engine.load_model_from_string(
      NOSLIP_XML.format(cone='pyramidal'), device='cpu')
  assert wide.nv == 66 > nk.MAX_NV >= small.nv
  routed = []
  for name in ('newton_solve_core', 'newton_solve_batched'):
    fn = getattr(nk, name)
    monkeypatch.setattr(nk, name, lambda *a, fn=fn, name=name, **k: (
        routed.append(name), fn(*a, **k))[1])
  for m in (wide, small):
    routed.clear()
    d = forward.forward(m, forward.make_data(m, 2, torch.float64, 'cpu'))
    assert torch.isfinite(d.qacc).all()
    assert routed == (['newton_solve_core'] if m is wide
                      else ['newton_solve_batched'])


@pytest.mark.cuda
def test_core_launches_k1b_per_loop_on_card():
  """On the card the core launches K1b once per loop iteration (and no
  Newton kernel), and holds its plain float32 twin within K2's bounds
  (lane-scaled max 5e-2); newton_solve_batched still raises there past
  MAX_NV."""
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device; chip_smoke.py runs this check there')
  _, lay, args, kw = _core_inputs()
  args = [a.to('cuda', torch.float32) for a in args]
  kw = dict(kw, tol=solver.effective_tol(1e-8, torch.float32))
  linalg_kernel.reset_launches()
  nk.reset_launches()
  x, f = nk.newton_solve_core(*args, lay=lay, **kw)
  assert linalg_kernel.LAUNCHES['chol_solve_batched'] == nk.CORE_LOOPS[
      'loops'] > 0
  assert sum(nk.LAUNCHES.values()) == 0
  x_p, _ = nk.newton_solve_plain(*args, types=lay.types, **kw)
  err = ((x - x_p).abs().amax(1) / x_p.abs().amax(1).clamp(min=1.0)).max()
  assert float(err) <= 5e-2
  wide = torch.zeros((2, 3, nk.MAX_NV + 1), device='cuda')
  with pytest.raises(ValueError, match=f'1..{nk.MAX_NV}'):
    nk.newton_solve_batched(
        wide, torch.zeros((2, nk.MAX_NV + 1, nk.MAX_NV + 1), device='cuda'),
        *[torch.zeros((2, 3), device='cuda')] * 4,
        *[torch.zeros((2, nk.MAX_NV + 1), device='cuda')] * 2, lay=lay,
        niter=1, ls_iter=1, tol=1e-8, meaninertia=1.0)
