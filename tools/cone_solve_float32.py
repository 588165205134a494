"""The cone model's K2-ell solves at float32 on the CPU: the port's plain
float32 solve and the JAX package's (its XLA core), each against the
port's plain float64 solve of the same inputs.

    python3 tools/cone_solve_float32.py [--lanes 4096]

Run from the root of a checkout (CPU only; JAX with float64 enabled, as
the test suite runs it).  It draws the states that chip_smoke.py's kernel
phase draws for the cone model (`cone_states` from one numpy RandomState
seeded SLICE11_SEED: one copy, then two), builds their solver inputs
through the port at float32 as `chip_smoke.k2_task_check` does (on the
CPU, so they differ from the card's by float32 rounding), and prints for
each float32 solve the lanes whose lane-scaled error against float64 is
over 1e-3 (K2's line, `chip_smoke.lane_scaled_err`), its mean and largest
error, and how many of those lanes the two float32 solves share; the
largest error of one float32 solve on the lanes where the other is
within 1e-3 (a rule that relaxed K2's bounds only on plain float32's own
lanes would hold a correct float32 solve to this); the float64 solve's
distance from one run to 1e-15 (it is converged); and then
`chip_smoke.stop_gates` with each float32 solve in the kernel's place
and the other in plain float32's (the card's rule, held by two correct
float32 solves).
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT]
os.environ['JAX_PLATFORMS'] = 'cpu'

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dm_control_tpu._src import efc as jefc  # noqa: E402
from dm_control_tpu._src import engine as jengine  # noqa: E402
from dm_control_tpu._src import solver as jsolver  # noqa: E402
from dm_control_tpu_torch._src import efc  # noqa: E402
from dm_control_tpu_torch._src import engine  # noqa: E402
from dm_control_tpu_torch._src import forward  # noqa: E402
from dm_control_tpu_torch._src import solver  # noqa: E402
from dm_control_tpu_torch.ops import newton_kernel as nk  # noqa: E402


def solver_inputs(m, q, v):
  """The float32 solver inputs and kwargs of states (q, v), as
  `chip_smoke.k2_task_check` builds them."""
  d = forward.make_data(m, q.shape[0], torch.float32, 'cpu').replace(
      qpos=torch.tensor(q, dtype=torch.float32),
      qvel=torch.tensor(v, dtype=torch.float32))
  d = forward.step1(m, d, skipsensor=True)
  d = forward.actuation(m, d)
  d = forward.fwd_acceleration(m, d)
  args = (d.efc_J, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss,
          d.efc_active.to(torch.float32), d.qacc_smooth, d.qacc_warmstart)
  kw = dict(niter=int(m.opt.iterations), ls_iter=solver.LS_ITERATIONS,
            tol=solver.effective_tol(m.opt.tolerance, torch.float32),
            meaninertia=float(m.stat_meaninertia))
  return args, kw


def main():
  p = argparse.ArgumentParser()
  p.add_argument('--lanes', type=int, default=cs.BATCH)
  a = p.parse_args()
  rng = np.random.RandomState(cs.SLICE11_SEED)
  for copies in (1, 2):
    m = engine.load_model_from_string(cs.cones_xml(copies), device='cpu')
    lay = efc.layout(m)
    jm = jengine.load_model_from_string(cs.cones_xml(copies))
    jlay = jefc.layout(jm)
    for k, (rows, _, _) in lay.ell_groups.items():
      np.testing.assert_array_equal(rows, jlay.ell_groups[k][0])
    q, v = cs.cone_states(m, a.lanes, rng)
    args, kw = solver_inputs(m, q, v)
    plain = dict(types=lay.types, ell_groups=lay.ell_groups)
    x_p, _ = nk.newton_solve_plain(*args, **plain, **kw)
    x_64, _ = nk.newton_solve_plain(
        *[t.double() for t in args], **plain,
        **dict(kw, tol=solver.effective_tol(m.opt.tolerance, torch.float64)))
    jargs = [jax.numpy.asarray(t.numpy()) for t in args]
    x_j, _ = jax.jit(jax.vmap(lambda *t: jsolver._solve_core_xla(
        *t, lay=jlay, **kw)))(*jargs)
    x_j = torch.tensor(np.asarray(x_j))
    assert x_j.dtype == torch.float32
    off = {}
    for name, x in (('port plain float32', x_p),
                    ('JAX package float32 (XLA core)', x_j)):
      err = cs.lane_scaled_err(x.double(), x_64).amax(dim=1)
      off[name] = err > 1e-3
      print(f'cones x{copies} ({a.lanes} lanes, nv {m.nv}, nefc {lay.nefc}):'
            f' {name} vs port plain float64, lane-scaled: mean '
            f'{err.mean().item():.3g} max {err.max().item():.3g}; lanes over '
            f'1e-3 {int(off[name].sum())}')
    p_off, j_off = off.values()
    print(f'cones x{copies}: lanes over 1e-3 in both float32 solves '
          f'{int((p_off & j_off).sum())}; port only '
          f'{int((p_off & ~j_off).sum())}, JAX package only '
          f'{int((j_off & ~p_off).sum())}')
    for (name, x), other in ((('port', x_p), j_off), (('JAX package', x_j),
                                                     p_off)):
      err = cs.lane_scaled_err(x.double(), x_64).amax(dim=1)[~other]
      print(f'cones x{copies}: {name} float32 vs float64 on the lanes where '
            f'the other float32 solve is within 1e-3: largest '
            f'{err.max().item():.3g}')
    x_t, _ = nk.newton_solve_plain(
        *[t.double() for t in args], **plain, **dict(kw, niter=2000,
                                                     tol=1e-15))
    print(f'cones x{copies}: float64 solve vs the same to 1e-15, lane-scaled '
          f'max {cs.lane_scaled_err(x_64, x_t).max().item():.3g}')
    for x_k, x_other, name in ((x_j, x_p, 'JAX package'), (x_p, x_j, 'port')):
      cs.stop_gates(f'cones x{copies}, {name} float32 as the kernel', x_k,
                    x_other, x_64, lay, args)
      print(f'cones x{copies}: stop_gates holds the {name}\'s float32 solve')


if __name__ == '__main__':
  main()
