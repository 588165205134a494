"""K2: the port's batched Newton solve against the JAX package.

Solver inputs are built by the JAX package exactly as tests/test_pallas.py
builds them (forward at a perturbed qpos0, batch 16, float64) on walker
and cheetah.  The port's plain version (the batched torch core) must land
on the same optimum as the Pallas kernel in interpret mode and as the XLA
core, to 1e-5 scaled by max(1, |ref|): all three stop at opt.tolerance, so
their iterates may differ by about that (the bound of test_pallas.py).
The CUDA kernel runs only on a card (`cuda` marker).
"""

import jax
import numpy as np
import pytest
import torch

from dm_control_tpu import suite as jsuite
from dm_control_tpu._src import efc as jefc
from dm_control_tpu._src import forward as jforward
from dm_control_tpu._src import solver as jsolver
from dm_control_tpu.ops import newton_kernel as jnk
from dm_control_tpu.suite import common as jcommon
from dm_control_tpu_torch._src import efc
from dm_control_tpu_torch.mjcf import compiler
from dm_control_tpu_torch.ops import newton_kernel as nk

BATCH = 16


def _solver_inputs(domain, task_name):
  task = jsuite.build_task(domain, task_name)
  m = task.model
  lay = jefc.layout(m)
  keys = jax.random.split(jax.random.PRNGKey(0), BATCH)

  def init_one(k):
    d = jforward.make_data(m)
    qpos = d.qpos + 0.05 * jax.random.normal(k, (m.nq,), d.qpos.dtype)
    return jforward.forward(m, d.replace(qpos=qpos))

  db = jax.jit(jax.vmap(init_one))(keys)
  args = [np.asarray(x) for x in (
      db.efc_J, db.qM, db.efc_aref, db.efc_D, db.efc_frictionloss,
      db.efc_active.astype(db.qpos.dtype), db.qacc_smooth, db.qacc_smooth)]
  kw = dict(niter=max(int(m.opt.iterations), 1), ls_iter=12,
            tol=jsolver.effective_tol(float(m.opt.tolerance), db.qpos.dtype),
            meaninertia=float(m.stat_meaninertia or 1.0))
  return m, lay, args, kw


@pytest.fixture(scope='module', params=[('walker', 'walk'), ('cheetah', 'run')],
                ids=['walker', 'cheetah'])
def solved(request):
  m, lay, args, kw = _solver_inputs(*request.param)
  jargs = [jax.numpy.asarray(a) for a in args]
  x_pal, f_pal = jnk.newton_solve_batched(*jargs, lay=lay, interpret=True,
                                          **kw)
  x_xla, f_xla = jax.jit(jax.vmap(
      lambda *a: jsolver._solve_core_xla(*a, lay=lay, **kw)))(*jargs)
  x, f, iters = nk.newton_solve_plain(
      *[torch.tensor(a) for a in args], types=lay.types,
      return_iters=True, **kw)
  return dict(nefc=lay.nefc, x=x.numpy(), f=f.numpy(), iters=iters.numpy(),
              pallas=(np.asarray(x_pal), np.asarray(f_pal)),
              xla=(np.asarray(x_xla), np.asarray(f_xla)))


def _scaled_err(x, ref):
  return float((np.abs(x - ref) / np.maximum(1.0, np.abs(ref))).max())


@pytest.mark.parametrize('ref', ['pallas', 'xla'])
def test_plain_matches_jax(solved, ref):
  x_ref, f_ref = solved[ref]
  assert solved['x'].shape == x_ref.shape
  assert solved['f'].shape == f_ref.shape == (BATCH, solved['nefc'])
  ex, ef = _scaled_err(solved['x'], x_ref), _scaled_err(solved['f'], f_ref)
  print(f'newton vs {ref} (nefc {solved["nefc"]}): max scaled err qacc '
        f'{ex:.2e} force {ef:.2e}')
  assert ex <= 1e-5 and ef <= 1e-5


def test_plain_iterates_and_stops(solved):
  """Lanes take Newton steps and every lane exits before the budget (a
  lane whose start already meets the gradient rule takes none)."""
  assert solved['iters'].max() >= 1
  assert (solved['iters'] < 100).all()


def test_wrapper_routes_cpu_tensors_to_plain():
  m, lay, args, kw = _solver_inputs('walker', 'walk')
  nk.reset_launches()
  x, f = nk.newton_solve_batched(*[torch.tensor(a) for a in args],
                                 lay=lay, **kw)
  x_p, f_p = nk.newton_solve_plain(*[torch.tensor(a) for a in args],
                                   types=lay.types, **kw)
  torch.testing.assert_close(x, x_p, rtol=0, atol=0)
  torch.testing.assert_close(f, f_p, rtol=0, atol=0)
  assert nk.LAUNCHES['newton_solve_batched'] == 0


def test_wrapper_raises_on_elliptic_layout():
  """finger's elliptic cones (K2-ell) are not ported: the wrapper raises
  instead of solving them as pyramids."""
  m = compiler.compile_path(jcommon.model_path('finger.xml'))
  lay = efc.layout(m)
  assert lay.ell_groups
  z = lambda *s: torch.zeros((2,) + s)
  with pytest.raises(NotImplementedError, match='K2-ell'):
    nk.newton_solve_batched(
        z(lay.nefc, m.nv), z(m.nv, m.nv), z(lay.nefc), z(lay.nefc),
        z(lay.nefc), z(lay.nefc), z(m.nv), z(m.nv), lay=lay, niter=10,
        ls_iter=12, tol=1e-6, meaninertia=1.0)


def test_kernel_limit_matches_source():
  src = (nk.build.CSRC / 'newton_kernel.cu').read_text()
  assert f'constexpr int MAX_NV = {nk.MAX_NV};' in src


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device; chip_smoke.py runs this check there')
  m, lay, args, kw = _solver_inputs('walker', 'walk')
  kw['tol'] = max(kw['tol'], 1e-6)        # the float32 floor
  dev = [torch.from_numpy(a.astype(np.float32)).cuda() for a in args]
  x_ref, _ = nk.newton_solve_plain(*dev, types=lay.types, **kw)
  nk.reset_launches()
  x, _ = nk.newton_solve_batched(*dev, lay=lay, **kw)
  assert nk.LAUNCHES['newton_solve_batched'] == 1
  # scaled by max(1, the lane's largest |ref|), as chip_smoke.py holds it
  lane = x_ref.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
  err = ((x - x_ref).abs() / lane).cpu().numpy()
  assert err.mean() <= 1e-4 and err.max() <= 5e-2
  assert (err.max(axis=1) > 1e-3).sum() <= err.shape[0] // 10
