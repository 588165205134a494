"""K2 and K2-ell: the port's batched Newton solve against the JAX package.

Solver inputs are built by the JAX package exactly as tests/test_pallas.py
builds them (forward at a perturbed qpos0, batch 16, float64) on walker
and cheetah.  finger (elliptic cones) is rarely in contact near qpos0, so
its inputs come from joint angles drawn as its task draws them, kept
where they touch, with random joint velocities.  The port's plain version
(the batched torch core) must land on the same optimum as the Pallas
kernel in interpret mode and as the XLA core, to 1e-5 scaled by
max(1, |ref|): all three stop at opt.tolerance, so their iterates may
differ by about that (the bound of test_pallas.py); at stack_4's and
humanoid_CMU's layouts, past the TPU kernel's VMEM gate, against the XLA
core alone.  The CUDA kernels run only on a card (`cuda` marker).
"""

import ctypes
import functools

import jax
import numpy as np
import pytest
import torch

from dm_control_tpu import suite as jsuite
from dm_control_tpu._src import efc as jefc
from dm_control_tpu._src import forward as jforward
from dm_control_tpu._src import solver as jsolver
from dm_control_tpu.ops import newton_kernel as jnk
from dm_control_tpu.suite import base as jbase
from dm_control_tpu_torch.ops import newton_kernel as nk

BATCH = 16


def _contact_qpos_qvel(m, rng):
  """BATCH joint configurations in contact, drawn as finger's randomizer
  draws them, and random joint velocities."""
  qpos = np.tile(m.qpos0, (512, 1))
  for j in range(m.njnt):
    lo, hi = m.jnt_range[j] if m.jnt_limited[j] else (-np.pi, np.pi)
    qpos[:, m.jnt_qposadr[j]] = rng.uniform(lo, hi, 512)
  hit = np.asarray(jax.jit(jax.vmap(
      lambda q: jbase.has_contacts(m, jforward.make_data(m).replace(
          qpos=q))))(jax.numpy.asarray(qpos)))
  return qpos[hit][:BATCH], 3 * rng.randn(BATCH, m.nv)


@functools.lru_cache(maxsize=None)
def _solver_inputs(domain, task_name):
  """(model, layout, solver args as numpy, solver kwargs), built once per
  model; callers copy what they change."""
  task = jsuite.build_task(domain, task_name)
  m = task.model
  lay = jefc.layout(m)
  if lay.ell_groups:
    qpos, qvel = _contact_qpos_qvel(m, np.random.RandomState(0))
    db = jax.jit(jax.vmap(lambda q, v: jforward.forward(
        m, jforward.make_data(m).replace(qpos=q, qvel=v))))(
            jax.numpy.asarray(qpos), jax.numpy.asarray(qvel))
  else:
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


@pytest.fixture(scope='module', params=[('walker', 'walk'), ('cheetah', 'run'),
                                        ('finger', 'spin')],
                ids=['walker', 'cheetah', 'finger'])
def solved(request):
  m, lay, args, kw = _solver_inputs(*request.param)
  jargs = [jax.numpy.asarray(a) for a in args]
  x_pal, f_pal = jnk.newton_solve_batched(*jargs, lay=lay, interpret=True,
                                          **kw)
  x_xla, f_xla = jax.jit(jax.vmap(
      lambda *a: jsolver._solve_core_xla(*a, lay=lay, **kw)))(*jargs)
  x, f, iters = nk.newton_solve_plain(
      *[torch.tensor(a) for a in args], types=lay.types,
      ell_groups=lay.ell_groups, return_iters=True, **kw)
  return dict(nefc=lay.nefc, x=x.numpy(), f=f.numpy(), iters=iters.numpy(),
              niter=kw['niter'],
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
  """Lanes take Newton steps and every lane exits before the model's
  budget, opt.iterations (a lane whose start already meets the gradient
  rule takes none)."""
  print(f'newton (nefc {solved["nefc"]}): iterations per lane '
        f'{solved["iters"].tolist()} of {solved["niter"]}')
  assert solved['iters'].max() >= 1
  assert (solved['iters'] < solved['niter']).all()


@pytest.fixture(scope='module', params=[0, 1], ids=['ls0', 'ls1'])
def one_step(request):
  """finger's solve cut to one Newton iteration of 0 or 1 line-search
  steps.  The iterate is then a + alpha H^-1 grad with alpha = 1 or
  1 - phi'(1) / phi''(1): it depends on the Hessian's cone blocks and on
  the cone terms of phi'', which the converged optimum does not.  (More
  line-search steps make the iterate jump with rounding: the guarded
  Newton's strict bracket test meets phi' = 0 up to rounding once a step
  lands on a quadratic piece's minimum, and the Pallas kernel and the XLA
  core then differ from each other.)"""
  m, lay, args, kw = _solver_inputs('finger', 'spin')
  kw = dict(kw, niter=1, ls_iter=request.param)
  jargs = [jax.numpy.asarray(a) for a in args]
  x_pal, _ = jnk.newton_solve_batched(*jargs, lay=lay, interpret=True, **kw)
  x_xla, _ = jax.jit(jax.vmap(
      lambda *a: jsolver._solve_core_xla(*a, lay=lay, **kw)))(*jargs)
  x, _, iters = nk.newton_solve_plain(
      *[torch.tensor(a) for a in args], types=lay.types,
      ell_groups=lay.ell_groups, return_iters=True, **kw)
  return dict(x=x.numpy(), iters=iters.numpy(), start=args[6],
              ls_iter=request.param, pallas=np.asarray(x_pal),
              xla=np.asarray(x_xla))


@pytest.mark.parametrize('ref', ['pallas', 'xla'])
def test_plain_one_newton_step_matches_jax(one_step, ref):
  err = _scaled_err(one_step['x'], one_step[ref])
  moved = _scaled_err(one_step['x'], one_step['start'])
  print(f'newton finger, one iteration of {one_step["ls_iter"]} line-search '
        f'steps vs {ref}: max scaled err qacc {err:.2e} (step from the start '
        f'{moved:.2e}; iterations {one_step["iters"].tolist()})')
  assert one_step['iters'].sum() >= BATCH // 2 and moved > 1e-3
  assert err <= 1e-5


def _check_cpu_routing(domain, task_name):
  m, lay, args, kw = _solver_inputs(domain, task_name)
  nk.reset_launches()
  x, f = nk.newton_solve_batched(*[torch.tensor(a) for a in args],
                                 lay=lay, **kw)
  x_p, f_p = nk.newton_solve_plain(*[torch.tensor(a) for a in args],
                                   types=lay.types,
                                   ell_groups=lay.ell_groups, **kw)
  torch.testing.assert_close(x, x_p, rtol=0, atol=0)
  torch.testing.assert_close(f, f_p, rtol=0, atol=0)
  assert nk.LAUNCHES == {'newton_solve_batched': 0, 'newton_solve_ell': 0}


def test_wrapper_routes_cpu_tensors_to_plain():
  _check_cpu_routing('walker', 'walk')


def test_wrapper_routes_elliptic_cpu_tensors_to_plain():
  """finger's elliptic layout on CPU tensors reaches the plain version,
  cone terms included, and launches no kernel."""
  _check_cpu_routing('finger', 'spin')


def test_kernel_limit_matches_source():
  src = (nk.build.CSRC / 'newton_kernel.cu').read_text()
  assert f'constexpr int MAX_NV = {nk.MAX_NV};' in src
  assert f'constexpr int MAX_WARPS = {nk.MAX_WARPS};' in src
  assert f'constexpr int SMEM_LIMIT = {nk.SMEM_LIMIT};' in src


# (nefc, nv, ncg) -> (warps per block, dynamic shared bytes), counted by
# hand from the kernel's carve: per block 2 nefc + 4 ncg words; per warp
# nefc ld + 2 nv ld + 8 nefc + 11 ncg + 4 nv words, ld = nv | 1.
@pytest.mark.parametrize('shape,want', [
    ((62, 9, 0), (4, 4 * (124 + 4 * 1252))),            # walker
    ((105, 3, 34), (4, 4 * (346 + 4 * 1559))),          # finger
    ((200, 32, 0), (4, 4 * (400 + 4 * 10440))),         # nv 32
    ((400, 32, 100), (2, 4 * (1200 + 2 * 19740))),      # two warps fit
    # past LANE_NV J stays in device memory: 2 nv ld + 8 nefc + 11 ncg +
    # 4 nv words per warp
    ((880, 62, 0), (3, 4 * (1760 + 3 * 15100))),        # humanoid_CMU
    ((200, 33, 20), (4, 4 * (480 + 4 * 4130))),         # nv 33
], ids=['walker', 'finger', 'nv32', 'nv32-two-warps', 'humanoid_CMU',
        'nv33'])
def test_launch_config(shape, want):
  warps, smem = nk.launch_config(*shape)
  assert (warps, smem) == want
  assert smem <= nk.SMEM_LIMIT


def test_launch_config_two_dof_family_holds_what_one_lane_per_dof_cannot():
  """humanoid_CMU's layout: with J in shared memory one environment's warp
  would need 282,160 bytes, over a block's 232,448; the two-dofs-per-lane
  family leaves J in device memory and fits three environments per
  block."""
  ld = 62 | 1
  assert 4 * (880 * ld + 2 * 62 * ld + 8 * 880 + 4 * 62) == 282160
  assert 282160 > nk.SMEM_LIMIT
  assert nk.launch_config(880, 62, 0) == (3, 188240)
  assert nk.LANE_NV == 32 and nk.MAX_NV == 64


def test_launch_config_raises_where_one_warp_cannot_fit():
  """A problem past one block's shared memory raises before any launch
  (there is no fallback to the plain version on the card)."""
  nk.reset_launches()
  with pytest.raises(ValueError, match='shared memory'):
    nk.launch_config(3000, 32, 0)
  assert nk.launch_config(1000, 32, 0)[0] == 1       # one warp still fits
  assert sum(nk.LAUNCHES.values()) == 0


def _c_argtypes(name):
  """ctypes argument types of a C entry point, read from its declaration
  in csrc/*.cu: pointers as c_void_p, int and float as themselves."""
  for src in sorted(nk.build.CSRC.glob('*.cu')):
    text = src.read_text()
    head = f'extern "C" int {name}('
    if head in text:
      start = text.index(head) + len(head)
      args = text[start:text.index(')', start)].split(',')
      kinds = []
      for arg in args:
        arg = ' '.join(arg.split())
        if '*' in arg:
          kinds.append(ctypes.c_void_p)
        elif arg.startswith('int '):
          kinds.append(ctypes.c_int)
        else:
          assert arg.startswith('float '), arg
          kinds.append(ctypes.c_float)
      return tuple(kinds)
  raise AssertionError(f'{name} is declared in no source')


@pytest.mark.parametrize('name', sorted(nk.build._SIGNATURES))
def test_c_signature_matches_source(name):
  """build._SIGNATURES, read as text from the sources: a pointer passed as
  a c_int would be cut to 32 bits."""
  assert nk.build._SIGNATURES[name] == _c_argtypes(name)


def _check_kernel_on_card(domain, task_name, kernel, **cut):
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device; chip_smoke.py runs this check there')
  m, lay, args, kw = _solver_inputs(domain, task_name)
  kw = dict(kw, tol=max(kw['tol'], 1e-6), **cut)  # the float32 floor
  dev = [torch.from_numpy(a.astype(np.float32)).cuda() for a in args]
  x_ref, _ = nk.newton_solve_plain(*dev, types=lay.types,
                                   ell_groups=lay.ell_groups, **kw)
  nk.reset_launches()
  x, _ = nk.newton_solve_batched(*dev, lay=lay, **kw)
  assert nk.LAUNCHES[kernel] == 1 and sum(nk.LAUNCHES.values()) == 1
  # scaled by max(1, the lane's largest |ref|), as chip_smoke.py holds it
  lane = x_ref.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
  err = ((x - x_ref).abs() / lane).cpu().numpy()
  assert err.mean() <= 1e-4 and err.max() <= 5e-2
  assert (err.max(axis=1) > 1e-3).sum() <= err.shape[0] // 10


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
  _check_kernel_on_card('walker', 'walk', 'newton_solve_batched')


@pytest.mark.cuda
def test_ell_kernel_matches_plain_on_card():
  """K2-ell on finger's elliptic contacts, with K2's lane-scaled bounds."""
  _check_kernel_on_card('finger', 'spin', 'newton_solve_ell')


@pytest.mark.cuda
def test_ell_kernel_one_newton_step_matches_plain_on_card():
  """K2-ell cut to one Newton iteration with no line search (see
  `one_step`): its Hessian's cone blocks against the plain version's.
  (With a line-search step, float32 rounding decides alpha on the lanes
  whose step is exact; chip_smoke.py holds the other lanes.)"""
  _check_kernel_on_card('finger', 'spin', 'newton_solve_ell', niter=1,
                        ls_iter=0)


@pytest.mark.cuda
@pytest.mark.parametrize('domain,task_name', [('walker', 'walk'),
                                              ('finger', 'spin')],
                         ids=['walker', 'finger'])
def test_kernel_odd_batch_matches_full_batch_on_card(domain, task_name):
  """One warp per environment: the first B - 3 lanes alone (no multiple
  of the warps per block) give the full batch's bits, and two launches on
  the same inputs agree bit for bit."""
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device; chip_smoke.py runs this check there')
  m, lay, args, kw = _solver_inputs(domain, task_name)
  kw = dict(kw, tol=max(kw['tol'], 1e-6))
  dev = [torch.from_numpy(a.astype(np.float32)).cuda() for a in args]
  full = nk.newton_solve_batched(*dev, lay=lay, return_iters=True, **kw)
  again = nk.newton_solve_batched(*dev, lay=lay, return_iters=True, **kw)
  n = BATCH - 3
  part = nk.newton_solve_batched(*[t[:n] for t in dev], lay=lay,
                                 return_iters=True, **kw)
  for x, y, z in zip(full, again, part):
    assert torch.equal(x, y)
    assert torch.equal(x[:n], z)


def test_plain_ell_matches_xla_core_at_stack_4():
  """K2-ell's plain twin at stack_4's layout (nefc 1166, nv 20, 386
  condim-3 cones; over the TPU kernel's VMEM gate, so the JAX package
  solves it in its XLA core) on 4 lanes of its solver inputs, built by the
  JAX package's forward at float64 from states with the boxes on the
  floor and stacked (`test_torch_domains.prop_states`), against that
  core: qacc and forces within 1e-5 scaled, as above, and the lanes take
  Newton steps on their live cones."""
  from test_torch_domains import prop_states
  m = jsuite.build_task('stacker', 'stack_4').model
  lay = jefc.layout(m)
  assert (lay.nefc, m.nv, len(lay.ell_groups[3][0])) == (1166, 20, 386)
  qpos, qvel = prop_states(m, np.random.RandomState(11), 6)
  qpos, qvel = qpos[np.arange(6) % 3 < 2], qvel[np.arange(6) % 3 < 2]
  db = jax.jit(jax.vmap(lambda q, v: jforward.forward(
      m, jforward.make_data(m).replace(qpos=q, qvel=v))))(
          jax.numpy.asarray(qpos), jax.numpy.asarray(qvel))
  args = [np.asarray(x) for x in (
      db.efc_J, db.qM, db.efc_aref, db.efc_D, db.efc_frictionloss,
      db.efc_active.astype(db.qpos.dtype), db.qacc_smooth, db.qacc_smooth)]
  kw = dict(niter=int(m.opt.iterations), ls_iter=12,
            tol=jsolver.effective_tol(float(m.opt.tolerance), db.qpos.dtype),
            meaninertia=float(m.stat_meaninertia or 1.0))
  x_ref, f_ref = jax.jit(jax.vmap(
      lambda *a: jsolver._solve_core_xla(*a, lay=lay, **kw)))(
          *[jax.numpy.asarray(a) for a in args])
  x, f, iters = nk.newton_solve_plain(
      *[torch.tensor(a) for a in args], types=lay.types,
      ell_groups=lay.ell_groups, return_iters=True, **kw)
  cones = args[5][:, lay.ell_groups[3][0][:, 0]].sum(1)
  ex = _scaled_err(x.numpy(), np.asarray(x_ref))
  ef = _scaled_err(f.numpy(), np.asarray(f_ref))
  print(f'K2-ell plain vs XLA core at stack_4: live cones per lane '
        f'{cones.tolist()}, iterations {iters.tolist()}; max scaled err qacc '
        f'{ex:.2e} force {ef:.2e}')
  assert (cones >= 4).all() and (iters >= 1).all()
  assert ex <= 1e-5 and ef <= 1e-5


@functools.lru_cache(maxsize=None)
def _cmu_inputs():
  """humanoid_CMU's solver inputs (nefc 880, nv 62) at 6 lanes lying on
  or pressed into the floor (`test_torch_domains._states`), built by the
  JAX package's forward at float64, warm-started from qacc_smooth."""
  from test_torch_domains import _states
  task = jsuite.build_task('humanoid_CMU', 'run')
  m = task.model
  qpos, qvel, _ = _states('humanoid_CMU-run', task, np.random.RandomState(13))
  qpos, qvel = qpos[:6], qvel[:6]
  db = jax.jit(jax.vmap(lambda q, v: jforward.forward(
      m, jforward.make_data(m).replace(qpos=q, qvel=v))))(
          jax.numpy.asarray(qpos), jax.numpy.asarray(qvel))
  args = [np.asarray(x) for x in (
      db.efc_J, db.qM, db.efc_aref, db.efc_D, db.efc_frictionloss,
      db.efc_active.astype(db.qpos.dtype), db.qacc_smooth, db.qacc_smooth)]
  kw = dict(niter=int(m.opt.iterations), ls_iter=12,
            tol=jsolver.effective_tol(float(m.opt.tolerance), db.qpos.dtype),
            meaninertia=float(m.stat_meaninertia or 1.0))
  return m, jefc.layout(m), args, kw


def test_plain_matches_xla_core_at_humanoid_cmu():
  """The plain twin at humanoid_CMU's layout (nv 62, nefc 880, pyramidal;
  over the TPU kernel's VMEM gate, so the JAX package solves it in its
  XLA core) on 6 lanes lying on the floor (`_cmu_inputs`), against that
  core: qacc and forces within 1e-5 scaled, as above, and every lane takes
  Newton steps on its live rows."""
  m, lay, args, kw = _cmu_inputs()
  assert (lay.nefc, m.nv, lay.ell_groups) == (880, 62, {})
  x_ref, f_ref = jax.jit(jax.vmap(
      lambda *a: jsolver._solve_core_xla(*a, lay=lay, **kw)))(
          *[jax.numpy.asarray(a) for a in args])
  x, f, iters = nk.newton_solve_plain(
      *[torch.tensor(a) for a in args], types=lay.types, return_iters=True,
      **kw)
  ex = _scaled_err(x.numpy(), np.asarray(x_ref))
  ef = _scaled_err(f.numpy(), np.asarray(f_ref))
  live = args[5].sum(1)
  print(f'K2 plain vs XLA core at humanoid_CMU: live rows per lane '
        f'{live.tolist()}, iterations {iters.tolist()}; max scaled err qacc '
        f'{ex:.2e} force {ef:.2e}')
  assert (live >= 20).all() and (iters >= 1).all()
  assert ex <= 1e-5 and ef <= 1e-5


@pytest.mark.cuda
def test_two_dof_kernel_matches_plain_on_card():
  """K2's two-dofs-per-lane family at humanoid_CMU's layout against the
  plain float32 solve, with K2's lane-scaled bounds; past MAX_NV (85
  dofs) the wrapper raises and launches nothing."""
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device; chip_smoke.py runs this check there')
  m, lay, args, kw = _cmu_inputs()
  kw = dict(kw, tol=max(kw['tol'], 1e-6))
  dev = [torch.from_numpy(a.astype(np.float32)).cuda() for a in args]
  x_ref, _ = nk.newton_solve_plain(*dev, types=lay.types, **kw)
  nk.reset_launches()
  x, _ = nk.newton_solve_batched(*dev, lay=lay, **kw)
  assert nk.LAUNCHES['newton_solve_batched'] == 1
  lane = x_ref.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
  err = ((x - x_ref).abs() / lane).cpu().numpy()
  assert err.mean() <= 1e-4 and err.max() <= 5e-2
  wide = [torch.zeros((2, lay.nefc, 85), device='cuda'),
          torch.zeros((2, 85, 85), device='cuda')] + [
              torch.zeros((2, lay.nefc), device='cuda')] * 4 + [
                  torch.zeros((2, 85), device='cuda')] * 2
  with pytest.raises(ValueError, match='1..64'):
    nk.newton_solve_batched(*wide, lay=lay, **kw)
  assert nk.LAUNCHES['newton_solve_batched'] == 1


# -- the cone model: elliptic cones of condim 3, 4 and 6 in one layout ------


@functools.lru_cache(maxsize=None)
def _cone_inputs(copies):
  """The cone model's (`chip_smoke.cones_xml`) solver inputs at BATCH
  lanes of `chip_smoke.cone_states` (every condim's cones live on some
  lanes), built by the JAX package's forward at float64, warm-started
  from qacc_smooth."""
  import chip_smoke
  from dm_control_tpu._src import engine as jengine
  m = jengine.load_model_from_string(chip_smoke.cones_xml(copies))
  qpos, qvel = chip_smoke.cone_states(m, BATCH, np.random.RandomState(3))
  db = jax.jit(jax.vmap(lambda q, v: jforward.forward(
      m, jforward.make_data(m).replace(qpos=q, qvel=v))))(
          jax.numpy.asarray(qpos), jax.numpy.asarray(qvel))
  args = [np.asarray(x) for x in (
      db.efc_J, db.qM, db.efc_aref, db.efc_D, db.efc_frictionloss,
      db.efc_active.astype(db.qpos.dtype), db.qacc_smooth, db.qacc_smooth)]
  kw = dict(niter=int(m.opt.iterations), ls_iter=12,
            tol=jsolver.effective_tol(float(m.opt.tolerance), db.qpos.dtype),
            meaninertia=float(m.stat_meaninertia or 1.0))
  return m, jefc.layout(m), args, kw


@pytest.mark.parametrize('copies,niter,ls_iter,refs', [
    (1, None, 12, ('pallas', 'xla')), (2, None, 12, ('pallas',)),
    (1, 1, 0, ('pallas', 'xla')), (1, 1, 1, ('pallas', 'xla')),
    (2, 1, 1, ('pallas', 'xla'))],
    ids=['x1', 'x2', 'x1-one-step-ls0', 'x1-one-step-ls1', 'x2-one-step-ls1'])
def test_plain_matches_jax_at_cone_model(copies, niter, ls_iter, refs):
  """K2-ell's plain twin at the cone model's layouts (condim-6, -4 and -3
  cones flattened in condim order: one copy nv 18, nefc 48; two nv 36,
  nefc 180) against the Pallas kernel in interpret mode and the XLA core,
  converged and after one Newton iteration of 0 or 1 line-search steps
  (the cone blocks of the Hessian and of the line search's second
  derivative): qacc and forces within 1e-5 scaled, as above; the lanes
  hold live cones of every condim.  Two copies converged: against the
  Pallas kernel alone, the TPU kernel that K2-ell ports.  There the XLA
  core stops on one lane at a higher cost than the Pallas kernel and the
  plain twin, which agree, reach, past 1e-5 from them scaled."""
  m, lay, args, kw = _cone_inputs(copies)
  assert sorted(lay.ell_groups) == [3, 4, 6]
  assert (m.nv, lay.nefc) == ((18, 48) if copies == 1 else (36, 180))
  kw = dict(kw, ls_iter=ls_iter, **({} if niter is None else
                                    dict(niter=niter)))
  for k, (rows, _, _) in lay.ell_groups.items():
    assert args[5][:, rows[:, 0]].any(), f'no live condim-{k} cone'
  jargs = [jax.numpy.asarray(a) for a in args]
  solvers = {'xla': lambda: jax.jit(jax.vmap(
      lambda *a: jsolver._solve_core_xla(*a, lay=lay, **kw)))(*jargs),
             'pallas': lambda: jnk.newton_solve_batched(
                 *jargs, lay=lay, interpret=True, **kw)}
  x, f, iters = nk.newton_solve_plain(
      *[torch.tensor(a) for a in args], types=lay.types,
      ell_groups=lay.ell_groups, return_iters=True, **kw)
  for name in refs:
    x_ref, f_ref = solvers[name]()
    ex = _scaled_err(x.numpy(), np.asarray(x_ref))
    ef = _scaled_err(f.numpy(), np.asarray(f_ref))
    print(f'K2-ell plain vs {name} at the cone model x{copies} (niter '
          f'{kw["niter"]}, ls {ls_iter}, tol {kw["tol"]:.0e}): iterations '
          f'{iters.tolist()}; max scaled err qacc {ex:.2e} force {ef:.2e}')
    assert ex <= 1e-5 and ef <= 1e-5
  assert (iters >= 1).any()
  moved = _scaled_err(x.numpy(), args[6])
  assert moved > 1e-3


@pytest.mark.parametrize('copies', [1, 2], ids=['x1', 'x2'])
def test_stop_gates_hold_two_float32_solves_at_cone_model(copies):
  """`chip_smoke.stop_gates`, which holds K2-ell's converged solves at the
  cone model on the card, holds the JAX package's float32 solve (its XLA
  core) in the kernel's place against the port's plain twin at float32,
  and the other way round, on 256 lanes of `chip_smoke.cone_states`
  whose solver inputs the port builds at float32: the two float32 solves
  leave K2's line (1e-3 lane-scaled from float64) on lanes that differ in
  part, each within BAND bands of the optimum's cost there.  A solve cut
  to one Newton iteration in the kernel's place fails it."""
  import chip_smoke
  from dm_control_tpu._src import engine as jengine
  from dm_control_tpu_torch._src import efc, engine, forward, solver
  m = engine.load_model_from_string(chip_smoke.cones_xml(copies),
                                    device='cpu')
  lay = efc.layout(m)
  jlay = jefc.layout(jengine.load_model_from_string(
      chip_smoke.cones_xml(copies)))
  q, v = chip_smoke.cone_states(m, 256, np.random.RandomState(60))
  d = forward.make_data(m, 256, torch.float32, 'cpu').replace(
      qpos=torch.tensor(q, dtype=torch.float32),
      qvel=torch.tensor(v, dtype=torch.float32))
  d = forward.fwd_acceleration(m, forward.actuation(
      m, forward.step1(m, d, skipsensor=True)))
  args = (d.efc_J, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss,
          d.efc_active.to(torch.float32), d.qacc_smooth, d.qacc_warmstart)
  kw = dict(niter=int(m.opt.iterations), ls_iter=solver.LS_ITERATIONS,
            tol=solver.effective_tol(m.opt.tolerance, torch.float32),
            meaninertia=float(m.stat_meaninertia))
  plain = dict(types=lay.types, ell_groups=lay.ell_groups)
  x_p, _ = nk.newton_solve_plain(*args, **plain, **kw)
  x_64, _ = nk.newton_solve_plain(
      *[a.double() for a in args], **plain,
      **dict(kw, tol=solver.effective_tol(m.opt.tolerance, torch.float64)))
  x_j, _ = jax.jit(jax.vmap(lambda *a: jsolver._solve_core_xla(
      *a, lay=jlay, **kw)))(*[jax.numpy.asarray(a.numpy()) for a in args])
  x_j = torch.tensor(np.asarray(x_j))
  off = [chip_smoke.lane_scaled_err(x.double(), x_64).amax(dim=1) > 1e-3
         for x in (x_p, x_j)]
  print(f'cone model x{copies}: float32 lanes over 1e-3 from float64: port '
        f'{int(off[0].sum())}, JAX package {int(off[1].sum())}, both '
        f'{int((off[0] & off[1]).sum())}')
  assert off[0].any() and off[1].any()
  chip_smoke.stop_gates(f'x{copies} JAX package as the kernel', x_j, x_p,
                        x_64, lay, args)
  chip_smoke.stop_gates(f'x{copies} port as the kernel', x_p, x_j, x_64, lay,
                        args)
  x_1, _ = nk.newton_solve_plain(*args, **plain, **dict(kw, niter=1))
  with pytest.raises(AssertionError):
    chip_smoke.stop_gates(f'x{copies} one iteration as the kernel', x_1,
                          x_p, x_64, lay, args)


def test_cone_tables_flatten_every_condim():
  """The kernel's per-layout tables at the cone model's layout: cones in
  condim order (3, 4, 6), each padded to C = 6 rows with its normal row,
  its row count, mu and the row scales as the layout gives them."""
  m, lay, _, _ = _cone_inputs(1)
  rows, k, mu, s_row = nk.cone_tables(lay)
  assert nk.cone_width(lay) == 6 and rows.shape == (11, 6)
  assert k.tolist() == [3] * 2 + [4] * 6 + [6] * 3
  at = 0
  for cd, (r, mu_g, scale) in sorted(lay.ell_groups.items()):
    n = len(r)
    np.testing.assert_array_equal(rows[at:at + n, :cd], r)
    assert (rows[at:at + n, cd:] == r[:, :1]).all()
    np.testing.assert_allclose(mu[at:at + n], mu_g, rtol=1e-7)
    np.testing.assert_allclose(s_row[r], scale, rtol=1e-7)
    at += n
  finger = jsuite.build_task('finger', 'spin').model
  flay = jefc.layout(finger)
  assert nk.cone_width(flay) == 3
  np.testing.assert_array_equal(nk.cone_tables(flay)[0], flay.ell_groups[3][0])


# (nefc, nv, ncg, cmax) -> (warps per block, dynamic shared bytes) at C =
# 6: per block 2 nefc + 8 ncg words; per warp nefc ld (nv <= 32) + 2 nv ld
# + 8 nefc + 38 ncg + 4 nv words, ld = nv | 1.
@pytest.mark.parametrize('shape,want', [
    ((48, 18, 11, 6), (4, 4 * (184 + 4 * 2470))),         # cone model x1
    ((180, 36, 41, 6), (4, 4 * (688 + 4 * 5806))),        # cone model x2
    ((48, 18, 11, 3), (4, 4 * (140 + 4 * 2173))),         # as if condim 3
    ((1200, 20, 200, 6), (1, 4 * (4000 + 43320))),        # one per block
], ids=['cones-x1', 'cones-x2', 'cones-x1-C3', 'one-per-block'])
def test_launch_config_at_c6(shape, want):
  warps, smem = nk.launch_config(*shape)
  assert (warps, smem) == want
  assert smem <= nk.SMEM_LIMIT


def test_launch_config_largest_condim6_layout():
  """The most condim-6 cones (6 rows each, nothing else) one environment
  per block holds at C = 6: 260 at nv 18 (J in shared memory), 521 at nv
  36 (J in device memory); one more raises."""
  def fits(ncg, nv):
    try:
      nk.launch_config(6 * ncg, nv, ncg, 6)
      return True
    except ValueError:
      return False
  for nv, most in ((18, 260), (36, 521)):
    assert fits(most, nv) and not fits(most + 1, nv), nv
  with pytest.raises(ValueError, match='cmax'):
    nk.launch_config(48, 18, 11, 4)


@pytest.mark.cuda
@pytest.mark.parametrize('copies', [1, 2], ids=['x1', 'x2'])
def test_ell_kernel_matches_plain_on_card_at_cone_model(copies):
  """K2-ell's C = 6 instantiation (condim-3, -4 and -6 cones; one and two
  dofs per lane) against the plain float32 solve, one Newton iteration
  without a line search (the converged solve is float32-limited on some
  lanes of the condim-6 ball: chip_smoke.py holds it with
  `float32_gates`), with K2's lane-scaled bounds."""
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device; chip_smoke.py runs this check there')
  m, lay, args, kw = _cone_inputs(copies)
  kw = dict(kw, tol=max(kw['tol'], 1e-6), niter=1, ls_iter=0)
  dev = [torch.from_numpy(a.astype(np.float32)).cuda() for a in args]
  x_ref, _ = nk.newton_solve_plain(*dev, types=lay.types,
                                   ell_groups=lay.ell_groups, **kw)
  nk.reset_launches()
  x, _ = nk.newton_solve_batched(*dev, lay=lay, **kw)
  assert nk.LAUNCHES == {'newton_solve_batched': 0, 'newton_solve_ell': 1}
  lane = x_ref.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
  err = ((x - x_ref).abs() / lane).cpu().numpy()
  assert err.mean() <= 1e-4 and err.max() <= 5e-2
