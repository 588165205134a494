"""The port's float32 control step against the JAX package's, on the CPU,
over more lanes than tests/test_torch_reference_step.py holds.

    python3 tools/reference_step_cpu.py [--lanes 1024]
        [--tasks walker-walk,finger-spin,cheetah-run,hopper-hop]

Run from the root of a checkout (CPU only; JAX with float64 enabled, as the
test suite runs it).  For each task it draws `--lanes` states as the test
draws its 16 (`run_steps`: numpy, seed 5; at 16 lanes they are the test's)
and runs one control step through the port at float32 and at
float64 and through the JAX package at float32 (XLA core), each recording
its discrete choices and, at float32, where each Newton solve stopped
(`chip_smoke.branches`; the test's tasks, all Euler).  It prints, for
each float32 run against the port's float64, the reference gate's
verdicts (`chip_smoke.lane_verdicts`, with `chip_smoke.stop_distances`),
every lane over REF_TOL with its verdict and what decided it
(`chip_smoke.lane_reason`), and the quantiles of every lane's solve-stop
distance; then the port against the JAX package on the lanes where the two
made the same choices (quantiles, lanes above 1e-3 and REF_TOL, largest).

Then, for every lane over REF_TOL with matched choices in the port's run,
it takes the port's float32 solver inputs of the first substep (the one
substep whose inputs both float32 runs share up to rounding) and solves
them three ways: the port's plain Newton solve at float32, the JAX
package's XLA core at float32, and the port's at float64 to 1e-10 (the
optimum of those inputs).  It prints each float32 solve's distance from
that optimum and from the other (scaled by max(1, |optimum|)), their
iteration counts, and the cost at the optimum with its float32 spacing:
a float32 solve stops where a step's cost change is below that spacing.

With `--states FILE` (lanes written on the card by
`tools/k1_reference_step.py --dump`, or by
`tools/composer_reference_lanes.py` for a composer task, named
`composer:<task>`, or by `chip_smoke.py`'s phase manipulation for an
ungated manipulation task, named `manipulation:<task>`; one task in
`--tasks`) it replays
instead one control step of those lanes from their card states (their
qacc_warmstart included) through the port at float32 and at float64 and
through the JAX package at float32, and prints for each lane and run its
error against the port's float64, the gate's verdict with what decided
it, and at every acc stage the largest lane-scaled difference of its
qacc from float64's.  An RK4 model's lanes (the manipulation tier) are
replayed through the port at float32 (with its verdicts) and float64 and
through the JAX package's `substeps` at float32 and float64, each lane's
error against the port's float64 printed.
"""

import argparse
import contextlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, 'tests')]
os.environ['JAX_PLATFORMS'] = 'cpu'

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import test_torch_reference_step as ref_step  # noqa: E402
from dm_control_tpu import suite as jsuite  # noqa: E402
from dm_control_tpu._src import efc as jefc  # noqa: E402
from dm_control_tpu._src import forward as jforward  # noqa: E402
from dm_control_tpu._src import solver as jsolver  # noqa: E402
from dm_control_tpu_torch import suite  # noqa: E402
from dm_control_tpu_torch._src import efc  # noqa: E402
from dm_control_tpu_torch._src import forward  # noqa: E402
from dm_control_tpu_torch._src import solver  # noqa: E402
from dm_control_tpu_torch._src.types import Integrator  # noqa: E402
from dm_control_tpu_torch.ops import newton_kernel as nk  # noqa: E402


def quantiles(x):
  q = torch.quantile(x.double(), torch.tensor([0.5, 0.9, 0.99, 1.0],
                                              dtype=torch.float64))
  return ', '.join(f'{k} {v:.3g}' for k, v in zip(('median', 'p90', 'p99',
                                                   'max'), q.tolist()))


def first_acc_stage(pm, d, ctrl, n_sub):
  """The Data into and out of the first substep's acc stage of the port's
  float32 step of all of `d`'s lanes."""
  caught = []
  with cs.recording(lambda before, after, _: caught.append((before, after))):
    cs.one_step(pm, d, slice(0, ctrl.shape[0]), ctrl, n_sub, torch.float32,
                'cpu')
  return caught[0]


def cost(pm, lay, args, x):
  """The solve's cost at x (float64), as `chip_smoke.branches` forms it."""
  J, M, aref, D, fl, active, a = args
  types = torch.as_tensor(lay.types)
  jar = torch.einsum('buv,bv->bu', J, x) - aref
  _, _, c = nk._diag_terms(jar, D, fl, active, types == efc.EQUALITY,
                           types == efc.FRICTION, types == efc.ONESIDED)
  groups = nk._ell_groups(lay.ell_groups, J.device, J.dtype)
  if groups:
    c = c + nk._ell_terms(jar, D, active, groups)[1]
  xa = x - a
  return 0.5 * (xa * torch.einsum('buv,bv->bu', M, xa)).sum(-1) + c


def stalls(what, pm, d, ctrl, n_sub, lanes):
  """The first substep's solve of `lanes`, three ways (module docstring)."""
  domain, task_name = what.split('-')
  jm = jsuite.build_task(domain, task_name).model
  lay, jlay = efc.layout(pm), jefc.layout(jm)
  idx = torch.tensor(lanes)
  before, out = first_acc_stage(pm, d, ctrl, n_sub)
  args = [t[idx].to(torch.float32) for t in (
      out.efc_J, out.qM, out.efc_aref, out.efc_D, out.efc_frictionloss,
      out.efc_active, out.qacc_smooth)]
  warm = before.qacc_warmstart[idx].to(torch.float32)
  kw = dict(types=lay.types, ell_groups=lay.ell_groups, ls_iter=12,
            niter=max(int(pm.opt.iterations), 1),
            meaninertia=float(pm.stat_meaninertia or 1.0), return_iters=True)
  x32, _, it32 = nk.newton_solve_plain(
      *args, warm, tol=solver.effective_tol(pm.opt.tolerance, torch.float32),
      **kw)
  args64 = [t.double() for t in args]
  x64, _, it64 = nk.newton_solve_plain(*args64, warm.double(),
                                       **{**kw, 'niter': 100}, tol=1e-10)
  core = lambda *a: jsolver._solve_core_xla(
      *a, lay=jlay, niter=max(int(jm.opt.iterations), 1), ls_iter=12,
      tol=jsolver.effective_tol(float(jm.opt.tolerance), jnp.float32),
      meaninertia=float(jm.stat_meaninertia or 1.0), return_iters=True)
  xj, _, itj = jax.jit(jax.vmap(core))(
      *[jnp.asarray(t.numpy()) for t in args + [warm]])
  xj = torch.tensor(np.asarray(xj, np.float64))
  scale = x64.abs().clamp(min=1.0)
  off = lambda x, y: ((x.double() - y) / scale).abs().amax(dim=1)
  c64 = cost(pm, lay, args64, x64)
  for i, lane in enumerate(lanes):
    print(f'{what}: lane {lane}, substep 0 solve: port float32 '
          f'{off(x32, x64)[i]:.3g} from the float64 optimum of its inputs '
          f'({int(it32[i])} iterations), the JAX package\'s float32 '
          f'{off(xj, x64)[i]:.3g} ({int(np.asarray(itj)[i])}), the two '
          f'{off(x32, xj)[i]:.3g} apart (float64 {int(it64[i])}); cost at '
          f'the optimum {c64[i]:.6g}, its float32 spacing '
          f'{cs.EPS32 * abs(c64[i].item()):.3g}', flush=True)


def stage_qaccs(pm, d, ctrl, n_sub, dtype):
  """qacc of every acc stage of the port's control step of d's lanes."""
  seen = []
  with cs.recording(lambda before, after, _: seen.append(after.qacc.double())):
    cs.one_step(pm, d, slice(0, ctrl.shape[0]), ctrl, n_sub, dtype, 'cpu')
  return seen


def models(what):
  """(port Model on the CPU, physics substeps per control step, JAX
  Model) of suite task `what` or composer task `composer:<task>`."""
  if what.startswith('manipulation:'):
    import test_torch_manipulation as manip
    jtask, task = manip._task_pair(what.split(':')[1])
    pm = task.model
    n_sub = max(1, int(round(task.control_timestep / pm.opt.timestep)))
    return pm, n_sub, jtask.model
  if what.startswith('composer:'):
    import test_torch_locomotion as loco
    name = what.split(':')[1]
    case = {'go_to_target-ant': 'go_to_target-ant',
            'go_to_target-cmu': 'go_to_target-cmu',
            'go_to_target-jumping_ball': 'go_to_target-jumping_ball',
            'run_through_corridor': 'run_through_corridor-empty',
            'random_goal_maze': 'random_goal_maze', 'escape': 'escape',
            'two_touch': 'two_touch'}[name]
    jtask, task = loco._task_pair(case)
    pm = task.model
    n_sub = max(1, int(round(task.control_timestep / pm.opt.timestep)))
    return pm, n_sub, jtask.model
  domain, task_name = what.split('-')
  task = suite.build_task(domain, task_name, device='cpu')
  return (task.model, task.n_sub_steps(),
          jsuite.build_task(domain, task_name).model)


def _jax_substeps(jm, n_sub, z, dtype):
  """qpos and qvel after the JAX package's control step (`substeps`, RK4
  or Euler as the model says) of the lanes in npz `z` at `dtype`."""
  d0 = jforward.make_data(jm, dtype)
  cast = lambda x: jnp.asarray(x, dtype)

  def one(q, v, u, w, mv):
    d = d0.replace(qpos=q, qvel=v, ctrl=u, qacc_warmstart=w, model_var=mv)
    d = jforward.substeps(jm, d, n_sub)
    return d.qpos, d.qvel

  mv = {k.split('.', 1)[1]: (cast(z[k]) if z[k].dtype.kind == 'f'
                             else jnp.asarray(z[k]))
        for k in z.files if k.startswith('model_var.')}
  # at float32 with 64-bit mode off, as on the TPU: under it the JAX
  # package's rk4 weights (numpy float64) promote a float32 step's state
  ctx = (jax.enable_x64(False) if dtype == jnp.float32
         else contextlib.nullcontext())
  with ctx:
    q, v = jax.jit(jax.vmap(one))(cast(z['qpos']), cast(z['qvel']),
                                  cast(z['ctrl']), cast(z['qacc_warmstart']),
                                  mv)
  return {'qpos': torch.tensor(np.asarray(q, np.float64)),
          'qvel': torch.tensor(np.asarray(v, np.float64))}


def replay_rk4(what, pm, n_sub, jm, z, d, ctrl):
  """One control step of an RK4 model's lanes (four acc stages per
  physics step, which `_jax_step` does not record): the port at float32
  (its gate verdict per lane) and the JAX package at float32 and at
  float64, each against the port's float64."""
  n = ctrl.shape[0]
  jruns = {name: _jax_substeps(jm, n_sub, z, dt)
           for name, dt in (('jax float32', jnp.float32),
                            ('jax float64', jnp.float64))}
  try:
    runs = {str(dt).split('.')[1]: cs.one_step(
        pm, d, slice(0, n), ctrl, n_sub, dt, 'cpu', record=True)
        for dt in (torch.float32, torch.float64)}
  except AssertionError as e:
    # the gate records no choices of a top-K box-mesh group (reassemble_5)
    print(f'{what}: the gate cannot record this model\'s choices ({e}); '
          f'errors only', flush=True)
    runs = {str(dt).split('.')[1]: cs.one_step(
        pm, d, slice(0, n), ctrl, n_sub, dt, 'cpu')
        for dt in (torch.float32, torch.float64)}
  ref = runs['float64']
  err = ref_step._lane_err(runs['float32'], ref)
  verdicts = reasons = [''] * n
  if 'branches' in ref:
    first = cs.first_differences(runs['float32']['branches'],
                                 ref['branches'], n)
    stops = cs.stop_distances(runs['float32']['branches'])
    verdicts = cs.lane_verdicts(err, first, cs.BAND, stops)
    reasons = [': ' + cs.lane_reason(f, s) for f, s in zip(first, stops)]
  jerr = {name: ref_step._lane_err(run, ref) for name, run in jruns.items()}
  for i in range(n):
    print(f'{what}: lane {z["lane"][i]}: port float32 vs the port\'s '
          f'float64 {err[i].item():.3g} {verdicts[i]}{reasons[i]}; '
          + ', '.join(f'{k} {e[i].item():.3g}' for k, e in jerr.items()),
          flush=True)
  for k, e in [('port float32', err)] + list(jerr.items()):
    print(f'{what}: {k} vs the port\'s float64 over {n} lanes: '
          f'{quantiles(e)}; over {cs.REF_TOL:g} {int((e > cs.REF_TOL).sum())}',
          flush=True)


def replay(what, path):
  """One control step of the lanes in `path` (module docstring)."""
  pm, n_sub, jm = models(what)
  z = np.load(path)
  ctrl = torch.tensor(z['ctrl'], dtype=torch.float64)
  n = ctrl.shape[0]
  st = {k: torch.tensor(z[k]) for k in z.files if k not in ('ctrl', 'lane')}
  cast = lambda x: x.double() if x.is_floating_point() else x
  d = forward.make_data(pm, n, torch.float64, 'cpu').replace(
      model_var={k.split('.', 1)[1]: cast(x) for k, x in st.items()
                 if k.startswith('model_var.')},
      **{k: cast(x) for k, x in st.items() if '.' not in k})
  if pm.opt.integrator == Integrator.RK4:
    replay_rk4(what, pm, n_sub, jm, z, d, ctrl)
    return
  runs = {str(dt).split('.')[1]: cs.one_step(
      pm, d, slice(0, n), ctrl, n_sub, dt, 'cpu', record=True)
      for dt in (torch.float32, torch.float64)}
  qaccs = {str(dt).split('.')[1]: stage_qaccs(pm, d, ctrl, n_sub, dt)
           for dt in (torch.float32, torch.float64)}
  jq, jv, ja, (warm, after) = ref_step._jax_step(
      jm, n_sub, z['qpos'], z['qvel'], z['ctrl'], warm=z['qacc_warmstart'],
      act=z['act'] if pm.na else None,
      model_var={k.split('.', 1)[1]: z[k] for k in z.files
                 if k.startswith('model_var.')})
  runs['jax float32'] = {
      'qpos': torch.tensor(np.asarray(jq, np.float64)),
      'qvel': torch.tensor(np.asarray(jv, np.float64)),
      'branches': ref_step._jax_branches(pm, warm, after, n_sub)}
  if pm.na:
    runs['jax float32']['act'] = torch.tensor(np.asarray(ja, np.float64))
  qaccs['jax float32'] = [torch.tensor(np.asarray(after.qacc, np.float64)[:, s])
                          for s in range(n_sub)]
  ref = runs['float64']
  for name in ('float32', 'jax float32'):
    err = ref_step._lane_err(runs[name], ref)
    first = cs.first_differences(runs[name]['branches'], ref['branches'], n)
    stops = cs.stop_distances(runs[name]['branches'])
    verdicts = cs.lane_verdicts(err, first, cs.BAND, stops)
    for i in range(n):
      off = [cs.lane_scaled_err(q[i:i + 1], r[i:i + 1]).max().item()
             for q, r in zip(qaccs[name], qaccs['float64'])]
      stop = [cs.stop_distances([b])[i].item()
              for b in runs[name]['branches']]
      print(f'{what}: lane {z["lane"][i]}, '
            f'{name} vs the port\'s float64: error {err[i].item():.3g} '
            f'{verdicts[i]}: {cs.lane_reason(first[i], stops[i])}; by acc '
            f'stage, qacc off float64\'s (lane-scaled) '
            + ', '.join(f'{x:.3g}' for x in off) + '; solve stop (x EPS32 x '
            'scale) ' + ', '.join(f'{x:.3g}' for x in stop), flush=True)


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--lanes', type=int, default=1024)
  parser.add_argument('--tasks',
                      default='walker-walk,finger-spin,cheetah-run,hopper-hop')
  parser.add_argument('--states', default='')
  args = parser.parse_args()
  if args.states:
    replay(args.tasks, args.states)
    return
  for what in args.tasks.split(','):
    runs, pm, d, ctrl = ref_step.run_steps(what, args.lanes)
    ref = runs['float64']
    matched_misses = []
    for name in ('float32', 'jax float32'):
      err = ref_step._lane_err(runs[name], ref)
      first = cs.first_differences(runs[name]['branches'], ref['branches'])
      stops = cs.stop_distances(runs[name]['branches'])
      verdicts = cs.lane_verdicts(err, first, cs.BAND, stops)
      misses = [i for i, (e, f) in enumerate(zip(err.tolist(), first))
                if e > cs.REF_TOL and f is None]
      if name == 'float32':
        matched_misses = misses
      print(f'{what}, {args.lanes} lanes, {name} vs the port\'s float64: '
            f'verdicts '
            + ', '.join(f'{v} {verdicts.count(v)}'
                        for v in ('held', 'excused', 'failed'))
            + f'; over {cs.REF_TOL:g} with every choice matched: '
            f'{[(i, round(err[i].item(), 5)) for i in misses]}; solve stop '
            f'(x EPS32 x scale) {quantiles(stops)}', flush=True)
      for i in torch.nonzero(err > cs.REF_TOL).flatten().tolist():
        print(f'  {name}: lane {i} error {err[i].item():.3g} {verdicts[i]}: '
              f'{cs.lane_reason(first[i], stops[i])}', flush=True)
    port, jax32 = runs['float32'], runs['jax float32']
    same = torch.tensor([f is None for f in cs.first_differences(
        port['branches'], jax32['branches'])])
    err = ref_step._lane_err(port, jax32)[same]
    print(f'{what}: port vs JAX, both float32, {int(same.sum())} lanes with '
          f'the same choices: {quantiles(err)}; above 1e-3 '
          f'{int((err > 1e-3).sum())}, above {cs.REF_TOL:g} '
          f'{int((err > cs.REF_TOL).sum())}', flush=True)
    if matched_misses:
      n_sub = suite.build_task(*what.split('-'), device='cpu').n_sub_steps()
      stalls(what, pm, d, ctrl, n_sub, matched_misses)


if __name__ == '__main__':
  main()
