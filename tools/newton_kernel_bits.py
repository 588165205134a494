"""The Newton kernel's (K2, K2-ell) bits on the same inputs in two checkouts.

Run on a machine with one CUDA device:

    python3 tools/newton_kernel_bits.py make FILE
    (cd OTHER_CHECKOUT && python3 /path/to/tools/newton_kernel_bits.py \\
        solve FILE OUT)
    python3 tools/newton_kernel_bits.py compare FILE OUT [OUT ...]

`make`, from the root of a checkout, draws 4096 lanes of solver inputs at
every layout the kernel took before it took condim-4 and -6 cones
(walker after a 40-step rollout, finger-spin's contact-rich inputs, and
`chip_smoke.impact_states` of cheetah, cartpole, point_mass, ball_in_cup,
swimmer6, humanoid, quadruped, the four manipulator and the two stacker
tasks, humanoid_CMU, quadruped escape and fetch: K2 and its two-dofs-per-
lane family, and K2-ell at its seven condim-3 layouts, one to four
environments per block), solves them
with that checkout's kernel and writes inputs and results to FILE.
`solve` loads FILE and solves the same inputs with the kernel of the
checkout it runs from (its working directory comes first on the import
path), writing qacc, forces and iterations to OUT.  `compare` prints, for
each layout, whether every OUT holds FILE's bits.
"""

import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

BATCH = 4096
TASKS = ('walker-walk', 'finger-spin', 'cheetah-run', 'cartpole-swingup',
         'point_mass-easy', 'ball_in_cup-catch', 'swimmer-swimmer6',
         'humanoid-run', 'quadruped-walk', 'manipulator-bring_ball',
         'manipulator-bring_peg', 'manipulator-insert_ball',
         'manipulator-insert_peg', 'stacker-stack_2', 'stacker-stack_4',
         'humanoid_CMU-run', 'quadruped-escape', 'quadruped-fetch')


def _solver_args(m, d):
  from dm_control_tpu_torch._src import forward
  d = forward.fwd_acceleration(m, forward.actuation(
      m, forward.step1(m, d, skipsensor=True)))
  return [t.contiguous() for t in (
      d.efc_J, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss,
      d.efc_active.to(torch.float32), d.qacc_smooth, d.qacc_warmstart)]


def _solve(what, args):
  from dm_control_tpu_torch import suite
  from dm_control_tpu_torch._src import efc
  from dm_control_tpu_torch._src import solver
  from dm_control_tpu_torch.ops import newton_kernel as nk
  m = suite.build_task(*what.split('-')).model
  kw = dict(niter=int(m.opt.iterations), ls_iter=solver.LS_ITERATIONS,
            tol=solver.effective_tol(m.opt.tolerance, torch.float32),
            meaninertia=float(m.stat_meaninertia))
  out = nk.newton_solve_batched(*[a.cuda() for a in args], lay=efc.layout(m),
                                return_iters=True, **kw)
  torch.cuda.synchronize()
  return [t.cpu() for t in out]


def make(path):
  import chip_smoke as cs
  from dm_control_tpu_torch import suite
  from dm_control_tpu_torch._src import efc
  from dm_control_tpu_torch.parallel import BatchedEnv
  gen = torch.Generator(device='cuda')
  gen.manual_seed(7)
  inputs = {}
  for what in TASKS:
    task = suite.build_task(*what.split('-'))
    m = task.model
    if what == 'walker-walk':
      env = BatchedEnv(task, BATCH)
      d = env.rollout_fn(40)(env.reset(), gen)[0].data
      inputs[what] = _solver_args(m, d)
    elif what == 'finger-spin':
      args, _ = cs.finger_solver_inputs(m, efc.layout(m), BATCH, gen, 'cuda')
      inputs[what] = [a.contiguous() for a in args]
    else:
      inputs[what] = _solver_args(
          m, cs.impact_states(what, m, BATCH, gen, 'cuda'))
  out = {what: _solve(what, args) for what, args in inputs.items()}
  torch.save({'inputs': {k: [a.cpu() for a in v] for k, v in inputs.items()},
              'out': out}, path)
  print(f'wrote {len(inputs)} layouts to {path}')


def solve(path, out_path):
  saved = torch.load(path)
  out = {what: _solve(what, args) for what, args in saved['inputs'].items()}
  torch.save(out, out_path)
  print(f'solved {len(out)} layouts from {path} into {out_path}')


def compare(path, others):
  ref = torch.load(path)['out']
  same = True
  for other in others:
    got = torch.load(other)
    for what, (x, f, it) in ref.items():
      y, g, jt = got[what]
      equal = torch.equal(x, y) and torch.equal(f, g) and torch.equal(it, jt)
      same &= equal
      print(f'{other}: {what} (B={x.shape[0]}, nefc={f.shape[1]}, '
            f'nv={x.shape[1]}): {"same bits" if equal else "DIFFERENT"}'
            + ('' if equal else f', max |dqacc| {(x - y).abs().max():.3g}'))
  print('every layout: same bits' if same else 'some layout differs')
  return 0 if same else 1


def main():
  if not torch.cuda.is_available():
    sys.exit('needs a CUDA device')
  cmd, args = sys.argv[1], sys.argv[2:]
  if cmd == 'make':
    make(*args)
  elif cmd == 'solve':
    solve(*args)
  elif cmd == 'compare':
    return compare(args[0], args[1:])
  else:
    sys.exit(f'unknown command {cmd!r}')
  return 0


if __name__ == '__main__':
  sys.exit(main())
