"""Whether a slice task's rollout on the card depends on what ran before it
in the process.

    python3 tools/rollout_state_probe.py [--tasks hopper-hop,ball_in_cup-catch,...]

Run on a machine with one CUDA device, from the root of a checkout.  For
each task it runs `chip_smoke.slice_run` (reset and 50 control steps at
4096 lanes, the seeds of chip_smoke.py's last slice run) four times in
one process and compares the final integration states bit for bit
(`forward.state_items`, model_var included) with the first run's:

  repeat   the same run again;
  nan      after filling the caching allocator's free blocks with NaN
           (float32 NaN tensors of 512 B to 1 MiB, then 256 MiB chunks up
           to all but 2 GiB of the card's free memory, freed again), so
           that a read of memory no kernel wrote turns up as a changed or
           non-finite state;
  after    after walker-walk's 40-step rollout and finger-spin's solver
           inputs (chip_smoke.py's phase kernels) and the slice runs of the
           tasks before it in chip_smoke.SLICE_TASKS.

It also prints whether the controls of the task's lanes past
chip_smoke.REF_LANES were the same with the task alone (`--tasks TASK`)
and among every task where `tools/k1_reference_step.py` drew them, as it
did up to the seventh slice, from one generator (seeded REF_SEED + 1)
shared by the tasks in their order; the tool now draws them from a
generator of each task's own (`k1_reference_step.extra_controls`).

Prints the card's name and power limit first.
"""

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from dm_control_tpu_torch import suite  # noqa: E402
from dm_control_tpu_torch._src import efc  # noqa: E402
from dm_control_tpu_torch._src import forward  # noqa: E402
from dm_control_tpu_torch.parallel import BatchedEnv  # noqa: E402

BATCH = 4096
# free device memory the NaN fill leaves to the runs that follow it
SPARE = 2 << 30


def fill_free_with_nan(dev) -> int:
  """Fill the caching allocator's free blocks with float32 NaN: allocate
  small blocks (512 B to 1 MiB, 64 of each size) and 256 MiB chunks until
  SPARE bytes stay free, counting the card's free memory and the blocks
  the allocator holds unused (allocations take those first), then free
  them all (they stay cached, NaN inside).  Returns the bytes written."""
  held = []
  for k in range(9, 21):
    held += [torch.full((2 ** k // 4,), float('nan'), device=dev)
             for _ in range(64)]
  chunk = 256 << 20

  def free():
    return (torch.cuda.mem_get_info(dev)[0] + torch.cuda.memory_reserved(dev)
            - torch.cuda.memory_allocated(dev))

  while free() > SPARE + chunk:
    try:
      held.append(torch.full((chunk // 4,), float('nan'), device=dev))
    except torch.OutOfMemoryError:   # the cached blocks left are too small
      break
  torch.cuda.synchronize()
  return sum(t.numel() * 4 for t in held)


EVERY_TASK = ['walker-walk', 'finger-spin'] + list(cs.SLICE_TASKS)


def shared_extra_controls(tasks, what, dev, lanes=1024):
  """The controls of `what`'s lanes past REF_LANES as one generator
  (seeded REF_SEED + 1) shared by `tasks`, drawn in their order, gives
  them."""
  gen = torch.Generator(device=dev)
  gen.manual_seed(cs.REF_SEED + 1)
  for name in tasks:
    nu = suite.build_task(*name.split('-')).model.nu
    ctrl = torch.rand((lanes - cs.REF_LANES, nu), generator=gen,
                      device=dev) * 2 - 1
    if name == what:
      return ctrl
  raise ValueError(what)


def final_state(what, dev):
  """The task's final integration state after chip_smoke.slice_run of its
  last slice run, {name: tensor}, on the card."""
  i_task = cs.SLICE_TASKS.index(what)
  env = BatchedEnv(suite.build_task(*what.split('-')), BATCH)
  state, rewards, _, _ = cs.slice_run(env, i_task, cs.SLICE_RUN, dev)
  out = dict(forward.state_items(forward.state_of(state.data)))
  out['rewards'] = rewards
  return out


def compare(what, how, ref, out):
  """Print whether `out` equals `ref` bit for bit, item by item."""
  differ = {}
  for k, x in ref.items():
    y = out[k]
    if not torch.equal(x, y):
      finite = bool(torch.isfinite(y).all()) if y.is_floating_point() else True
      gap = ((x.double() - y.double()).abs().max().item()
             if x.is_floating_point() else None)
      differ[k] = (gap, finite)
  print(f'{what}: {how}: '
        + ('bit-identical to the first run' if not differ else
           f'differs from the first run: {differ}'), flush=True)
  return not differ


def earlier_work(what, dev):
  """What chip_smoke.py runs before the task's slice run: the kernel
  phase's walker-walk rollout and finger-spin solver inputs, and the slice
  runs of the tasks before it."""
  gen = torch.Generator(device=dev)
  gen.manual_seed(0)
  env = BatchedEnv(suite.build_task('walker', 'walk'), BATCH)
  env.rollout_fn(40)(env.reset(), gen)
  f_task = suite.build_task('finger', 'spin')
  cs.finger_solver_inputs(f_task.model, efc.layout(f_task.model), BATCH,
                          gen, dev)
  for other in cs.SLICE_TASKS[:cs.SLICE_TASKS.index(what)]:
    final_state(other, dev)


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--tasks', default=','.join(
      ['hopper-hop'] + list(cs.SLICE_TASKS[7:])))
  args = parser.parse_args()
  if not torch.cuda.is_available():
    sys.exit('needs a CUDA device')
  print(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip())
  dev = torch.device('cuda')
  wanted = args.tasks.split(',')
  ok = True
  for what in wanted:
    first = final_state(what, dev)
    ok &= compare(what, 'repeat', first, final_state(what, dev))
    n = fill_free_with_nan(dev)
    ok &= compare(what, f'nan ({n / 2 ** 30:.1f} GiB of freed NaN blocks)',
                  first, final_state(what, dev))
    if what == wanted[0]:
      earlier_work(what, dev)
      ok &= compare(what, 'after the work chip_smoke.py runs before it',
                    first, final_state(what, dev))
  for what in wanted:
    same = torch.equal(shared_extra_controls([what], what, dev),
                       shared_extra_controls(EVERY_TASK, what, dev))
    print(f'{what}: controls of lanes {cs.REF_LANES}-1023 drawn from one '
          f'generator shared in task order, alone and among every task: '
          f'{"the same" if same else "differ"}; from the task\'s own '
          f'generator (k1_reference_step.extra_controls): the same by '
          f'construction')
  print(f'every run bit-identical to its first: {ok}')
  return 0 if ok else 1


if __name__ == '__main__':
  sys.exit(main())
