"""The reference gate of chip_smoke.py's phase composer, task by task, with
the gated lanes written out for a replay on the CPU.

    python3 tools/composer_reference_lanes.py [--tasks go_to_target-cmu,two_touch]

Run on a machine with one CUDA device, from the root of a checkout.  For
each task (of `chip_smoke.COMPOSER_TASKS`) it makes the states phase
composer gates: the task's BatchedEnvironment at chip_smoke.BATCH lanes,
reset with the phase's seed and stepped its control steps under the
phase's controls, then the gate's REF_LANES lanes and controls (the next
draw of the task's control generator).  It runs `chip_smoke.
reference_gate` on them and prints its verdicts and, where the gate
fails, its reason (phase composer runs the same, so the verdicts are the
phase's), and writes every gated lane's state and control to
chiprun_out/reference_lanes_composer-<task>.npz, the format of
`tools/k1_reference_step.py --dump`, which `python3
tools/reference_step_cpu.py --tasks composer:<task> --states FILE`
replays on the CPU through the port at float32 and float64 and through
the JAX package at float32.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dm_control_tpu_torch._src import forward  # noqa: E402
from dm_control_tpu_torch.ops import build  # noqa: E402
from dm_control_tpu_torch.ops import linalg_kernel as lk  # noqa: E402


def gated_states(what, dev):
  """(env, final carry, gate controls) of task `what` as phase composer
  makes them."""
  i_task = cs.COMPOSER_TASKS.index(what)
  env = cs.composer_env(what, cs.BATCH)
  controls = cs.composer_controls(i_task, env.model.nu, cs.BATCH, dev)
  carry = env.reset(seed=i_task)
  for _ in range(cs.COMPOSER_STEPS.get(what, 5)):
    carry, _ = env.step(carry, controls())
  return env, carry, controls(cs.REF_LANES)


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--tasks', default='go_to_target-cmu')
  args = parser.parse_args()
  if not torch.cuda.is_available():
    sys.exit('needs a CUDA device')
  dev = torch.device('cuda')
  build.library()
  for what in args.tasks.split(','):
    t0 = time.perf_counter()
    env, carry, ctrl = gated_states(what, dev)
    lanes = torch.arange(cs.REF_LANES, device=dev)
    out = {f: x[lanes].cpu().numpy()
           for f, x in forward.state_items(forward.state_of(carry.data))}
    out['ctrl'] = ctrl.cpu().numpy()
    out['lane'] = lanes.cpu().numpy()
    os.makedirs('chiprun_out', exist_ok=True)
    path = f'chiprun_out/reference_lanes_composer-{what}.npz'
    np.savez(path, **out)
    print(f'# {what}: {cs.REF_LANES} gated lanes written to {path}',
          flush=True)
    try:
      cs.reference_gate(what, env.model, carry.data, ctrl, env.n_sub_steps,
                        lk)
      verdict = 'passes'
    except AssertionError as e:
      verdict = f'fails: {e}'
    print(f'# {what}: the gate {verdict} ({time.perf_counter() - t0:.1f} s)',
          flush=True)
    env = carry = None
    torch.cuda.empty_cache()


if __name__ == '__main__':
  main()
