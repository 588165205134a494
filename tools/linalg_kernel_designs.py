"""Time the K1 kernel's candidate block shapes on the card, in each mode.

    python3 tools/linalg_kernel_designs.py [--sizes 3,9,27,56,96]

Run on a machine with one CUDA device, from the root of a checkout.  For
each n, on B = 4096 SPD matrices and right-hand sides made from a seed on
the card, and for every block shape `launch_config(n, group, warps)`
allows (G = group lanes per environment, warps per block), it launches
`dmc_cholesky` (K1a), `dmc_chol_solve` (K1b) and `dmc_cho_solve` (K1c, on
the plain factor of the same matrices) through their ctypes entries,
holds each result against the plain version (1e-4 scaled by max(1,
|ref|), as `chip_smoke.py`), and times it two ways:

  * launch: CUDA events around 50 back-to-back launches of the ctypes
    entry on pre-made buffers (what `chip_smoke.py` calls kernel_ms; it
    reads the host's issue rate where that is slower than the device);
  * device: the kernel's own device time under torch.profiler, the mean
    over 20 launches (one profiler session per n, its kernel events taken
    in launch order; where their count is not one per launch, the device
    times of that n are not measured).

Prints the card's name and power limit first, then one line per shape
(the one `launch_config(n)` picks marked), then for each n and kernel the
fastest shape by device time and how far the picked one is from it.
"""

import argparse
import os
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from dm_control_tpu_torch.ops import build  # noqa: E402
from dm_control_tpu_torch.ops import linalg_kernel as lk  # noqa: E402

BATCH = 4096
REPS = 20
# each kernel's name in the profiler, demangled or not
KERNELS = {'cholesky_batched': ('k1_kernel<0>', 'k1_kernelILi0E'),
           'chol_solve_batched': ('k1_kernel<1>', 'k1_kernelILi1E'),
           'cho_solve_batched': ('k1_kernel<2>', 'k1_kernelILi2E')}


def shapes(n):
  for group in (1, 2, 4, 8, 16, 32):
    for warps in (1, 2, 4):
      try:
        yield group, warps, lk.launch_config(n, group, warps)
      except ValueError:
        pass                               # the block does not fit


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--sizes', default='3,9,27,56,96')
  sizes = [int(s) for s in parser.parse_args().sizes.split(',')]
  if not torch.cuda.is_available():
    sys.exit('needs a CUDA device')
  print(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip())
  lib = build.library()
  for line in build.build_log.splitlines():
    if 'registers' in line or 'spill' in line or 'Compiling' in line:
      print('#   ' + line.strip())
  dev = torch.device('cuda')
  gen = torch.Generator(device=dev)
  gen.manual_seed(0)
  stream = torch.cuda.current_stream().cuda_stream
  for n in sizes:
    a = torch.randn((BATCH, n, n), generator=gen, device=dev)
    A = a @ a.transpose(1, 2) + n * torch.eye(n, device=dev)
    b = torch.randn((BATCH, n), generator=gen, device=dev)
    L = lk.cholesky_plain(A)
    refs = {'cholesky_batched': L,
            'chol_solve_batched': lk.chol_solve_plain(A, b),
            'cho_solve_batched': lk.cho_solve_plain(L, b)}
    outs = {k: torch.empty_like(v) for k, v in refs.items()}

    def calls(config):
      return {
          'cholesky_batched': lambda: lib.dmc_cholesky(
              A.data_ptr(), outs['cholesky_batched'].data_ptr(), n, BATCH,
              *config, stream),
          'chol_solve_batched': lambda: lib.dmc_chol_solve(
              A.data_ptr(), b.data_ptr(), outs['chol_solve_batched'].data_ptr(),
              n, BATCH, *config, stream),
          'cho_solve_batched': lambda: lib.dmc_cho_solve(
              L.data_ptr(), b.data_ptr(), outs['cho_solve_batched'].data_ptr(),
              n, BATCH, *config, stream)}

    cands = list(shapes(n))
    n_rows = []
    for group, warps, config in cands:
      row = dict(n=n, group=group, warps=warps, envs=config[0],
                 threads=config[1], smem=config[2],
                 blocks=-(-BATCH // config[0]),
                 chosen=config == lk.launch_config(n))
      for k, launch in calls(config).items():
        build.check(launch(), k)
        torch.cuda.synchronize()
        err = cs.scaled_err(outs[k], refs[k]).max().item()
        assert err <= 1e-4, f'{k} n={n} G={group} warps={warps}: {err:.2e}'
        row[k] = dict(err=err, launch_ms=cs.cuda_ms(launch, 50),
                      device_ms=None)
      n_rows.append(row)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      for _, _, config in cands:
        for launch in calls(config).values():
          for _ in range(REPS):
            launch()
      torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if len(events) == len(KERNELS) * REPS * len(cands):
      it = iter(events)
      for row in n_rows:
        for k, kernel in KERNELS.items():
          chunk = [next(it) for _ in range(REPS)]
          assert all(any(v in e.name for v in kernel) for e in chunk), (
              k, chunk[0].name)
          row[k]['device_ms'] = sum(e.device_time for e in chunk) / REPS / 1e3
    else:
      print(f'# n={n}: the profiler kept {len(events)} kernel events of '
            f'{len(KERNELS) * REPS * len(cands)} launches: device times not '
            f'measured')
    for row in n_rows:
      print(f'n={n:2d} G={row["group"]:2d} warps={row["warps"]} '
            f'envs={row["envs"]:3d} threads={row["threads"]:4d} '
            f'smem={row["smem"]:6d} blocks={row["blocks"]:5d}'
            f'{" (chosen)" if row["chosen"] else ""}: '
            + '; '.join(f'{k} device {v["device_ms"]} ms launch '
                        f'{v["launch_ms"]:.6g} ms err {v["err"]:.1e}'
                        for k, v in row.items() if isinstance(v, dict)),
            flush=True)
    for k in KERNELS:
      timed = [r for r in n_rows if r[k]['device_ms'] is not None]
      if not timed:
        continue
      best = min(timed, key=lambda r: r[k]['device_ms'])
      chosen = next(r for r in timed if r['chosen'])
      print(f'n={n:2d} {k}: fastest G={best["group"]} warps={best["warps"]} '
            f'{best[k]["device_ms"]:.6g} ms; picked G={chosen["group"]} '
            f'warps={chosen["warps"]} {chosen[k]["device_ms"]:.6g} ms '
            f'({chosen[k]["device_ms"] / best[k]["device_ms"]:.3f}x)',
            flush=True)


if __name__ == '__main__':
  main()
