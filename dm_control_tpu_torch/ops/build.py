"""Build and load the port's CUDA kernels (nvcc + ctypes).

Every `*.cu` file under `dm_control_tpu_torch/csrc/` is compiled for Hopper
(`sm_90a`) by its own `nvcc` process, all started together, and the
objects are linked into one shared library with a plain C interface,
loaded with `ctypes`.  The library lands in `dm_control_tpu_torch/_build/`
under a name keyed by the sources' content, so an edited source rebuilds
and an unchanged one is loaded as it is.

Nothing here runs at import time: the first wrapper call on a CUDA tensor
builds.  A machine without `nvcc` gets a RuntimeError at that call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points: name -> argument types (every one returns cudaError_t)
_SIGNATURES = {
    # (a, l, n, batch, envs, threads, smem_bytes, stream)
    'dmc_cholesky': (_P, _P, _I, _I, _I, _I, _I, _P),
    # (a, b, x, n, batch, envs, threads, smem_bytes, stream)
    'dmc_chol_solve': (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # (l, b, x, n, batch, envs, threads, smem_bytes, stream)
    'dmc_cho_solve': (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # (J, M, aref, D, fl, active, a, warm, types, ell_rows, ell_k, ell_mu,
    #  s_row, x, f, iters, nefc, nv, ncg, cmax, batch, niter, ls_iter, tol,
    #  scale, warps, smem_bytes, stream)
    'dmc_newton_solve': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I,
                         _I, _P),
}

_lib = None
build_log = ''          # nvcc/ptxas output of the last build, as build.log
build_seconds = None    # wall time of that build (None: loaded, not built)


def _nvcc() -> str:
  cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
  for cand in (shutil.which('nvcc'), os.path.join(cuda_home, 'bin', 'nvcc')):
    if cand and os.path.exists(cand):
      return cand
  raise RuntimeError(
      'nvcc not found: the CUDA kernels build only where the CUDA toolkit '
      'is installed')


def _digest(files) -> str:
  h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
  for f in files:
    h.update(f.name.encode())
    h.update(f.read_bytes())
  return h.hexdigest()[:16]


def build() -> Path:
  """Compile csrc/*.cu (one nvcc each, in parallel) into one .so."""
  global build_log, build_seconds
  sources = sorted(CSRC.glob('*.cu'))
  digest = _digest(sources + sorted(CSRC.glob('*.cuh')))
  out = BUILD_DIR / f'libdmc_kernels_{digest}.so'
  if out.exists():
    return out
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  nvcc = _nvcc()
  t0 = time.perf_counter()
  procs = []
  for src in sources:
    obj = BUILD_DIR / f'{src.stem}_{digest}.{os.getpid()}.o'
    cmd = [nvcc, *NVCC_FLAGS, '-c', str(src), '-o', str(obj)]
    procs.append((src, obj, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
  logs, failed = [], []
  for src, _, proc in procs:
    text, _ = proc.communicate()
    logs.append(f'== {src.name}\n{text}')
    if proc.returncode:
      failed.append(src.name)
  build_log = '\n'.join(logs)
  (BUILD_DIR / 'build.log').write_text(build_log)
  if failed:
    raise RuntimeError(f'nvcc failed on {failed}:\n{build_log}')
  tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
  link = subprocess.run(
      [nvcc, '-shared', '-o', str(tmp)] + [str(o) for _, o, _ in procs],
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  for _, obj, _ in procs:
    obj.unlink(missing_ok=True)
  if link.returncode:
    raise RuntimeError(f'nvcc link failed:\n{link.stdout}')
  os.replace(tmp, out)
  build_seconds = time.perf_counter() - t0
  return out


def library() -> ctypes.CDLL:
  """The loaded kernel library, built on first use."""
  global _lib
  if _lib is None:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
      fn = getattr(lib, name)
      fn.argtypes = list(argtypes)
      fn.restype = ctypes.c_int
    _lib = lib
  return _lib


def check(err: int, name: str) -> None:
  """Raise if a C entry point reported a CUDA error (launch refused...)."""
  if err != 0:
    raise RuntimeError(f'{name}: CUDA error {err} at launch')
