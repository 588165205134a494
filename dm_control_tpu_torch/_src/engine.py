"""Engine facade: model loading.

The port of `dm_control_tpu/_src/engine.py`.  `load_model` compiles the
MJCF file with the port's numpy compiler, finalizes the derived constants
in torch on the CPU, and records the device the Model's per-step arrays
are mirrored to (`types.mirror`): CUDA unless the caller passes
`device='cpu'`.  `model_from_root` does the same for an MJCF tree
edited in code (cartpole's extra poles).
"""

from __future__ import annotations

from dm_control_tpu_torch._src import setconst
from dm_control_tpu_torch._src.types import Model, resolve_device
from dm_control_tpu_torch.mjcf import compiler as _compiler


def load_model(path: str, device=None) -> Model:
  """Compile an MJCF file and finalize derived constants."""
  device = resolve_device(device)
  m = setconst.set_const(_compiler.compile_path(path))
  m.device = device
  return m


def model_from_root(root, device=None) -> Model:
  """Compile an MJCF element tree (includes already expanded, e.g. by
  `suite.common.load_xml_root`) and finalize derived constants."""
  device = resolve_device(device)
  m = setconst.set_const(_compiler.MJCFCompiler(root).build())
  m.device = device
  return m
