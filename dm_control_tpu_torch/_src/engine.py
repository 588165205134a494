"""Engine facade: model loading.

The port of `dm_control_tpu/_src/engine.py`.  `load_model` compiles the
MJCF file with the port's numpy compiler, finalizes the derived constants
in torch on the CPU, and records the device the Model's per-step arrays
are mirrored to (`types.mirror`): CUDA unless the caller passes
`device='cpu'`.  `load_model_from_string` does the same for MJCF text
(the JAX package's counterpart, engine.py:29), and `model_from_root` for
an MJCF tree edited in code (cartpole's extra poles, quadruped's arena,
dog's floor).
Keyword
arguments of either replace fields of the model's `Option` before its
constants are derived (the top-K broadphase settings of humanoid and
quadruped).
"""

from __future__ import annotations

import dataclasses

from dm_control_tpu_torch._src import setconst
from dm_control_tpu_torch._src.types import Model, resolve_device
from dm_control_tpu_torch.mjcf import compiler as _compiler


def _finalize(m: Model, device, opt) -> Model:
  device = resolve_device(device)
  if opt:
    m.opt = dataclasses.replace(m.opt, **opt)
  m = setconst.set_const(m)
  m.device = device
  return m


def load_model(path: str, device=None, **opt) -> Model:
  """Compile an MJCF file and finalize derived constants."""
  return _finalize(_compiler.compile_path(path), device, opt)


def load_model_from_string(xml: str, base_dir: str = '.', device=None,
                           **opt) -> Model:
  """Compile MJCF text (assets and includes resolved against base_dir)
  and finalize derived constants."""
  return _finalize(_compiler.compile_string(xml, base_dir), device, opt)


def model_from_root(root, device=None, base_dir: str = '.', **opt) -> Model:
  """Compile an MJCF element tree (includes already expanded, e.g. by
  `suite.common.load_xml_root`; its mesh files resolved against
  base_dir) and finalize derived constants."""
  return _finalize(_compiler.MJCFCompiler(root, base_dir=base_dir).build(),
                   device, opt)
