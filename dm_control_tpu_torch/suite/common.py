"""Model XML resolution for the Control Suite domains.

The port keeps its own copies of the MJCF files it runs under
`dm_control_tpu_torch/suite/assets/` (one per ported domain and the
common/*.xml they include); `load_xml_root` parses one for procedural
editing (cartpole's n_poles), compiled by `engine.model_from_root`.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

from dm_control_tpu_torch.mjcf import compiler as _compiler

ASSETS_DIR = os.path.join(os.path.dirname(__file__), 'assets')


def model_path(name: str) -> str:
  return os.path.join(ASSETS_DIR, name)


def load_xml_root(name: str) -> ET.Element:
  """Parse a suite model with includes expanded (for procedural editing)."""
  return _compiler._load_xml(model_path(name))
