"""Model XML resolution for the Control Suite domains.

The port keeps its own copies of the MJCF files it runs under
`dm_control_tpu_torch/suite/assets/` (walker.xml and the common/*.xml it
includes).
"""

from __future__ import annotations

import os

ASSETS_DIR = os.path.join(os.path.dirname(__file__), 'assets')


def model_path(name: str) -> str:
  return os.path.join(ASSETS_DIR, name)
