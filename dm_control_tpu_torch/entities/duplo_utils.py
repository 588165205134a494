"""Duplo measurement utilities (reference: entities/props/duplo/utils.py).

The port of `dm_control_tpu/entities/duplo_utils.py`.
`separation_displacements` is the analog of the reference's
`measure_separation_force` harness (utils.py:39-95): a welded bottom
brick with a clicked free top brick, pulled upward with a constant force;
the bricks count as separated when the top brick rises more than
`SEP_DISPLACEMENT` above its clicked height within the simulated window.
Force levels run as lanes of one batch, stepped by a loop of
`forward.step`.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np
import torch

from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch._src import forward
from dm_control_tpu_torch.composer import entity as entity_lib
from dm_control_tpu_torch.entities import duplo

TIMESTEP = 0.0005
SEP_DISPLACEMENT = 0.01


def build_pair_scene(stud_radius: float = duplo.STUD_RADIUS,
                     weld_bottom: bool = True, device=None):
  """Floor + bottom brick (welded by default) + free top brick, on
  `device` (the card unless named)."""
  root = ET.Element('mujoco')
  ET.SubElement(root, 'option', dict(timestep=str(TIMESTEP)))
  wb = ET.SubElement(root, 'worldbody')
  ET.SubElement(wb, 'geom', dict(name='floor', type='plane', size='1 1 0.1'))
  entity_lib.attach(root, duplo.duplo_entity(
      'bottom', stud_radius=stud_radius, free=not weld_bottom),
      prefix='bottom')
  entity_lib.attach(root, duplo.duplo_entity(
      'top', stud_radius=stud_radius), prefix='top')
  return engine.load_model_from_string(ET.tostring(root, encoding='unicode'),
                                       device=device)


def clicked_data(m, batch_size: int = 1, dtype=torch.float64,
                 top_prefix='top', bottom_z=0.0):
  """(Data of `batch_size` lanes with the top brick clicked onto the bottom
  one, forward run; the top brick's qpos address)."""
  d = forward.make_data(m, batch_size, dtype, m.device)
  top_q = int(m.jnt_qposadr[m.name2id(
      'joint', f'{top_prefix}/{top_prefix}_root')])
  qpos = d.qpos.clone()
  qpos[:, top_q + 2] = bottom_z + duplo.STACK_DZ
  qpos[:, top_q + 3] = 1.0
  return forward.forward(m, d.replace(qpos=qpos)), top_q


def separation_displacements(stud_radius, forces, sim_seconds=1.0,
                             device=None, dtype=torch.float64):
  """Final rise of the top brick above its clicked height per force."""
  m = build_pair_scene(stud_radius, device=device)
  forces = np.asarray(forces, np.float64)
  d, top_q = clicked_data(m, len(forces), dtype)
  top_b = m.name2id('body', 'top/top')
  xfrc = d.xfrc_applied.clone()
  xfrc[:, top_b, 2] = torch.as_tensor(forces, dtype=dtype, device=m.device)
  d = d.replace(xfrc_applied=xfrc)
  for _ in range(int(round(sim_seconds / TIMESTEP))):
    d = forward.step(m, d)
  return d.qpos[:, top_q + 2].cpu().numpy() - duplo.STACK_DZ
