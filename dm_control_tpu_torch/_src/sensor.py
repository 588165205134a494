"""Sensors: fill Data.sensordata (reference stages mj_sensorPos/Vel/Acc).

The port of `dm_control_tpu/_src/sensor.py` for the sensor types the
walker path reads (`subtreelinvel`).  The stage split is the JAX
package's: rows outside the requested stage keep their previous values.
Every other sensor type raises NotImplementedError.
"""

from __future__ import annotations

import torch

from dm_control_tpu_torch._src import math
from dm_control_tpu_torch._src import tree
from dm_control_tpu_torch._src.types import (Data, DisableBit, Model,
                                             SensorType, mirror)

_ACC_STAGE = (SensorType.TOUCH, SensorType.ACCELEROMETER,
              SensorType.FORCE, SensorType.TORQUE, SensorType.ACTUATORFRC,
              SensorType.FRAMELINACC, SensorType.FRAMEANGACC)


def sensors(m: Model, d: Data, stages: str = 'all') -> Data:
  """Fill sensordata rows for 'posvel', 'acc' or 'all' sensors."""
  if m.nsensordata == 0 or (m.opt.disableflags & DisableBit.SENSOR):
    return d
  selected = []
  for s in range(m.nsensor):
    is_acc = SensorType(int(m.sensor_type[s])) in _ACC_STAGE
    if stages == 'all' or (stages == 'acc') == is_acc:
      selected.append(s)
  if not selected:
    return d

  out = d.sensordata.clone()
  linvel = None
  for s in selected:
    stype = SensorType(int(m.sensor_type[s]))
    objid = int(m.sensor_objid[s])
    adr, dim = int(m.sensor_adr[s]), int(m.sensor_dim[s])
    if stype == SensorType.SUBTREELINVEL:
      if linvel is None:
        linvel = _subtree_linvel(m, d)
      val = linvel[:, objid]
    else:
      raise NotImplementedError(f'sensor {stype.name} is not ported yet')
    cutoff = float(m.sensor_cutoff[s])
    if cutoff > 0:
      val = torch.clamp(val, -cutoff, cutoff)
    out[:, adr:adr + dim] = val.reshape(val.shape[0], dim)
  return d.replace(sensordata=out)


def _subtree_linvel(m: Model, d: Data) -> torch.Tensor:
  """(B, nbody, 3) linear velocity of each body's subtree center of mass."""
  ref = d.qpos
  mass = mirror(m, ref, m.body_mass)
  com = d.subtree_com[:, mirror(m, ref, m.body_rootid)]
  lin = d.cvel[..., 3:] + math.cross(d.cvel[..., :3], d.xipos - com)
  sm = mirror(m, ref, tree.get(m).subtree_mask)
  tot = torch.einsum('bc,Bcx->Bbx', sm, mass[:, None] * lin)
  den = torch.clamp(sm @ mass, min=1e-12)
  return tot / den[:, None]
