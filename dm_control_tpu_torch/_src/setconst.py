"""Derived model constants computed at qpos0 (reference: mj_setConst).

The port of `dm_control_tpu/_src/setconst.py`.  It runs the port's own
smooth pipeline once, in torch at float64 on the CPU, and writes the
inverse-weight statistics back into the Model.  They scale the
constraint regularizer R = (1-imp)/imp * invweight.
"""

from __future__ import annotations

import numpy as np
import torch

from dm_control_tpu_torch._src import forward as fwd
from dm_control_tpu_torch._src import smooth
from dm_control_tpu_torch._src.types import JointType, Model


def set_const(m: Model) -> Model:
  """Fill dof/body/tendon invweight0, actuator_acc0/length0,
  tendon_length0 and stat_meaninertia."""
  if m.nv == 0:
    return m
  d = fwd.make_data(m, 1, torch.float64, 'cpu')
  d = smooth.kinematics(m, d)
  d = smooth.com_pos(m, d)
  d = smooth.crb(m, d)
  d = smooth.tendon(m, d)
  d = smooth.transmission(m, d)
  qm = d.qM[0]
  minv = torch.linalg.inv(qm)

  m.dof_invweight0 = torch.diagonal(minv).numpy().astype(np.float64)
  # the reference averages dof invweights within ball / free-joint triples
  for j in range(m.njnt):
    jt = JointType(int(m.jnt_type[j]))
    adr = int(m.jnt_dofadr[j])
    if jt == JointType.BALL:
      m.dof_invweight0[adr:adr + 3] = m.dof_invweight0[adr:adr + 3].mean()
    elif jt == JointType.FREE:
      m.dof_invweight0[adr:adr + 3] = m.dof_invweight0[adr:adr + 3].mean()
      m.dof_invweight0[adr + 3:adr + 6] = (
          m.dof_invweight0[adr + 3:adr + 6].mean())

  # body invweights: mean diagonal of J M^-1 J^T at the body com
  biw = []
  for b in range(m.nbody):
    jacp, jacr = smooth.jac(m, d, d.xipos[:, b], b)
    at = torch.trace(jacp[0].T @ minv @ jacp[0]) / 3.0
    ar = torch.trace(jacr[0].T @ minv @ jacr[0]) / 3.0
    biw.append([float(at), float(ar)])
  m.body_invweight0 = np.asarray(biw, np.float64)
  m.tendon_length0 = d.ten_length[0].numpy().astype(np.float64)
  if m.ntendon:
    # the tendon limit and friction-loss rows' regularizer reads it
    m.tendon_invweight0 = torch.einsum(
        'tv,vw,tw->t', d.ten_J[0], minv, d.ten_J[0]).numpy()
  m.actuator_length0 = d.actuator_length[0].numpy().astype(np.float64)
  if m.nu:
    acc = d.actuator_moment[0] @ minv
    m.actuator_acc0 = torch.linalg.vector_norm(acc, dim=-1).numpy()
  # springdamper joints: k = I/(t^2 z^2), d = 2 I/t from the dof inertia
  if m.jnt_springdamper is not None and m.njnt:
    m.jnt_stiffness = np.array(m.jnt_stiffness, np.float64)
    m.dof_damping = np.array(m.dof_damping, np.float64)
    for j in range(m.njnt):
      tau, zeta = m.jnt_springdamper[j]
      if tau <= 0:
        continue
      dadr = int(m.jnt_dofadr[j])
      inertia = 1.0 / max(float(m.dof_invweight0[dadr]), 1e-12)
      m.jnt_stiffness[j] = inertia / (tau * tau * zeta * zeta)
      m.dof_damping[dadr] = 2.0 * inertia / tau

  m.stat_meaninertia = float(torch.trace(qm)) / m.nv
  # any cached layout or device copy saw placeholder values
  m.__dict__.pop('_efc_layout', None)
  m.__dict__.pop('_mirror', None)
  return m
