"""Forward dynamics pipeline + Euler integrator: the engine's `step`.

The port of `dm_control_tpu/_src/forward.py`, batch-first.  `step` and
`substeps` keep the JAX package's stage order (step2-then-step1 bracketing,
the standard order inside `substeps`, the n <= 1 self-sync) so that the
trajectories agree step for step.  `jax.lax.scan` becomes a Python loop.
The integrators are semi-implicit Euler and RK4, whose three inner stages
run the whole pipeline without sensors (`_forward_core`), as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from dm_control_tpu_torch._src import math
from dm_control_tpu_torch._src import smooth
from dm_control_tpu_torch._src import tree
from dm_control_tpu_torch._src.types import (
    BiasType, Contact, Data, DisableBit, DynType, GainType, Integrator,
    Model, mirror)


# ---------------------------------------------------------------------------
# Data construction.
# ---------------------------------------------------------------------------


def make_data(m: Model, batch_size: int, dtype: torch.dtype,
              device) -> Data:
  """Fresh Data of `batch_size` environments at qpos0 (derived fields
  zeroed; call forward to fill)."""
  nq, nv, nu, na = m.nq, m.nv, m.nu, m.na
  nbody, ngeom, nsite = m.nbody, m.ngeom, m.nsite
  ncon, nefc = contact_capacity(m)
  B = batch_size

  def z(*s):
    return torch.zeros((B,) + s, dtype=dtype, device=device)

  def zi(value, *s):
    return torch.full((B,) + s, value, dtype=torch.int32, device=device)

  qpos = torch.as_tensor(m.qpos0, dtype=dtype, device=device)
  return Data(
      time=z(), qpos=qpos.expand(B, nq).clone(),
      qvel=z(nv), act=z(na), ctrl=z(nu),
      qfrc_applied=z(nv), xfrc_applied=z(nbody, 6),
      xpos=z(nbody, 3), xquat=z(nbody, 4), xmat=z(nbody, 3, 3),
      xipos=z(nbody, 3), ximat=z(nbody, 3, 3),
      geom_xpos=z(ngeom, 3), geom_xmat=z(ngeom, 3, 3),
      site_xpos=z(nsite, 3), site_xmat=z(nsite, 3, 3),
      xanchor=z(m.njnt, 3), xaxis=z(m.njnt, 3),
      subtree_com=z(nbody, 3), cinert=z(nbody, 10),
      cdof=z(nv, 6), cdof_dot=z(nv, 6), cvel=z(nbody, 6),
      qM=z(nv, nv), qLD=z(nv, nv),
      ten_length=z(m.ntendon), ten_velocity=z(m.ntendon),
      ten_J=z(m.ntendon, nv),
      actuator_length=z(nu), actuator_velocity=z(nu),
      actuator_moment=z(nu, nv), actuator_force=z(nu), act_dot=z(na),
      qfrc_bias=z(nv), qfrc_spring=z(nv), qfrc_damper=z(nv),
      qfrc_gravcomp=z(nv), qfrc_fluid=z(nv), qfrc_passive=z(nv),
      qfrc_actuator=z(nv), qfrc_smooth=z(nv), qacc_smooth=z(nv),
      qfrc_constraint=z(nv), qacc=z(nv), qacc_warmstart=z(nv),
      contact=Contact(
          dist=torch.full((B, ncon), 1e10, dtype=dtype, device=device),
          pos=z(ncon, 3), frame=z(ncon, 3, 3), includemargin=z(ncon),
          friction=z(ncon, 5), solref=z(ncon, 2), solimp=z(ncon, 5),
          geom1=zi(-1, ncon), geom2=zi(-1, ncon),
          body1=zi(0, ncon), body2=zi(0, ncon), dim=zi(3, ncon)),
      efc_J=z(nefc, nv), efc_pos=z(nefc), efc_margin=z(nefc),
      efc_D=z(nefc), efc_aref=z(nefc), efc_frictionloss=z(nefc),
      efc_force=z(nefc),
      efc_active=torch.zeros((B, nefc), dtype=torch.bool, device=device),
      sensordata=z(m.nsensordata),
      energy=z(2),
      diverged=torch.zeros((B,), dtype=torch.bool, device=device),
      model_var={},
  )


def contact_capacity(m: Model):
  """(max contacts, max constraint rows): the static padding sizes, both
  read from the one static efc layout."""
  from dm_control_tpu_torch._src import collision
  from dm_control_tpu_torch._src import efc
  return collision.count_max_contacts(m), efc.layout(m).nefc


# ---------------------------------------------------------------------------
# Passive forces (reference stage: mj_passive).
# ---------------------------------------------------------------------------


def _body_jacs(m: Model, d: Data):
  """Translational/rotational Jacobians at every body's xipos,
  (B, nbody, nv, 3) each."""
  ref = d.qpos
  mask = mirror(m, ref, m.body_dof_mask)[..., None]          # (nbody, nv, 1)
  offset = d.xipos - d.subtree_com[:, mirror(m, ref, m.body_rootid)]
  cdof_ang, cdof_lin = d.cdof[..., :3], d.cdof[..., 3:]
  jacp = cdof_lin[:, None] + math.cross(cdof_ang[:, None],
                                        offset[:, :, None, :])
  return jacp * mask, cdof_ang[:, None] * mask


def passive(m: Model, d: Data) -> Data:
  """Joint and tendon springs and dampers, and fluid forces (the
  inertia-box model).  Gravity compensation and ball/free joint springs
  are not ported yet and raise."""
  ref = d.qpos
  B = ref.shape[0]
  z = ref.new_zeros((B, m.nv))
  if (m.opt.disableflags & DisableBit.PASSIVE == DisableBit.PASSIVE
      or m.nv == 0):
    return d.replace(qfrc_spring=z, qfrc_damper=z, qfrc_passive=z,
                     qfrc_gravcomp=z, qfrc_fluid=z)
  tr = tree.get(m)
  if m.body_gravcomp is not None and np.any(m.body_gravcomp > 0):
    raise NotImplementedError('gravity compensation is not ported yet')

  qfrc_spring = z
  if not m.opt.disableflags & DisableBit.SPRING:
    stiff = m.jnt_stiffness
    if any(stiff[j] != 0 for j in list(tr.ball_jids) + list(tr.free_jids)):
      raise NotImplementedError('ball/free joint springs are not ported yet')
    hs = tr.hs_jids[stiff[tr.hs_jids] > 0] if len(tr.hs_jids) else tr.hs_jids
    if len(hs):
      qpos_spring = smooth.mparam(m, d, 'qpos_spring')
      qadr = mirror(m, ref, m.jnt_qposadr[hs])
      k = mirror(m, ref, stiff[hs])
      qfrc_spring = z.clone()
      qfrc_spring[:, mirror(m, ref, m.jnt_dofadr[hs])] += (
          -k * (d.qpos[:, qadr] - qpos_spring[..., qadr]))
    # tendon springs with a deadband [lo, hi]; an unset lengthspring (< 0)
    # is the tendon's length at qpos0
    tsel = (np.flatnonzero(m.tendon_stiffness > 0) if m.ntendon
            else np.zeros(0, np.int64))
    if len(tsel):
      lo = m.tendon_lengthspring[tsel, 0].copy()
      hi = m.tendon_lengthspring[tsel, 1].copy()
      unset = lo < 0
      l0 = np.asarray(m.tendon_length0)[tsel]
      lo[unset] = l0[unset]
      hi[unset] = l0[unset]
      lo, hi = mirror(m, ref, lo), mirror(m, ref, hi)
      length = d.ten_length[:, mirror(m, ref, tsel)]
      disp = torch.where(length > hi, hi - length,
                         torch.where(length < lo, lo - length, 0.0))
      qfrc_spring = qfrc_spring + torch.einsum(
          'Btv,Bt->Bv', d.ten_J[:, mirror(m, ref, tsel)],
          mirror(m, ref, m.tendon_stiffness[tsel]) * disp)

  qfrc_damper = z
  if not m.opt.disableflags & DisableBit.DAMPER:
    qfrc_damper = -mirror(m, ref, m.dof_damping) * d.qvel
    tsel = (np.flatnonzero(m.tendon_damping > 0) if m.ntendon
            else np.zeros(0, np.int64))
    if len(tsel):
      t = mirror(m, ref, tsel)
      qfrc_damper = qfrc_damper - torch.einsum(
          'Btv,Bt->Bv', d.ten_J[:, t],
          mirror(m, ref, m.tendon_damping[tsel]) * d.ten_velocity[:, t])

  qfrc_passive = qfrc_spring + qfrc_damper
  qfrc_fluid = z
  if m.opt.viscosity > 0 or m.opt.density > 0:
    qfrc_fluid = _inertia_box_fluid(m, d)
    qfrc_passive = qfrc_passive + qfrc_fluid
  return d.replace(qfrc_spring=qfrc_spring, qfrc_damper=qfrc_damper,
                   qfrc_gravcomp=z, qfrc_fluid=qfrc_fluid,
                   qfrc_passive=qfrc_passive)


def _fluid_boxes(m: Model):
  """(box half-sizes (nbody, 3), 1 for bodies the fluid acts on): the
  box of each body's principal inertia, its sides clamped at sqrt(1e-12
  x 3 / 2m); the world and massless bodies take none."""
  mass = np.asarray(m.body_mass)
  inert = np.asarray(m.body_inertia)
  safe_mass = np.maximum(mass, 1e-12)
  box = np.sqrt(np.maximum(1e-12, np.stack([
      inert[:, 1] + inert[:, 2] - inert[:, 0],
      inert[:, 0] + inert[:, 2] - inert[:, 1],
      inert[:, 0] + inert[:, 1] - inert[:, 2]], axis=1))
      * 3.0 / (2.0 * safe_mass[:, None]))
  return box, ((mass > 0) & (np.arange(m.nbody) > 0)).astype(np.float64)


def _inertia_box_fluid(m: Model, d: Data) -> torch.Tensor:
  """(B, nv) viscous and quadratic-drag fluid forces of the equivalent
  inertia-box model, batched over bodies: each body's com velocity in its
  inertial frame, less the wind, gives a linear (3 pi mu diam v, and 0.5
  rho area |v| v) and an angular drag, rotated back to the world and
  applied at xipos."""
  ref = d.qpos
  viscosity = float(m.opt.viscosity)
  density = float(m.opt.density)
  box_np, has_mass = _fluid_boxes(m)
  box = mirror(m, ref, box_np)
  offset = d.xipos - d.subtree_com[:, mirror(m, ref, m.body_rootid)]
  rot = d.ximat.transpose(-1, -2)
  lvel6 = math.transform_motion(d.cvel, offset, rot)         # (B, nbody, 6)
  ang, lin = lvel6[..., :3], lvel6[..., 3:]
  lin = lin - torch.einsum('Bbij,j->Bbi', rot,
                           mirror(m, ref, np.asarray(m.opt.wind, np.float64)))
  frc = torch.zeros_like(lin)
  trq = torch.zeros_like(ang)
  if viscosity > 0:
    diam = box.sum(-1) * 2.0 / 3.0
    frc = frc - 3.0 * np.pi * viscosity * diam[:, None] * lin
    trq = trq - np.pi * viscosity * (diam ** 3)[:, None] * ang
  if density > 0:
    area = 4.0 * torch.stack([box[:, 1] * box[:, 2], box[:, 0] * box[:, 2],
                              box[:, 0] * box[:, 1]], dim=1)
    frc = frc - 0.5 * density * area * lin.abs() * lin
    b4 = box ** 4
    coef = torch.stack([box[:, 0] * (b4[:, 1] + b4[:, 2]),
                        box[:, 1] * (b4[:, 0] + b4[:, 2]),
                        box[:, 2] * (b4[:, 0] + b4[:, 1])], dim=1)
    trq = trq - 0.5 * density * coef * ang.abs() * ang
  on = mirror(m, ref, has_mass)[:, None]
  frc_w = math.rot3(d.ximat, frc) * on
  trq_w = math.rot3(d.ximat, trq) * on
  jacp, jacr = _body_jacs(m, d)
  return (torch.einsum('Bbvx,Bbx->Bv', jacp, frc_w)
          + torch.einsum('Bbvx,Bbx->Bv', jacr, trq_w))


# ---------------------------------------------------------------------------
# Actuation (reference stage: mj_fwdActuation).
# ---------------------------------------------------------------------------


def actuation(m: Model, d: Data) -> Data:
  """Actuator forces of FIXED/AFFINE gains and biases, and the activation
  dynamics of stateful actuators: act_dot is ctrl (INTEGRATOR) or (ctrl -
  act) / tau (FILTER, FILTEREXACT), and a stateful actuator's input is its
  activation instead of its control."""
  ref = d.qpos
  B = ref.shape[0]
  if m.nu == 0 or (m.opt.disableflags & DisableBit.ACTUATION):
    return d.replace(qfrc_actuator=ref.new_zeros((B, m.nv)),
                     actuator_force=ref.new_zeros((B, m.nu)),
                     act_dot=ref.new_zeros((B, m.na)))
  dyn = np.asarray(m.actuator_dyntype)
  known = np.isin(dyn, [int(DynType.NONE), int(DynType.INTEGRATOR),
                        int(DynType.FILTER), int(DynType.FILTEREXACT)])
  if not known.all():
    raise NotImplementedError(
        f'dyntype {DynType(int(dyn[~known][0])).name} is not ported yet')
  gt = np.asarray(m.actuator_gaintype)
  bt = np.asarray(m.actuator_biastype)
  if not np.isin(gt, [int(GainType.FIXED), int(GainType.AFFINE)]).all():
    raise NotImplementedError(f'gaintype {GainType(int(gt.max()))}')
  if not np.isin(bt, [int(BiasType.NONE), int(BiasType.AFFINE)]).all():
    raise NotImplementedError(f'biastype {BiasType(int(bt.max()))}')

  ctrl = d.ctrl
  if not m.opt.disableflags & DisableBit.CLAMPCTRL:
    lo = mirror(m, ref, m.actuator_ctrlrange[:, 0])
    hi = mirror(m, ref, m.actuator_ctrlrange[:, 1])
    ctrl = torch.where(mirror(m, ref, m.actuator_ctrllimited),
                       torch.minimum(torch.maximum(ctrl, lo), hi), ctrl)

  vel = torch.einsum('Buv,Bv->Bu', d.actuator_moment, d.qvel)
  act_dot, inputs = ref.new_zeros((B, m.na)), ctrl
  if m.na:
    actadr = np.asarray(m.actuator_actadr)
    sel = np.flatnonzero(dyn == int(DynType.INTEGRATOR))
    if len(sel):
      act_dot[:, mirror(m, ref, actadr[sel])] = ctrl[:, mirror(m, ref, sel)]
    sel = np.flatnonzero((dyn == int(DynType.FILTER))
                         | (dyn == int(DynType.FILTEREXACT)))
    if len(sel):
      a = mirror(m, ref, actadr[sel])
      tau = mirror(m, ref, np.maximum(m.actuator_dynprm[sel, 0], 1e-12))
      act_dot[:, a] = (ctrl[:, mirror(m, ref, sel)] - d.act[:, a]) / tau
    inputs = torch.where(mirror(m, ref, dyn == int(DynType.NONE)), ctrl,
                         d.act[:, mirror(m, ref, np.maximum(actadr, 0))])
  gp = mirror(m, ref, m.actuator_gainprm)
  bp = mirror(m, ref, m.actuator_biasprm)
  gain_affine = gp[:, 0] + gp[:, 1] * d.actuator_length + gp[:, 2] * vel
  gain = torch.where(mirror(m, ref, gt == int(GainType.FIXED)), gp[:, 0],
                     gain_affine)
  bias_affine = bp[:, 0] + bp[:, 1] * d.actuator_length + bp[:, 2] * vel
  bias = torch.where(mirror(m, ref, bt == int(BiasType.NONE)), 0.0,
                     bias_affine)
  force = gain * inputs + bias
  if m.actuator_forcelimited.any():
    lo = mirror(m, ref, m.actuator_forcerange[:, 0])
    hi = mirror(m, ref, m.actuator_forcerange[:, 1])
    force = torch.where(mirror(m, ref, m.actuator_forcelimited),
                        torch.minimum(torch.maximum(force, lo), hi), force)
  qfrc_actuator = torch.einsum('Buv,Bu->Bv', d.actuator_moment, force)
  if m.njnt and m.jnt_actfrclimited.any():
    raise NotImplementedError('jnt_actfrcrange is not ported yet')
  return d.replace(actuator_velocity=vel, actuator_force=force,
                   act_dot=act_dot, qfrc_actuator=qfrc_actuator)


# ---------------------------------------------------------------------------
# Applied external forces.
# ---------------------------------------------------------------------------


def xfrc_accumulate(m: Model, d: Data) -> torch.Tensor:
  """Project xfrc_applied (per-body world wrench at xipos) into qfrc."""
  jacp, jacr = _body_jacs(m, d)
  force, torque = d.xfrc_applied[..., :3], d.xfrc_applied[..., 3:]
  return (torch.einsum('Bbvx,Bbx->Bv', jacp, force)
          + torch.einsum('Bbvx,Bbx->Bv', jacr, torque))


# ---------------------------------------------------------------------------
# Forward pipeline.
# ---------------------------------------------------------------------------


def fwd_position(m: Model, d: Data) -> Data:
  from dm_control_tpu_torch._src import collision
  from dm_control_tpu_torch._src import constraint
  d = smooth.kinematics(m, d)
  d = smooth.com_pos(m, d)
  d = smooth.crb(m, d)
  d = smooth.factor_m(m, d)
  d = smooth.tendon(m, d)
  d = collision.collide(m, d)
  d = smooth.transmission(m, d)
  d = constraint.make_constraint(m, d)
  return d


def fwd_velocity(m: Model, d: Data) -> Data:
  d = smooth.com_vel(m, d)
  d = smooth.rne(m, d)
  d = passive(m, d)
  return d


def fwd_acceleration(m: Model, d: Data) -> Data:
  qfrc_smooth = (d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator
                 + d.qfrc_applied)
  if m.nbody > 1:
    qfrc_smooth = qfrc_smooth + xfrc_accumulate(m, d)
  qacc_smooth = smooth.solve_m(m, d, qfrc_smooth) if m.nv else qfrc_smooth
  return d.replace(qfrc_smooth=qfrc_smooth, qacc_smooth=qacc_smooth)


def step1(m: Model, d: Data, skipsensor: bool = False) -> Data:
  """Position + velocity stages + pos/vel sensors (mj_step1 analog)."""
  d = fwd_position(m, d)
  d = fwd_velocity(m, d)
  if not skipsensor:
    from dm_control_tpu_torch._src import sensor
    d = sensor.sensors(m, d, stages='posvel')
    d = _energy(m, d)
  return d


def _acc_stage(m: Model, d: Data, skipsensor: bool = False) -> Data:
  """Actuation + acceleration + constraint solve (+ acc sensors)."""
  from dm_control_tpu_torch._src import solver
  d = actuation(m, d)
  d = fwd_acceleration(m, d)
  d = solver.solve(m, d)
  if not skipsensor:
    from dm_control_tpu_torch._src import sensor
    d = sensor.sensors(m, d, stages='acc')
  return d


def forward(m: Model, d: Data) -> Data:
  d = step1(m, d)
  d = _acc_stage(m, d)
  return d


def _forward_core(m: Model, d: Data) -> Data:
  """Full pipeline without sensors/energy (RK4's inner stages)."""
  d = fwd_position(m, d)
  d = fwd_velocity(m, d)
  d = _acc_stage(m, d, skipsensor=True)
  return d


def _energy(m: Model, d: Data) -> Data:
  ref = d.qpos
  tr = tree.get(m)
  mass = mirror(m, ref, m.body_mass)
  gravity = mirror(m, ref, np.asarray(m.opt.gravity, np.float64))
  potential = -torch.einsum('b,Bbx,x->B', mass, d.xipos, gravity)
  hs = (tr.hs_jids[m.jnt_stiffness[tr.hs_jids] > 0]
        if len(tr.hs_jids) else tr.hs_jids)
  if len(hs):
    qpos_spring = smooth.mparam(m, d, 'qpos_spring')
    qadr = mirror(m, ref, m.jnt_qposadr[hs])
    dif = d.qpos[:, qadr] - qpos_spring[..., qadr]
    potential = potential + 0.5 * (mirror(m, ref, m.jnt_stiffness[hs])
                                   * dif * dif).sum(-1)
  if m.nv:
    kinetic = 0.5 * torch.einsum('Bu,Buv,Bv->B', d.qvel, d.qM, d.qvel)
  else:
    kinetic = torch.zeros_like(potential)
  return d.replace(energy=torch.stack([potential, kinetic], dim=-1))


# ---------------------------------------------------------------------------
# Integrators.
# ---------------------------------------------------------------------------


def _integrate_pos(m: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                   dt) -> torch.Tensor:
  """Advance qpos by qvel*dt with quaternion handling, one batched op per
  joint-type group."""
  tr = tree.get(m)
  out = qpos.clone()
  if len(tr.hs_jids):
    qadr = mirror(m, qpos, tr.hs_qadr)
    out[:, qadr] = qpos[:, qadr] + dt * qvel[:, mirror(m, qpos, tr.hs_dadr)]
  if len(tr.ball_jids):
    qmat = mirror(m, qpos, tr.ball_qmat)
    out[:, qmat] = math.quat_integrate(
        qpos[:, qmat], qvel[:, mirror(m, qpos, tr.ball_dmat)], dt)
  if len(tr.free_jids):
    qmat = mirror(m, qpos, tr.free_qmat)
    q = qpos[:, qmat]
    v = qvel[:, mirror(m, qpos, tr.free_dmat)]
    pos = q[..., :3] + dt * v[..., :3]
    quat = math.quat_integrate(q[..., 3:7], v[..., 3:6], dt)
    out[:, qmat] = torch.cat([pos, quat], dim=-1)
  return out


def _act_range(m: Model):
  """(lo, hi) (na,) of the activations, -inf/inf where unlimited; None
  where no actuator limits its activation."""
  if not m.na or not m.actuator_actlimited.any():
    return None
  lo, hi = np.full(m.na, -np.inf), np.full(m.na, np.inf)
  for u in range(m.nu):
    a = int(m.actuator_actadr[u])
    if a >= 0 and m.actuator_actlimited[u]:
      lo[a], hi[a] = m.actuator_actrange[u]
  return lo, hi


def _advance(m: Model, d: Data, qacc: torch.Tensor) -> Data:
  """Shared integrator tail: advance act (clipped to its range), qvel,
  qpos, time."""
  h = float(m.opt.timestep)
  act = d.act + h * d.act_dot
  rng = _act_range(m)
  if rng is not None:
    act = torch.clamp(act, mirror(m, act, rng[0]), mirror(m, act, rng[1]))
  qvel = d.qvel + h * qacc
  qpos = _integrate_pos(m, d.qpos, qvel, h)
  return d.replace(qpos=qpos, qvel=qvel, act=act, time=d.time + h)


def euler(m: Model, d: Data) -> Data:
  """Semi-implicit Euler with implicit joint damping (mj_Euler parity);
  the damped solve is kernel K1b on the card."""
  qacc = d.qacc
  if (m.nv and not (m.opt.disableflags & DisableBit.EULERDAMP)
      and np.any(m.dof_damping > 0)):
    from dm_control_tpu_torch._src import linalg
    h = float(m.opt.timestep)
    ref = d.qpos
    mhb = d.qM + torch.diag(mirror(m, ref, h * m.dof_damping))
    qacc = linalg.solve_psd(mhb, d.qfrc_smooth + d.qfrc_constraint)
  return _advance(m, d, qacc)


_RK4_A = np.array([
    [0.5, 0.0, 0.0],
    [0.0, 0.5, 0.0],
    [0.0, 0.0, 1.0],
])
_RK4_B = np.array([1.0 / 6, 1.0 / 3, 1.0 / 3, 1.0 / 6])


def rk4(m: Model, d: Data) -> Data:
  """Classic RK4 over (qpos, qvel, act) with the full pipeline per stage:
  d's own qacc and act_dot are the first stage's, three `_forward_core`
  runs give the others (each one acc stage, so one K1c solve and one
  Newton solve)."""
  h = float(m.opt.timestep)
  d0 = d
  qvels = [d.qvel]
  qaccs = [d.qacc]
  act_dots = [d.act_dot]
  for i in range(3):
    a = _RK4_A[i]
    dqvel = sum(float(a[j]) * qvels[j] for j in range(i + 1))
    dqacc = sum(float(a[j]) * qaccs[j] for j in range(i + 1))
    dact = sum(float(a[j]) * act_dots[j] for j in range(i + 1))
    di = d0.replace(qpos=_integrate_pos(m, d0.qpos, dqvel, h),
                    qvel=d0.qvel + h * dqacc, act=d0.act + h * dact)
    di = _forward_core(m, di)
    qvels.append(di.qvel)
    qaccs.append(di.qacc)
    act_dots.append(di.act_dot)
  fvel = sum(float(_RK4_B[j]) * qvels[j] for j in range(4))
  facc = sum(float(_RK4_B[j]) * qaccs[j] for j in range(4))
  fact = sum(float(_RK4_B[j]) * act_dots[j] for j in range(4))
  qpos = _integrate_pos(m, d0.qpos, fvel, h)
  qvel = d0.qvel + h * facc
  return d0.replace(qpos=qpos, qvel=qvel, act=d0.act + h * fact,
                    time=d0.time + h)


def _integrate(m: Model, d: Data) -> Data:
  if m.opt.integrator == Integrator.RK4:
    return rk4(m, d)
  return euler(m, d)


def step(m: Model, d: Data) -> Data:
  """One physics step with the reference's step2-then-step1 ordering: the
  input Data must be step1-synced (reset/forward establish this)."""
  d = _acc_stage(m, d)
  d = _integrate(m, d)
  d = step1(m, d)
  d = _check_divergence(m, d)
  return d


# True integration state: everything else in Data is recomputed from
# these by the pipeline stages each step.
_STATE_FIELDS = ('time', 'qpos', 'qvel', 'act', 'ctrl', 'qfrc_applied',
                 'xfrc_applied', 'qacc_warmstart', 'diverged', 'model_var')


def state_of(d: Data) -> dict:
  """The integration state of d, by field name: (B, ...) tensors, and
  under 'model_var' the dict of the lanes' model overrides, {name: (B,
  ...)} (empty where the task sets none)."""
  st = {f: getattr(d, f) for f in _STATE_FIELDS if f != 'model_var'}
  st['model_var'] = dict(d.model_var or {})
  return st


def map_state(fn, *states) -> dict:
  """fn applied key by key to the tensors of one or more `state_of`
  dicts (model_var's by name), in the keys of the first."""
  out = {}
  for f, x in states[0].items():
    if f == 'model_var':
      out[f] = {k: fn(*(s[f][k] for s in states)) for k in x}
    else:
      out[f] = fn(*(s[f] for s in states))
  return out


def state_items(st: dict):
  """(name, tensor) for every tensor of a `state_of` dict, model_var's
  named 'model_var.<name>'."""
  for f, x in st.items():
    if f == 'model_var':
      yield from ((f'model_var.{k}', v) for k, v in x.items())
    else:
      yield f, x


def substeps(m: Model, d: Data, n: int) -> Data:
  """Advance `n` physics steps; final Data is step()-complete.

  Inside the loop each iteration runs in the standard order (position and
  velocity stages, acc + solve, integrate) without sensors; a trailing
  step1 sync and full step() restore the legacy invariant on the returned
  Data, exactly as the JAX package's scan does.
  """
  if n <= 1:
    # Self-sync before stepping: callers may pass Data whose derived
    # fields belong to a different state (auto-reset lanes); step1 is a
    # pure function of the integration state.
    return step(m, step1(m, d, skipsensor=True))
  for _ in range(n - 1):
    d = step1(m, d, skipsensor=True)
    d = _acc_stage(m, d, skipsensor=True)
    d = _integrate(m, d)
    d = _check_divergence(m, d)
  d = step1(m, d, skipsensor=True)  # sync for the acc stage
  return step(m, d)


def _check_divergence(m: Model, d: Data) -> Data:
  """Per-lane divergence flag (non-finite or huge state)."""
  bad = ~(torch.isfinite(d.qpos).all(-1) & torch.isfinite(d.qvel).all(-1))
  big = (d.qpos.abs() > 1e10).any(-1)
  return d.replace(diverged=d.diverged | bad | big)
