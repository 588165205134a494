"""Smooth (unconstrained) dynamics: pure functions over (Model, Data).

The port of `dm_control_tpu/_src/smooth.py`, batch-first: kinematics,
com-centered quantities, the dense composite-rigid-body mass matrix and
its Cholesky factor, velocity products and recursive-Newton-Euler bias
forces.  The kinematic tree is walked one (level, joint signature) group
at a time (tree.kin_groups); ancestor structure enters as constant 0/1
masks contracted with einsum.  Constants come from the Model's device
mirror (`types.mirror`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dm_control_tpu_torch._src import math
from dm_control_tpu_torch._src import tree
from dm_control_tpu_torch._src.types import (Data, DisableBit, JointType,
                                             Model, TrnType, mirror)


def mparam(m: Model, d: Data, name: str) -> torch.Tensor:
  """Model array, or its per-episode override (B, ...) from d.model_var."""
  mv = d.model_var or {}
  if name in mv:
    return mv[name].to(d.qpos.dtype)
  return mirror(m, d.qpos, getattr(m, name))


# ---------------------------------------------------------------------------
# Kinematics.
# ---------------------------------------------------------------------------


def kinematics(m: Model, d: Data) -> Data:
  """Body/geom/site poses from qpos (reference stage: mj_kinematics)."""
  tr = tree.get(m)
  ref = d.qpos
  B = ref.shape[0]
  qpos = d.qpos
  qpos0 = mparam(m, d, 'qpos0')
  body_pos = mparam(m, d, 'body_pos')
  body_quat = mparam(m, d, 'body_quat')
  jnt_pos = mirror(m, ref, m.jnt_pos)
  jnt_axis = mirror(m, ref, m.jnt_axis)

  xpos = ref.new_zeros((B, m.nbody, 3))
  xquat = ref.new_zeros((B, m.nbody, 4))
  xquat[:, 0, 0] = 1.0
  xanchor = ref.new_zeros((B, m.njnt, 3))
  xaxis = ref.new_zeros((B, m.njnt, 3))

  for grp in tr.kin_groups:
    ids = mirror(m, ref, grp['ids'])
    jids = grp['jids']
    qadr = mirror(m, ref, grp['qadr'])
    if grp['free']:
      q = qpos[:, qadr]                          # (B, nb, 7)
      pos = q[..., :3]
      quat = math.normalize(q[..., 3:7])
      anchors = pos[:, :, None, :]
      axes = jnt_axis[mirror(m, ref, jids)].expand((B,) + jids.shape + (3,))
    else:
      par = mirror(m, ref, grp['par'])
      ppos = xpos[:, par]
      pquat = xquat[:, par]
      pos = ppos + math.quat_rotate(pquat, body_pos[..., ids, :])
      quat = math.quat_mul(pquat, body_quat[..., ids, :])
      anchor_l, axis_l = [], []
      q_g = qpos[:, qadr]
      q0_g = qpos0[..., qadr]
      off = 0
      for k, jtype in enumerate(grp['sig']):
        jk = mirror(m, ref, jids[:, k])
        jp = jnt_pos[jk]                         # (nb, 3)
        ja = jnt_axis[jk]
        anchor = math.quat_rotate(quat, jp) + pos
        axis = math.quat_rotate(quat, ja)
        anchor_l.append(anchor)
        axis_l.append(axis)
        if jtype == JointType.SLIDE:
          pos = pos + axis * (q_g[..., off] - q0_g[..., off])[..., None]
          off += 1
        elif jtype == JointType.HINGE:
          angle = q_g[..., off] - q0_g[..., off]
          quat = math.quat_mul(quat, math.axis_angle_to_quat(ja, angle))
          # rotation is about the anchor, not the frame origin
          pos = anchor - math.quat_rotate(quat, jp)
          off += 1
        elif jtype == JointType.BALL:
          quat = math.quat_mul(quat, math.normalize(q_g[..., off:off + 4]))
          pos = anchor - math.quat_rotate(quat, jp)
          off += 4
        else:
          raise NotImplementedError('free joint must be the only joint')
      quat = math.normalize(quat)
      anchors = (torch.stack(anchor_l, dim=2) if anchor_l
                 else ref.new_zeros((B, len(grp['ids']), 0, 3)))
      axes = (torch.stack(axis_l, dim=2) if axis_l
              else ref.new_zeros((B, len(grp['ids']), 0, 3)))
    xpos[:, ids] = pos
    xquat[:, ids] = quat
    if jids.size:
      flat = mirror(m, ref, jids.reshape(-1))
      xanchor[:, flat] = anchors.reshape(B, -1, 3)
      xaxis[:, flat] = axes.reshape(B, -1, 3)

  xmat = math.quat_to_mat(xquat)
  xipos = xpos + math.rot3(xmat, mirror(m, ref, m.body_ipos))
  ximat = math.mul33(xmat, math.quat_to_mat(mirror(m, ref, m.body_iquat)))

  gb = mirror(m, ref, m.geom_bodyid)
  geom_xpos = xpos[:, gb] + math.rot3(xmat[:, gb], mparam(m, d, 'geom_pos'))
  geom_xmat = math.mul33(xmat[:, gb],
                         math.quat_to_mat(mirror(m, ref, m.geom_quat)))
  sb = mirror(m, ref, m.site_bodyid)
  site_xpos = xpos[:, sb] + math.rot3(xmat[:, sb], mparam(m, d, 'site_pos'))
  site_xmat = math.mul33(xmat[:, sb],
                         math.quat_to_mat(mirror(m, ref, m.site_quat)))

  return d.replace(
      xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos, ximat=ximat,
      geom_xpos=geom_xpos, geom_xmat=geom_xmat,
      site_xpos=site_xpos, site_xmat=site_xmat,
      xanchor=xanchor, xaxis=xaxis)


# ---------------------------------------------------------------------------
# COM-based quantities (reference stage: mj_comPos).
# ---------------------------------------------------------------------------


def com_pos(m: Model, d: Data) -> Data:
  tr = tree.get(m)
  ref = d.qpos
  B = ref.shape[0]
  mass = mirror(m, ref, m.body_mass)
  sub_mask = mirror(m, ref, tr.subtree_mask)
  subtree_mass = sub_mask @ mass
  wpos = mass[:, None] * d.xipos
  subtree_com = (torch.einsum('bc,Bcx->Bbx', sub_mask, wpos)
                 / torch.clamp(subtree_mass, min=1e-12)[:, None])

  # spatial inertia of each body about its tree-root subtree com
  root_com = subtree_com[:, mirror(m, ref, m.body_rootid)]
  cinert = math.inert_from_body(
      mass, mirror(m, ref, m.body_inertia), d.ximat, d.xipos - root_com)
  cinert[:, 0] = 0.0

  cdof = ref.new_zeros((B, m.nv, 6))
  if len(tr.slide_jids):
    jid = mirror(m, ref, tr.slide_jids)
    rows = torch.cat([ref.new_zeros((B, len(tr.slide_jids), 3)),
                      d.xaxis[:, jid]], dim=-1)
    cdof[:, mirror(m, ref, m.jnt_dofadr[tr.slide_jids])] = rows
  if len(tr.hinge_jids):
    jid = mirror(m, ref, tr.hinge_jids)
    offset = (d.xanchor[:, jid]
              - root_com[:, mirror(m, ref, m.jnt_bodyid[tr.hinge_jids])])
    ax = d.xaxis[:, jid]
    cdof[:, mirror(m, ref, m.jnt_dofadr[tr.hinge_jids])] = torch.cat(
        [ax, math.cross(offset, ax)], dim=-1)
  if len(tr.ball_jids):
    jid = mirror(m, ref, tr.ball_jids)
    bid = mirror(m, ref, m.jnt_bodyid[tr.ball_jids])
    offset = d.xanchor[:, jid] - root_com[:, bid]          # (B, nb, 3)
    axes = d.xmat[:, bid].transpose(-1, -2)               # (B, nb, 3, 3)
    rows = torch.cat([axes, math.cross(offset[:, :, None, :], axes)], -1)
    cdof[:, mirror(m, ref, tr.ball_dmat.reshape(-1))] = rows.reshape(
        B, -1, 6)
  if len(tr.free_jids):
    bid = mirror(m, ref, m.jnt_bodyid[tr.free_jids])
    nb = len(tr.free_jids)
    trans = torch.cat([ref.new_zeros((3, 3)),
                       torch.eye(3, dtype=ref.dtype, device=ref.device)], 1)
    trans = trans.expand(B, nb, 3, 6)
    off = d.xpos[:, bid] - root_com[:, bid]
    axes = d.xmat[:, bid].transpose(-1, -2)
    rot = torch.cat([axes, math.cross(off[:, :, None, :], axes)], -1)
    cdof[:, mirror(m, ref, tr.free_dmat.reshape(-1))] = torch.cat(
        [trans, rot], dim=2).reshape(B, -1, 6)

  return d.replace(subtree_com=subtree_com, cinert=cinert, cdof=cdof)


# ---------------------------------------------------------------------------
# CRB mass matrix + factorization (reference stages: mj_crb, mj_factorM).
# ---------------------------------------------------------------------------


def crb(m: Model, d: Data) -> Data:
  tr = tree.get(m)
  ref = d.qpos
  B = ref.shape[0]
  if m.nv == 0:
    z = ref.new_zeros((B, 0, 0))
    return d.replace(qM=z, qLD=z)
  crb_inert = torch.einsum('bc,Bcd->Bbd', mirror(m, ref, tr.subtree_mask),
                           d.cinert)
  # f_i = I^crb_{body(i)} * cdof_i
  f = math.inert_mul(crb_inert[:, mirror(m, ref, m.dof_bodyid)], d.cdof)
  a = torch.einsum('Bik,Bjk->Bij', f, d.cdof)
  # anc[i, j] = 1 if dof j is on the path to body(dof i) (incl. same body)
  anc = m.body_dof_mask[m.dof_bodyid] > 0
  qm = torch.where(mirror(m, ref, anc), a,
                   torch.where(mirror(m, ref, anc.T.copy()),
                               a.transpose(-1, -2), 0.0))
  qm = qm + torch.diag(mirror(m, ref, m.dof_armature))
  return d.replace(qM=qm)


def factor_m(m: Model, d: Data) -> Data:
  """Dense Cholesky of qM (kernel K1a on the card)."""
  if m.nv == 0:
    return d
  from dm_control_tpu_torch._src import linalg
  return d.replace(qLD=linalg.cholesky(d.qM))


def solve_m(m: Model, d: Data, x: torch.Tensor) -> torch.Tensor:
  """Solve qM y = x using the cached Cholesky factor (K1c on the card)."""
  from dm_control_tpu_torch._src import linalg
  return linalg.cho_solve(d.qLD, x)


# ---------------------------------------------------------------------------
# Velocity products (reference stage: mj_comVel).
# ---------------------------------------------------------------------------


def com_vel(m: Model, d: Data) -> Data:
  """Body spatial velocities + cdof time-derivatives (mj_comVel analog)."""
  tr = tree.get(m)
  ref = d.qpos
  B = ref.shape[0]
  if m.nv == 0:
    return d.replace(cvel=ref.new_zeros((B, m.nbody, 6)),
                     cdof_dot=ref.new_zeros((B, 0, 6)))
  vc = d.qvel[..., None] * d.cdof                      # (B, nv, 6)
  cvel = torch.einsum('bv,Bvx->Bbx', mirror(m, ref, m.body_dof_mask), vc)
  v_before = torch.einsum('iv,Bvx->Bix', mirror(m, ref, tr.dof_before), vc)
  cdof_dot = math.motion_cross(v_before, d.cdof)
  cdof_dot = torch.where(mirror(m, ref, tr.free_trans)[:, None], 0.0,
                         cdof_dot)
  return d.replace(cvel=cvel, cdof_dot=cdof_dot)


# ---------------------------------------------------------------------------
# RNE bias forces (reference stage: mj_rne).
# ---------------------------------------------------------------------------


def _gravity(m: Model) -> np.ndarray:
  if m.opt.disableflags & DisableBit.GRAVITY:
    return np.zeros(3)
  return np.asarray(m.opt.gravity, np.float64)


def rne(m: Model, d: Data) -> Data:
  ref = d.qpos
  B = ref.shape[0]
  mask = mirror(m, ref, m.body_dof_mask)           # (nbody, nv)
  base = mirror(m, ref, np.concatenate([np.zeros(3), -_gravity(m)]))
  if m.nv:
    cacc = base + torch.einsum('bv,Bv,Bvx->Bbx', mask, d.qvel, d.cdof_dot)
  else:
    cacc = base.expand(B, m.nbody, 6)
  cfrc = (math.inert_mul(d.cinert, cacc)
          + math.motion_cross_force(d.cvel, math.inert_mul(d.cinert, d.cvel)))
  if m.nv:
    qfrc_bias = torch.einsum('bv,Bbx,Bvx->Bv', mask, cfrc, d.cdof)
  else:
    qfrc_bias = ref.new_zeros((B, 0))
  return d.replace(qfrc_bias=qfrc_bias)


# ---------------------------------------------------------------------------
# Tendons (reference stage: mj_tendon).
# ---------------------------------------------------------------------------


def _tendon_wraps(m: Model) -> dict:
  """Static wrap tables of the model's tendons, cached on the Model.

  A tendon whose wraps are all joints is fixed: entry f adds wrap_prm[wid]
  x qpos of joint `jid` to tendon `tid`.  Any other is a spatial site
  chain: segment s runs from site s1 to site s2 of tendon `tid`.  The
  one-hot matrices sum entries and segments into their tendons (and
  dofs) in a fixed order."""
  cached = m.__dict__.get('_tendon_wraps')
  if cached is not None:
    return cached
  fw_tid, fw_wid, sp_tid, sp_s1, sp_s2 = [], [], [], [], []
  for t in range(m.ntendon):
    adr, num = int(m.tendon_adr[t]), int(m.tendon_num[t])
    if all(int(w) == 0 for w in m.wrap_type[adr:adr + num]):
      fw_tid += [t] * num
      fw_wid += list(range(adr, adr + num))
    else:
      if any(int(w) != 1 for w in m.wrap_type[adr:adr + num]):
        raise NotImplementedError(
            'spatial tendons with wrapping geoms or pulleys are not ported')
      for w in range(adr, adr + num - 1):
        sp_tid.append(t)
        sp_s1.append(int(m.wrap_objid[w]))
        sp_s2.append(int(m.wrap_objid[w + 1]))
  out = {}
  if fw_tid:
    jid = m.wrap_objid[fw_wid]
    to_dof = np.zeros((len(fw_tid), m.ntendon * m.nv))
    to_dof[np.arange(len(fw_tid)),
           np.asarray(fw_tid) * m.nv + m.jnt_dofadr[jid]] = 1.0
    out['fixed'] = dict(wid=np.asarray(fw_wid), qadr=m.jnt_qposadr[jid],
                        to_ten=np.eye(m.ntendon)[fw_tid], to_dof=to_dof)
  if sp_tid:
    b1, b2 = m.site_bodyid[sp_s1], m.site_bodyid[sp_s2]
    out['spatial'] = dict(
        s1=np.asarray(sp_s1), s2=np.asarray(sp_s2),
        to_ten=np.eye(m.ntendon)[sp_tid],
        root1=m.body_rootid[b1], root2=m.body_rootid[b2],
        mask1=m.body_dof_mask[b1], mask2=m.body_dof_mask[b2])
  m.__dict__['_tendon_wraps'] = out
  return out


def tendon(m: Model, d: Data) -> Data:
  """Tendon lengths (B, ntendon), Jacobians (B, ntendon, nv) and
  velocities (reference stage: mj_tendon): fixed tendons as one sum over
  their joint entries, with `wrap_prm` read through `mparam` (a per-lane
  override in model_var), and spatial site-chain tendons as one batched
  segment computation, each segment's Jacobian the difference of its two
  end points' translational Jacobians along its direction."""
  if m.ntendon == 0:
    return d
  ref = d.qpos
  B = ref.shape[0]
  tw = _tendon_wraps(m)
  ten_length = ref.new_zeros((B, m.ntendon))
  ten_j = ref.new_zeros((B, m.ntendon, m.nv))
  if 'fixed' in tw:
    fx = tw['fixed']
    coef = mparam(m, d, 'wrap_prm')[..., mirror(m, ref, fx['wid'])]
    contrib = coef * d.qpos[:, mirror(m, ref, fx['qadr'])]
    ten_length = ten_length + contrib @ mirror(m, ref, fx['to_ten'])
    ten_j = ten_j + (coef @ mirror(m, ref, fx['to_dof'])).reshape(
        -1, m.ntendon, m.nv)
  if 'spatial' in tw:
    sp = tw['spatial']
    p1 = d.site_xpos[:, mirror(m, ref, sp['s1'])]          # (B, S, 3)
    p2 = d.site_xpos[:, mirror(m, ref, sp['s2'])]
    diff = p2 - p1
    seg_len = math.norm_safe(diff)
    dir_ = diff / torch.clamp(seg_len, min=1e-12)[..., None]
    to_ten = mirror(m, ref, sp['to_ten'])
    ten_length = ten_length + seg_len @ to_ten

    def point_jacs(pts, root, mask):
      offset = pts - d.subtree_com[:, mirror(m, ref, root)]
      jp = d.cdof[:, None, :, 3:] + math.cross(d.cdof[:, None, :, :3],
                                              offset[:, :, None, :])
      return jp * mirror(m, ref, mask)[..., None]     # (B, S, nv, 3)

    j1 = point_jacs(p1, sp['root1'], sp['mask1'])
    j2 = point_jacs(p2, sp['root2'], sp['mask2'])
    contrib = torch.einsum('Bsvx,Bsx->Bsv', j2 - j1, dir_)
    ten_j = ten_j + torch.einsum('Bsv,st->Btv', contrib, to_ten)
  if m.nv:
    ten_velocity = torch.einsum('Btv,Bv->Bt', ten_j, d.qvel)
  else:
    ten_velocity = ref.new_zeros((B, m.ntendon))
  return d.replace(ten_length=ten_length, ten_J=ten_j,
                   ten_velocity=ten_velocity)


def jac(m: Model, d: Data, point: torch.Tensor,
        bodyid: int) -> Tuple[torch.Tensor, torch.Tensor]:
  """(jacp (B, nv, 3), jacr (B, nv, 3)) for world points (B, 3) on a body."""
  ref = d.qpos
  mask = mirror(m, ref, m.body_dof_mask[bodyid])[:, None]      # (nv, 1)
  offset = point - d.subtree_com[:, int(m.body_rootid[bodyid])]
  jacp = d.cdof[..., 3:] + math.cross(d.cdof[..., :3], offset[:, None, :])
  return jacp * mask, d.cdof[..., :3] * mask


# ---------------------------------------------------------------------------
# Actuator transmission (reference stage: mj_transmission).
# ---------------------------------------------------------------------------


def transmission(m: Model, d: Data) -> Data:
  """Actuator lengths/moments for joint and tendon transmissions: a
  joint's is its qpos and unit dof times the gear, a tendon's its length
  and Jacobian times the gear."""
  ref = d.qpos
  B = ref.shape[0]
  if m.nu == 0:
    return d.replace(actuator_length=ref.new_zeros((B, 0)),
                     actuator_moment=ref.new_zeros((B, 0, m.nv)))
  trn = np.asarray(m.actuator_trntype)
  is_jnt = np.isin(trn, [int(TrnType.JOINT), int(TrnType.JOINTINPARENT)])
  is_ten = trn == int(TrnType.TENDON)
  if not (is_jnt | is_ten).all():
    raise NotImplementedError(
        f'transmission {TrnType(int(trn[~(is_jnt | is_ten)][0]))} is not '
        f'ported yet')
  jsel, tsel = np.flatnonzero(is_jnt), np.flatnonzero(is_ten)
  jj = m.actuator_trnid[jsel, 0]
  if not np.isin(m.jnt_type[jj], [int(JointType.SLIDE),
                                  int(JointType.HINGE)]).all():
    raise NotImplementedError('ball/free joint transmissions are not ported')
  gear = m.actuator_gear[:, 0]
  # joint actuators: the moment is constant, the length a gather
  qadr = np.zeros(m.nu, np.int64)
  qadr[jsel] = m.jnt_qposadr[jj]
  moment = np.zeros((m.nu, m.nv))
  moment[jsel, m.jnt_dofadr[jj]] = gear[jsel]
  lengths = (d.qpos[:, mirror(m, ref, qadr)]
             * mirror(m, ref, np.where(is_jnt, gear, 0.0)))
  moments = mirror(m, ref, moment).expand(B, m.nu, m.nv)
  if len(tsel):
    # tendon actuators: one-hot (nu, ntendon) selection times the gear
    sel = np.zeros((m.nu, m.ntendon))
    sel[tsel, m.actuator_trnid[tsel, 0]] = gear[tsel]
    sel = mirror(m, ref, sel)
    lengths = lengths + d.ten_length @ sel.T
    moments = moments + torch.einsum('ut,Btv->Buv', sel, d.ten_J)
  return d.replace(actuator_length=lengths, actuator_moment=moments)
