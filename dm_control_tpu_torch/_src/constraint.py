"""Constraint assembly: tendon equalities, friction loss, joint and tendon
limits, contacts -> efc rows.

The port of `dm_control_tpu/_src/constraint.py`, batch-first.  The row
layout is the static one of `efc.layout`; every row family is one batched
computation.  The soft-constraint parameterization (solref/solimp ->
stiffness, damping, impedance, regularizer) is the JAX package's.
Tendons give equality, friction-loss and limit rows along their
Jacobians.  Contacts give condim-1 normal rows, pyramid edges, or
elliptic normal and friction rows.  CONNECT, WELD and JOINT equalities
and ball-joint limits are not ported yet and raise.
"""

from __future__ import annotations

import numpy as np
import torch

from dm_control_tpu_torch._src import efc
from dm_control_tpu_torch._src import math
from dm_control_tpu_torch._src.types import (Data, DisableBit, EqType, Model,
                                             mirror)

# impedance endpoints are clamped into [mjMINIMP, mjMAXIMP] before
# interpolating
_MINIMP, _MAXIMP = 1e-4, 0.9999


def _impedance(solimp, pos_minus_margin):
  """Impedance d(x) from solimp = (dmin, dmax, width, midpoint, power)."""
  dmin = torch.clamp(solimp[..., 0], _MINIMP, _MAXIMP)
  dmax = torch.clamp(solimp[..., 1], _MINIMP, _MAXIMP)
  width, mid, power = solimp[..., 2], solimp[..., 3], solimp[..., 4]
  x = torch.clamp(pos_minus_margin.abs() / torch.clamp(width, min=1e-14),
                  0.0, 1.0)
  # reflected power sigmoid through (0,0), (mid, mid'), (1,1)
  a = 1.0 / torch.pow(torch.clamp(mid, min=1e-14), power - 1.0)
  b = 1.0 / torch.pow(torch.clamp(1.0 - mid, min=1e-14), power - 1.0)
  y_lo = a * torch.pow(x, power)
  y_hi = 1.0 - b * torch.pow(1.0 - x, power)
  y = torch.where(x < mid, y_lo, y_hi)
  return dmin + y * (dmax - dmin)


def _kbi(m: Model, solref, solimp, pos_minus_margin):
  """(stiffness k, damping b, impedance) from solref/solimp."""
  imp = _impedance(solimp, pos_minus_margin)
  dmax = torch.clamp(solimp[..., 1], _MINIMP, _MAXIMP)
  timeconst, dampratio = solref[..., 0], solref[..., 1]
  if not m.opt.disableflags & DisableBit.REFSAFE:
    timeconst = torch.clamp(timeconst, min=2.0 * m.opt.timestep)
  direct = solref[..., 0] <= 0
  k_std = 1.0 / torch.clamp(
      dmax * dmax * timeconst * timeconst * dampratio * dampratio, min=1e-14)
  b_std = 2.0 / torch.clamp(dmax * timeconst, min=1e-14)
  k = torch.where(direct,
                  -solref[..., 0] / torch.clamp(dmax * dmax, min=1e-14), k_std)
  b = torch.where(direct, -solref[..., 1] / torch.clamp(dmax, min=1e-14),
                  b_std)
  return k, b, imp


class _Blocks:
  """Ordered efc blocks, concatenated once at the end (static shapes)."""

  def __init__(self, m: Model, d: Data):
    self.m, self.d = m, d
    self.J, self.pos, self.margin = [], [], []
    self.D, self.aref, self.frictionloss = [], [], []
    self.active = []

  def add(self, J, pos, margin, solref, solimp, invweight, active,
          frictionloss=None):
    """One block of n rows: J (B, n, nv); the rest broadcast to (B, n)."""
    m, d = self.m, self.d
    B, n = J.shape[0], J.shape[1]
    bn = lambda x: torch.broadcast_to(x, (B, n))
    pmm = pos - margin
    k, b, imp = _kbi(m, solref, solimp, pmm)
    r = torch.clamp((1.0 - imp) / imp * invweight, min=1e-14)
    vel = torch.einsum('Bnv,Bv->Bn', J, d.qvel)
    if frictionloss is None:
      frictionloss = d.qpos.new_zeros((B, n))
    self.J.append(J)
    self.pos.append(bn(pos))
    self.margin.append(bn(margin))
    self.D.append(bn(1.0 / r))
    self.aref.append(bn(-b * vel - k * imp * pmm))
    self.frictionloss.append(bn(frictionloss))
    self.active.append(bn(active))

  def finalize(self) -> Data:
    d = self.d
    nefc = d.efc_J.shape[1]
    if not self.J:
      assert nefc == 0
      return d
    J = torch.cat(self.J, dim=1)
    assert J.shape[1] == nefc, (
        f'constraint row count {J.shape[1]} != allocated {nefc}')
    return d.replace(
        efc_J=J,
        efc_pos=torch.cat(self.pos, dim=1),
        efc_margin=torch.cat(self.margin, dim=1),
        efc_D=torch.cat(self.D, dim=1),
        efc_aref=torch.cat(self.aref, dim=1),
        efc_frictionloss=torch.cat(self.frictionloss, dim=1),
        efc_active=torch.cat(self.active, dim=1),
    )


def make_constraint(m: Model, d: Data) -> Data:
  if m.opt.disableflags & DisableBit.CONSTRAINT:
    return d
  lay = efc.layout(m)
  ref = d.qpos
  if lay.lim_ball.size:
    raise NotImplementedError('ball joint limit rows are not ported yet')
  blocks = _Blocks(m, d)

  # --- equality rows come first ---------------------------------------------
  if m.neq and not m.opt.disableflags & DisableBit.EQUALITY:
    _tendon_equality_rows(m, d, blocks)

  # --- dof friction loss (zero distance: no spring term, always active) -------
  if lay.fric_dof.size:
    idx = lay.fric_dof
    zero = ref.new_zeros(idx.size)
    blocks.add(mirror(m, ref, np.eye(m.nv)[idx]).expand(ref.shape[0], -1, -1),
               zero, zero, mirror(m, ref, m.dof_solref[idx]),
               mirror(m, ref, m.dof_solimp[idx]),
               mirror(m, ref, m.dof_invweight0[idx]), zero == 0,
               frictionloss=mirror(m, ref, m.dof_frictionloss[idx]))

  # --- tendon friction loss (as the dof's, along the tendon's Jacobian) -------
  if lay.fric_ten.size:
    idx = mirror(m, ref, lay.fric_ten)
    zero = ref.new_zeros(lay.fric_ten.size)
    blocks.add(d.ten_J[:, idx], zero, zero,
               mirror(m, ref, m.tendon_solref_fri[lay.fric_ten]),
               mirror(m, ref, m.tendon_solimp_fri[lay.fric_ten]),
               mirror(m, ref, m.tendon_invweight0[lay.fric_ten]), zero == 0,
               frictionloss=mirror(m, ref,
                                   m.tendon_frictionloss[lay.fric_ten]))

  # --- joint limits (slide/hinge, vectorized) --------------------------------
  if lay.lim_jnt.size:
    jid = lay.lim_jnt
    dadr = m.jnt_dofadr[jid]
    q = d.qpos[:, mirror(m, ref, m.jnt_qposadr[jid])]
    dist_lo = q - mirror(m, ref, m.jnt_range[jid, 0])
    dist_hi = mirror(m, ref, m.jnt_range[jid, 1]) - q
    dist = torch.minimum(dist_lo, dist_hi)
    sign = torch.where(dist_lo < dist_hi, 1.0, -1.0)
    J = mirror(m, ref, np.eye(m.nv)[dadr]) * sign[..., None]
    margin = mirror(m, ref, m.jnt_margin[jid])
    blocks.add(J, dist, margin, mirror(m, ref, m.jnt_solref[jid]),
               mirror(m, ref, m.jnt_solimp[jid]),
               mirror(m, ref, m.dof_invweight0[dadr]), dist < margin)

  # --- tendon limits: the nearer side, J along the tendon towards it -----------
  if lay.lim_ten.size:
    tid = lay.lim_ten
    length = d.ten_length[:, mirror(m, ref, tid)]
    dist_lo = length - mirror(m, ref, m.tendon_range[tid, 0])
    dist_hi = mirror(m, ref, m.tendon_range[tid, 1]) - length
    dist = torch.minimum(dist_lo, dist_hi)
    sign = torch.where(dist_lo < dist_hi, 1.0, -1.0)
    J = d.ten_J[:, mirror(m, ref, tid)] * sign[..., None]
    margin = mirror(m, ref, m.tendon_margin[tid])
    blocks.add(J, dist, margin, mirror(m, ref, m.tendon_solref_lim[tid]),
               mirror(m, ref, m.tendon_solimp_lim[tid]),
               mirror(m, ref, m.tendon_invweight0[tid]), dist < margin)

  # --- contacts -----------------------------------------------------------------
  if lay.contact is not None and lay.contact.ncon:
    _contact_rows(m, d, lay, blocks)

  return blocks.finalize()


def _tendon_equality_rows(m: Model, d: Data, blocks: _Blocks):
  """One row per equality, in model order, all of type TENDON: tendon
  t1's length off its qpos0 length, l1, less the polynomial (eq_data[:5])
  in tendon t2's, l2 (its constant term alone where there is no t2);
  J = J1 - poly'(l2) J2.  Any other equality type raises."""
  for e in range(m.neq):
    etype = EqType(int(m.eq_type[e]))
    if etype != EqType.TENDON:
      raise NotImplementedError(f'{etype.name} equality rows are not ported '
                                f'yet')
  ref = d.qpos
  t1 = np.asarray(m.eq_obj1id, np.int64)
  t2 = np.asarray(m.eq_obj2id, np.int64)
  poly = mirror(m, ref, m.eq_data[:, :5])                      # (neq, 5)
  length0 = np.asarray(m.tendon_length0)
  l1 = d.ten_length[:, mirror(m, ref, t1)] - mirror(m, ref, length0[t1])
  J = d.ten_J[:, mirror(m, ref, t1)]
  pos = l1 - poly[:, 0]
  invweight = np.asarray(m.tendon_invweight0)[t1]
  two = t2 >= 0
  if two.any():
    t2s = np.maximum(t2, 0)
    l2 = d.ten_length[:, mirror(m, ref, t2s)] - mirror(m, ref, length0[t2s])
    powers = torch.stack([l2 ** i for i in range(5)], dim=-1)
    dpoly = torch.stack([i * l2 ** (i - 1) if i else torch.zeros_like(l2)
                         for i in range(5)], dim=-1)
    on = mirror(m, ref, two)
    pos = torch.where(on, l1 - (powers * poly).sum(-1), pos)
    J = torch.where(on[:, None], J - ((dpoly * poly).sum(-1)[..., None]
                                      * d.ten_J[:, mirror(m, ref, t2s)]), J)
    invweight = invweight + np.where(
        two, np.asarray(m.tendon_invweight0)[t2s], 0.0)
  zero = ref.new_zeros(m.neq)
  blocks.add(J, pos, zero, mirror(m, ref, m.eq_solref),
             mirror(m, ref, m.eq_solimp), mirror(m, ref, invweight),
             mirror(m, ref, m.eq_active0.astype(bool)))


def contact_jacobians(m: Model, d: Data, lay: efc.Layout):
  """Batched contact-frame Jacobians.

  Returns (jn (B, ncon, nv), jdirs (B, ncon, ndir, nv)): the normal
  relative-velocity Jacobian of each contact and its tangential (+
  rotational, when any contact has condim > 3) direction rows, written as
  J . f = mask * (f . cdof_lin[v] + (off x f) . cdof_ang[v]).
  """
  con = d.contact
  c = lay.contact
  ref = d.qpos
  nbody = m.nbody
  dof_mask = mirror(m, ref, m.body_dof_mask)             # (nbody, nv)
  bodies = torch.arange(nbody, device=ref.device)
  B1 = (con.body1[..., None] == bodies).to(ref.dtype)    # (B, ncon, nbody)
  B2 = (con.body2[..., None] == bodies).to(ref.dtype)
  root_com = d.subtree_com[:, mirror(m, ref, m.body_rootid)]  # (B,nbody,3)
  mask1 = B1 @ dof_mask                                  # (B, ncon, nv)
  mask2 = B2 @ dof_mask
  off1 = con.pos - B1 @ root_com                         # (B, ncon, 3)
  off2 = con.pos - B2 @ root_com
  cdof_angT = d.cdof[..., :3].transpose(-1, -2)          # (B, 3, nv)
  cdof_linT = d.cdof[..., 3:].transpose(-1, -2)

  def jdiff_p(f):
    lin = f @ cdof_linT
    a1 = math.cross(off1, f) @ cdof_angT
    a2 = math.cross(off2, f) @ cdof_angT
    return mask2 * (lin + a2) - mask1 * (lin + a1)

  jn = jdiff_p(con.frame[..., 0, :])
  ndir = min(c.max_dir, 2) if c.max_dir <= 2 else 5
  if ndir == 0:
    return jn, jn.new_zeros(jn.shape[:2] + (0, m.nv))
  jt = torch.stack([jdiff_p(con.frame[..., 1, :]),
                    jdiff_p(con.frame[..., 2, :])], dim=2)
  if ndir <= 2:
    return jn, jt
  dmask = mask2 - mask1
  jr = torch.stack([dmask * (con.frame[..., k, :] @ cdof_angT)
                    for k in range(3)], dim=2)
  return jn, torch.cat([jt, jr], dim=2)


def _contact_rows(m: Model, d: Data, lay: efc.Layout, blocks: _Blocks):
  """All contact efc rows: normals (condim 1 and elliptic), pyramid edges
  and elliptic friction rows."""
  con = d.contact
  c = lay.contact
  ref = d.qpos
  B = ref.shape[0]
  nrows = lay.nefc - lay.n_noncontact
  base = lay.n_noncontact
  impratio = float(m.opt.impratio)

  jn, jdirs = contact_jacobians(m, d, lay)
  dist = con.dist
  margin = con.includemargin
  k, b, imp = _kbi(m, con.solref, con.solimp, dist - margin)
  biw = mirror(m, ref, m.body_invweight0[:, 0])
  iw = biw[con.body1.long()] + biw[con.body2.long()]
  d_n = 1.0 / torch.clamp((1.0 - imp) / imp * iw, min=1e-14)
  active = dist < margin
  vel_n = torch.einsum('Bcv,Bv->Bc', jn, d.qvel)
  aref_n = -b * vel_n - k * imp * (dist - margin)
  mu1 = mirror(m, ref, c.friction[:, 0])

  J = ref.new_zeros((B, nrows, m.nv))
  pos = ref.new_zeros((B, nrows))
  marg = ref.new_zeros((B, nrows))
  D = ref.new_ones((B, nrows))
  aref = ref.new_zeros((B, nrows))
  act = torch.zeros((B, nrows), dtype=torch.bool, device=ref.device)

  if c.nrm_row.size:
    rows = mirror(m, ref, c.nrm_row - base)
    ci = mirror(m, ref, c.nrm_con)
    J[:, rows] = jn[:, ci]
    pos[:, rows] = dist[:, ci]
    marg[:, rows] = margin[:, ci]
    D[:, rows] = d_n[:, ci]
    aref[:, rows] = aref_n[:, ci]
    act[:, rows] = active[:, ci]

  if c.pyr_row.size:
    rows = mirror(m, ref, c.pyr_row - base)
    ci = mirror(m, ref, c.pyr_con)
    mu_dir = mirror(m, ref, c.friction[c.pyr_con, c.pyr_dir])
    sign = mirror(m, ref, c.pyr_sign)
    Jp = (jn[:, ci]
          + (sign * mu_dir)[:, None] * jdirs[:, ci, mirror(m, ref, c.pyr_dir)])
    vel = torch.einsum('Brv,Bv->Br', Jp, d.qvel)
    # pyramid-edge D: all edges share the mu_1-based scaling, / impratio
    mu2 = mu1[ci] * mu1[ci]
    J[:, rows] = Jp
    pos[:, rows] = dist[:, ci]
    marg[:, rows] = margin[:, ci]
    D[:, rows] = d_n[:, ci] / (2.0 * mu2 * (1.0 + mu2)) * impratio
    aref[:, rows] = (-b[:, ci] * vel
                     - (k * imp)[:, ci] * (dist[:, ci] - margin[:, ci]))
    act[:, rows] = active[:, ci]

  if c.ellf_row.size:
    # elliptic friction rows: D scaled by (mu_dir / mu_1)^2 * impratio, no
    # spring term, pos and margin 0
    rows = mirror(m, ref, c.ellf_row - base)
    ci = mirror(m, ref, c.ellf_con)
    Jf = jdirs[:, ci, mirror(m, ref, c.ellf_dir)]
    ratio = mirror(m, ref, c.friction[c.ellf_con, c.ellf_dir]) / mu1[ci]
    J[:, rows] = Jf
    D[:, rows] = d_n[:, ci] * ratio * ratio * impratio
    aref[:, rows] = -b[:, ci] * torch.einsum('Brv,Bv->Br', Jf, d.qvel)
    act[:, rows] = active[:, ci]

  blocks.J.append(J)
  blocks.pos.append(pos)
  blocks.margin.append(marg)
  blocks.D.append(D)
  blocks.aref.append(aref)
  blocks.frictionloss.append(ref.new_zeros((B, nrows)))
  blocks.active.append(act)
