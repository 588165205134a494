"""Sensors: fill Data.sensordata (reference stages mj_sensorPos/Vel/Acc).

The port of `dm_control_tpu/_src/sensor.py` for the sensor types the
ported tasks read: `subtreecom`, `subtreelinvel`, `subtreeangmom`,
`jointpos`, `jointvel`, `framepos`, `framexaxis` and `frameyaxis` (of a body, xbody,
geom or site), `velocimeter` and `gyro` (of a site), `rangefinder` (every
rangefinder's ray in one `render.raycast`), and in the acc
stage `touch`, `accelerometer`, `force` and `torque` (of a site; the
last three through `rne_postconstraint`).  Each is one batched
computation over the leading batch axis.  The stage split is the
JAX package's: rows outside the requested stage keep their previous
values.  Every other sensor type raises NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from dm_control_tpu_torch._src import efc
from dm_control_tpu_torch._src import math
from dm_control_tpu_torch._src import tree
from dm_control_tpu_torch._src.types import (Data, DisableBit, GeomType,
                                             Model, ObjType, SensorType,
                                             mirror)

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
  linvel = forces = ranges = None
  if any(SensorType(int(m.sensor_type[s])) in (
      SensorType.ACCELEROMETER, SensorType.FORCE, SensorType.TORQUE)
         for s in selected):
    cacc, cfrc_int = rne_postconstraint(m, d)
  for s in selected:
    stype = SensorType(int(m.sensor_type[s]))
    objid = int(m.sensor_objid[s])
    adr, dim = int(m.sensor_adr[s]), int(m.sensor_dim[s])
    if stype == SensorType.JOINTPOS:
      val = d.qpos[:, int(m.jnt_qposadr[objid])]
    elif stype == SensorType.JOINTVEL:
      val = d.qvel[:, int(m.jnt_dofadr[objid])]
    elif stype == SensorType.FRAMEPOS:
      val = _object_frame(d, int(m.sensor_objtype[s]), objid)[0]
    elif stype in (SensorType.FRAMEXAXIS, SensorType.FRAMEYAXIS):
      # a column of the object's world-from-local rotation
      col = 0 if stype == SensorType.FRAMEXAXIS else 1
      val = _object_frame(d, int(m.sensor_objtype[s]), objid)[1][..., col]
    elif stype in (SensorType.VELOCIMETER, SensorType.GYRO):
      # the site's [ang; lin] velocity in its own frame
      vel = _site_velocity(m, d, objid)
      val = vel[:, 3:] if stype == SensorType.VELOCIMETER else vel[:, :3]
    elif stype == SensorType.ACCELEROMETER:
      val = _site_accel(m, d, objid, cacc)[:, 3:]
    elif stype in (SensorType.FORCE, SensorType.TORQUE):
      # the wrench its body's parent transmits, at the site, in its frame
      bodyid = int(m.site_bodyid[objid])
      com = d.subtree_com[:, int(m.body_rootid[bodyid])]
      wrench = math.transform_force(cfrc_int[:, bodyid],
                                    d.site_xpos[:, objid] - com)
      part = wrench[:, 3:] if stype == SensorType.FORCE else wrench[:, :3]
      val = torch.einsum('Bij,Bi->Bj', d.site_xmat[:, objid], part)
    elif stype == SensorType.SUBTREECOM:
      val = d.subtree_com[:, objid]
    elif stype == SensorType.SUBTREELINVEL:
      if linvel is None:
        linvel = _subtree_linvel(m, d)
      val = linvel[:, objid]
    elif stype == SensorType.SUBTREEANGMOM:
      if linvel is None:
        linvel = _subtree_linvel(m, d)
      val = _subtree_angmom(m, d, objid, linvel)
    elif stype == SensorType.RANGEFINDER:
      if ranges is None:
        ranges = _rangefinders(m, d, selected)
      val = ranges[s]
    elif stype == SensorType.TOUCH:
      if forces is None:
        forces = _contact_forces(m, d)
      val = _touch(m, d, objid, forces)
    else:
      raise NotImplementedError(f'sensor {stype.name} is not ported yet')
    cutoff = float(m.sensor_cutoff[s])
    if cutoff > 0:
      # touch is a magnitude: the reference clips it to [0, cutoff]
      lo = 0.0 if stype == SensorType.TOUCH else -cutoff
      val = torch.clamp(val, lo, cutoff)
    out[:, adr:adr + dim] = val.reshape(val.shape[0], dim)
  return d.replace(sensordata=out)


def _rangefinders(m: Model, d: Data, selected) -> dict:
  """{sensor: (B,) distance} of the selected rangefinders: each site's
  ray along its z axis, its own body's geoms unseen, -1 where it hits
  nothing; all sensors' rays in one cast."""
  from dm_control_tpu_torch._src import render
  rf = [s for s in selected
        if SensorType(int(m.sensor_type[s])) == SensorType.RANGEFINDER]
  sites = np.asarray([int(m.sensor_objid[s]) for s in rf])
  idx = mirror(m, d.qpos, sites)
  dist = render.raycast(m, d, d.site_xpos[:, idx],
                        d.site_xmat[:, idx][..., :, 2],
                        exclude_body=m.site_bodyid[sites])
  return {s: dist[:, i] for i, s in enumerate(rf)}


def rne_postconstraint(m: Model, d: Data):
  """((B, nbody, 6) cacc, (B, nbody, 6) cfrc_int) at the solved qacc, for
  the acc-stage sensors (reference mj_rnePostConstraint).

  cacc is each body's acceleration, gravity's included; cfrc_int[b] the
  wrench body b's parent transmits to it, both in the com-centered
  world-aligned frame of b's tree root.  The external forces are
  xfrc_applied and the contact forces; a contact's bodies are its own
  lane's (top-K selects them per lane), summed into the bodies through
  (B, ncon, nbody) one-hot matrices in a fixed order."""
  ref = d.qpos
  B = ref.shape[0]
  gravity = np.zeros(3) if m.opt.disableflags & DisableBit.GRAVITY else (
      np.asarray(m.opt.gravity, np.float64))
  base = mirror(m, ref, np.concatenate([np.zeros(3), -gravity]))
  root_com = d.subtree_com[:, mirror(m, ref, m.body_rootid)]
  cfrc_ext = ref.new_zeros((B, m.nbody, 6))
  if m.nbody > 1:
    # xfrc_applied is a wrench at xipos: moved to the root's com
    frc, trq = d.xfrc_applied[..., :3], d.xfrc_applied[..., 3:]
    cfrc_ext = torch.cat([trq + math.cross(d.xipos - root_com, frc), frc],
                         dim=-1)
  con = d.contact
  if con.dist.shape[1]:
    world_f = torch.einsum('Bcab,Bca->Bcb', con.frame,
                           _contact_forces(m, d))
    bodies = torch.arange(m.nbody, device=ref.device)
    g_body = mirror(m, ref, m.geom_bodyid)
    for sign, geom in ((1.0, con.geom2), (-1.0, con.geom1)):
      sel = (g_body[geom.clamp(min=0).long()][..., None] == bodies).to(
          ref.dtype)                                       # (B, ncon, nbody)
      f = sign * world_f
      wrench = torch.cat([math.cross(con.pos - sel @ root_com, f), f], dim=-1)
      wrench = torch.where((geom >= 0)[..., None], wrench, 0.0)
      cfrc_ext = cfrc_ext + sel.transpose(-1, -2) @ wrench
  mask = mirror(m, ref, m.body_dof_mask)
  cacc = base + (torch.einsum('bv,Bv,Bvx->Bbx', mask, d.qacc, d.cdof)
                 + torch.einsum('bv,Bv,Bvx->Bbx', mask, d.qvel, d.cdof_dot))
  cfrc_body = (math.inert_mul(d.cinert, cacc)
               + math.motion_cross_force(d.cvel,
                                         math.inert_mul(d.cinert, d.cvel))
               - cfrc_ext)
  cfrc_int = torch.einsum('bc,Bcx->Bbx',
                          mirror(m, ref, tree.get(m).subtree_mask), cfrc_body)
  return cacc, cfrc_int


def _site_accel(m: Model, d: Data, siteid: int,
                cacc: torch.Tensor) -> torch.Tensor:
  """(B, 6) [ang; lin] acceleration of a site's origin in its frame, the
  linear part with the centripetal term of the site's velocity."""
  bodyid = int(m.site_bodyid[siteid])
  offset = (d.site_xpos[:, siteid]
            - d.subtree_com[:, int(m.body_rootid[bodyid])])
  acc = math.transform_motion(cacc[:, bodyid], offset)
  vel = math.transform_motion(d.cvel[:, bodyid], offset)
  lin = acc[:, 3:] + math.cross(vel[:, :3], vel[:, 3:])
  mat_t = d.site_xmat[:, siteid].transpose(-1, -2)
  return torch.cat([math.rot3(mat_t, acc[:, :3]), math.rot3(mat_t, lin)],
                   dim=-1)


def _object_frame(d: Data, objtype: int, objid: int):
  """((B, 3) world position, (B, 3, 3) world-from-local rotation) of a
  sensor's frame object."""
  ot = ObjType(objtype)
  if ot == ObjType.BODY:
    return d.xipos[:, objid], d.ximat[:, objid]
  if ot == ObjType.XBODY:
    return d.xpos[:, objid], d.xmat[:, objid]
  if ot == ObjType.GEOM:
    return d.geom_xpos[:, objid], d.geom_xmat[:, objid]
  if ot == ObjType.SITE:
    return d.site_xpos[:, objid], d.site_xmat[:, objid]
  raise NotImplementedError(f'frame sensor objtype {ot.name}')


def _site_velocity(m: Model, d: Data, siteid: int) -> torch.Tensor:
  """(B, 6) [ang; lin] velocity of a site's origin in the site's frame:
  its body's cvel moved from the tree root's subtree com to the site and
  rotated by the site's xmat transposed."""
  bodyid = int(m.site_bodyid[siteid])
  com = d.subtree_com[:, int(m.body_rootid[bodyid])]
  return math.transform_motion(d.cvel[:, bodyid], d.site_xpos[:, siteid] - com,
                               d.site_xmat[:, siteid].transpose(-1, -2))


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


def _subtree_angmom(m: Model, d: Data, body: int,
                    linvel: torch.Tensor) -> torch.Tensor:
  """(B, 3) angular momentum of `body`'s subtree about its center of
  mass: over the subtree's bodies c, I_c w_c + m_c (xipos_c - com) x
  (v_c - v), I_c the world-frame inertia, w_c and v_c the body's angular
  and com velocities, com and v the subtree's (`linvel`, the
  `_subtree_linvel` of every body)."""
  ref = d.qpos
  mass = mirror(m, ref, m.body_mass)
  com_root = d.subtree_com[:, mirror(m, ref, m.body_rootid)]
  ang = d.cvel[..., :3]
  lin = d.cvel[..., 3:] + math.cross(ang, d.xipos - com_root)
  inertia = torch.einsum('Bbik,bk,Bbjk->Bbij', d.ximat,
                         mirror(m, ref, m.body_inertia), d.ximat)
  spin = torch.einsum('Bbij,Bbj->Bbi', inertia, ang)
  orbit = mass[:, None] * math.cross(d.xipos - d.subtree_com[:, body, None],
                                     lin - linvel[:, body, None])
  sm = mirror(m, ref, tree.get(m).subtree_mask[body])
  return torch.einsum('c,Bcx->Bx', sm, spin + orbit)


def _contact_forces(m: Model, d: Data) -> torch.Tensor:
  """(B, ncon, 3) contact-frame force (normal, t1, t2) of each contact.

  Decodes efc_force with the static layout: normal and elliptic friction
  rows map 1:1; pyramid edge forces recombine (normal = sum of the edge
  forces, tangent = mu (f+ - f-)), the reference's mj_contactForce."""
  ref = d.qpos
  B, ncon = d.contact.dist.shape
  flat = ref.new_zeros((B, ncon * 3))
  c = efc.layout(m).contact
  if c is None or not c.ncon:
    return flat.reshape(B, ncon, 3)

  def add(con, slot, rows, weight=None):
    f = d.efc_force[:, mirror(m, ref, rows)]
    if weight is not None:
      f = f * mirror(m, ref, weight)
    flat.index_add_(1, mirror(m, ref, con * 3 + slot), f)

  if c.nrm_row.size:
    add(c.nrm_con, 0, c.nrm_row)
  if c.ellf_row.size:
    sel = c.ellf_dir < 2
    add(c.ellf_con[sel], 1 + c.ellf_dir[sel], c.ellf_row[sel])
  if c.pyr_row.size:
    add(c.pyr_con, 0, c.pyr_row)
    sel = c.pyr_dir < 2
    add(c.pyr_con[sel], 1 + c.pyr_dir[sel], c.pyr_row[sel],
        c.friction[c.pyr_con[sel], c.pyr_dir[sel]] * c.pyr_sign[sel])
  return flat.reshape(B, ncon, 3)


def _touch(m: Model, d: Data, siteid: int,
           forces: torch.Tensor) -> torch.Tensor:
  """(B,) sum of the normal forces of the active contacts on the site's
  body whose point lies inside the site's volume."""
  ref = d.qpos
  con = d.contact
  if con.dist.shape[1] == 0:
    return ref.new_zeros(ref.shape[0])
  bodyid = int(m.site_bodyid[siteid])
  g_body = mirror(m, ref, m.geom_bodyid)
  b1 = g_body[con.geom1.clamp(min=0).long()]
  b2 = g_body[con.geom2.clamp(min=0).long()]
  involves = (b1 == bodyid) | (b2 == bodyid)
  active = con.dist < con.includemargin
  size = mirror(m, ref, m.site_size[siteid])
  local = torch.einsum('Bab,Bca->Bcb', d.site_xmat[:, siteid],
                       con.pos - d.site_xpos[:, siteid, None])
  stype = GeomType(int(m.site_type[siteid]))
  if stype == GeomType.SPHERE:
    inside = (local * local).sum(-1) <= size[0] ** 2
  elif stype == GeomType.CAPSULE:
    z = torch.clamp(local[..., 2], -size[1], size[1])
    dd = local - torch.stack([torch.zeros_like(z), torch.zeros_like(z), z],
                             -1)
    inside = (dd * dd).sum(-1) <= size[0] ** 2
  elif stype == GeomType.ELLIPSOID:
    inside = ((local / size) ** 2).sum(-1) <= 1.0
  else:  # box
    inside = (local.abs() <= size).all(-1)
  mask = involves & active & inside
  return torch.where(mask, forces[..., 0].abs(), 0.0).sum(-1)
