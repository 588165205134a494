"""Static constraint-row layout, shared by assembly, solver, and sensors.

The port's own copy of `dm_control_tpu/_src/efc.py` (host numpy).

The reference's native mj_makeConstraint sizes its efc rows dynamically per
step; under XLA everything must be static.  This module derives, once per
Model, the complete row layout (types, per-contact row spans, friction-cone
metadata) as host numpy arrays.  Constraint assembly (constraint.py), the
solver (solver.py), and contact-force sensors (sensor.py) all read the SAME
layout object, so they can never disagree about row counts or ordering
(the round-1 pyramidal/elliptic row-count mismatch class of bug).

Row order: equality, dof friction, tendon friction, joint limits
(slide/hinge then ball), tendon limits, contacts (pair-entry order).

Elliptic friction cones follow the reference's documented convex model
(verified empirically against the oracle's efc_* arrays):
  * rows per contact = condim (normal + condim-1 unscaled direction rows),
  * friction-row D_i = D_normal * (mu_i/mu_1)^2 * impratio,
  * the solver sees a circular cone with mu~ = mu_1/sqrt(impratio) in
    coordinates scaled by s_i = (mu_i/mu_1)*sqrt(impratio).
"""

from __future__ import annotations

import numpy as np

from dm_control_tpu_torch._src.types import (ConeType, DisableBit, EqType,
                                       JointType, Model)

# row cost types
EQUALITY = 0
FRICTION = 1
ONESIDED = 2
ELLIPTIC = 3   # member row of an elliptic-cone contact (grouped per contact)


class ContactLayout:
  """Static per-contact and per-contact-row metadata (numpy).

  Body/geom ids are NOT stored here: under the top-K broadphase they are
  traced per step (read from the Contact buffer).  Row structure (condim,
  friction cone geometry) is uniform within each collision group, so it
  stays static."""

  def __init__(self):
    # per contact point, in collision group order
    self.condim = []       # (ncon,)
    self.friction = []     # (ncon, 5) group-uniform friction
    self.row_start = []    # (ncon,) first efc row of this contact
    # pure normal rows (condim==1 contacts and elliptic normals)
    self.nrm_con = []      # contact index
    self.nrm_row = []      # efc row index
    # pyramidal edge rows
    self.pyr_con = []      # contact index
    self.pyr_dir = []      # friction direction 0..4 (t1,t2,rot n,t1,t2)
    self.pyr_sign = []     # +1/-1 edge sign
    self.pyr_row = []      # efc row index
    # elliptic friction rows
    self.ellf_con = []     # contact index
    self.ellf_dir = []     # direction 0..4
    self.ellf_row = []     # efc row index

  def finalize(self):
    for name in ('condim', 'row_start', 'nrm_con',
                 'nrm_row', 'pyr_con', 'pyr_dir', 'pyr_row', 'ellf_con',
                 'ellf_dir', 'ellf_row'):
      setattr(self, name, np.asarray(getattr(self, name), np.int32))
    self.pyr_sign = np.asarray(self.pyr_sign, np.float64)
    self.friction = (np.asarray(self.friction, np.float64)
                     if self.friction else np.zeros((0, 5)))
    self.ncon = len(self.condim)
    self.max_dir = int(max(
        [d + 1 for d in list(self.pyr_dir) + list(self.ellf_dir)] or [0]))
    return self


class Layout:
  """Full efc-row layout for one Model."""

  def __init__(self):
    self.nefc = 0
    self.types = None           # (nefc,) int32
    self.n_noncontact = 0
    # dof/tendon friction rows
    self.fric_dof = None        # (nf,) dof indices
    self.fric_ten = None        # (nft,) tendon indices
    # joint limit rows
    self.lim_jnt = None         # (nl,) slide/hinge joint ids
    self.lim_ball = None        # (nb,) ball joint ids
    self.lim_ten = None         # (nt,) tendon ids
    self.contact = None         # ContactLayout or None
    # elliptic solver groups: {condim: (rows (ncg, k), mu (ncg,),
    #                                   scale (ncg, k))}
    self.ell_groups = {}
    self._cache = {}            # solver core cache

  @property
  def has_elliptic(self):
    return bool(self.ell_groups)


def _eq_nrows(etype) -> int:
  return {EqType.CONNECT: 3, EqType.WELD: 6, EqType.JOINT: 1,
          EqType.TENDON: 1}[EqType(int(etype))]


def layout(m: Model) -> Layout:
  cached = m.__dict__.get('_efc_layout')
  if cached is not None:
    return cached
  lay = _build(m)
  m.__dict__['_efc_layout'] = lay
  return lay


def _build(m: Model) -> Layout:
  from dm_control_tpu_torch._src import collision as coll
  from dm_control_tpu_torch._src import colliders

  lay = Layout()
  types = []

  disabled = m.opt.disableflags & DisableBit.CONSTRAINT
  if disabled:
    lay.types = np.zeros(0, np.int32)
    lay.fric_dof = np.zeros(0, np.int32)
    lay.fric_ten = np.zeros(0, np.int32)
    lay.lim_jnt = np.zeros(0, np.int32)
    lay.lim_ball = np.zeros(0, np.int32)
    lay.lim_ten = np.zeros(0, np.int32)
    return lay

  # --- equality ------------------------------------------------------------
  if not (m.opt.disableflags & DisableBit.EQUALITY):
    for e in range(m.neq):
      types += [EQUALITY] * _eq_nrows(m.eq_type[e])

  # --- dof + tendon friction loss -------------------------------------------
  fric_dof, fric_ten = [], []
  if not (m.opt.disableflags & DisableBit.FRICTIONLOSS):
    for v in range(m.nv):
      if float(m.dof_frictionloss[v]) > 0:
        fric_dof.append(v)
        types.append(FRICTION)
    for t in range(m.ntendon):
      if (m.tendon_frictionloss is not None
          and float(m.tendon_frictionloss[t]) > 0):
        fric_ten.append(t)
        types.append(FRICTION)
  lay.fric_dof = np.asarray(fric_dof, np.int32)
  lay.fric_ten = np.asarray(fric_ten, np.int32)

  # --- limits ----------------------------------------------------------------
  lim_jnt, lim_ball, lim_ten = [], [], []
  if not (m.opt.disableflags & DisableBit.LIMIT):
    for j in range(m.njnt):
      if not m.jnt_limited[j]:
        continue
      jt = JointType(int(m.jnt_type[j]))
      if jt in (JointType.SLIDE, JointType.HINGE):
        lim_jnt.append(j)
    for j in range(m.njnt):
      if m.jnt_limited[j] and int(m.jnt_type[j]) == int(JointType.BALL):
        lim_ball.append(j)
    for t in range(m.ntendon):
      if m.tendon_limited[t]:
        lim_ten.append(t)
    types += [ONESIDED] * (len(lim_jnt) + len(lim_ball) + len(lim_ten))
  lay.lim_jnt = np.asarray(lim_jnt, np.int32)
  lay.lim_ball = np.asarray(lim_ball, np.int32)
  lay.lim_ten = np.asarray(lim_ten, np.int32)

  lay.n_noncontact = len(types)

  # --- contacts ---------------------------------------------------------------
  elliptic = m.opt.cone == ConeType.ELLIPTIC
  impratio = float(getattr(m.opt, 'impratio', 1.0))
  if not (m.opt.disableflags & DisableBit.CONTACT):
    cgroups = coll.groups(m)
    if cgroups:
      c = ContactLayout()
      ell_rows = {}  # condim -> list of row-index tuples
      ci = 0
      for grp in cgroups:
        condim = grp.condim
        friction = grp.friction
        for _ in range(grp.ncon):
          r0 = len(types)
          c.condim.append(condim)
          c.friction.append(friction)
          c.row_start.append(r0)
          if condim == 1:
            c.nrm_con.append(ci)
            c.nrm_row.append(r0)
            types.append(ONESIDED)
          elif elliptic:
            c.nrm_con.append(ci)
            c.nrm_row.append(r0)
            types.append(ELLIPTIC)
            for t in range(condim - 1):
              c.ellf_con.append(ci)
              c.ellf_dir.append(t)
              c.ellf_row.append(r0 + 1 + t)
              types.append(ELLIPTIC)
            mu1 = float(friction[0])
            mu_t = mu1 / np.sqrt(impratio)
            scale = np.concatenate(
                [[1.0], friction[:condim - 1] / mu1 * np.sqrt(impratio)])
            ell_rows.setdefault(condim, []).append(
                (list(range(r0, r0 + condim)), mu_t, scale))
          else:
            for t in range(condim - 1):
              for sign in (1.0, -1.0):
                c.pyr_con.append(ci)
                c.pyr_dir.append(t)
                c.pyr_sign.append(sign)
                c.pyr_row.append(len(types))
                types.append(ONESIDED)
          ci += 1
      lay.contact = c.finalize()
      for k, lst in ell_rows.items():
        rows = np.asarray([x[0] for x in lst], np.int32)
        mu = np.asarray([x[1] for x in lst], np.float64)
        scale = np.asarray([x[2] for x in lst], np.float64)
        lay.ell_groups[k] = (rows, mu, scale)

  lay.types = np.asarray(types, np.int32)
  lay.nefc = len(types)
  return lay


def count_rows(m: Model) -> int:
  return layout(m).nefc
