"""Static kinematic-tree structures, derived once per Model.

The port's own copy of `dm_control_tpu/_src/tree.py` (host numpy).

The reference's native engine recurses over the kinematic tree in C where
loop overhead is free; a direct translation unrolls those loops at JAX
trace time and XLA graph size grows with nbody/njnt/nv (the round-1
humanoid_CMU 45-minute-compile failure mode).  This module groups the tree
so the engine emits O(depth x distinct-joint-signatures) ops instead:

  * kin_groups: bodies grouped by (tree level, joint signature) — each
    group is processed as ONE batched computation; parents of level-L
    bodies are always complete before level L runs.
  * subtree_mask / dof_before: constant 0/1 matrices turning subtree
    reductions and velocity prefix-sums into single einsums.
  * per-joint-type index matrices for vectorized cdof construction,
    position integration, springs, and limits.

Everything here is host-side numpy, cached on the Model instance.
"""

from __future__ import annotations

import numpy as np

from dm_control_tpu_torch._src.types import JOINT_NQ, JOINT_NV, JointType, Model


class Tree:
  pass


def get(m: Model) -> Tree:
  cached = m.__dict__.get('_tree')
  if cached is not None:
    return cached
  tr = _build(m)
  m.__dict__['_tree'] = tr
  return tr


def _build(m: Model) -> Tree:
  tr = Tree()
  nbody, njnt, nv = m.nbody, m.njnt, m.nv

  # --- levels ---------------------------------------------------------------
  level = np.zeros(nbody, np.int32)
  for b in range(1, nbody):
    level[b] = level[int(m.body_parentid[b])] + 1

  # --- kinematics groups: (level, signature) --------------------------------
  def body_sig(b):
    jadr, jnum = int(m.body_jntadr[b]), int(m.body_jntnum[b])
    return tuple(JointType(int(m.jnt_type[jadr + k])) for k in range(jnum))

  groups = {}
  for b in range(1, nbody):
    key = (int(level[b]), body_sig(b))
    groups.setdefault(key, []).append(b)

  kin_groups = []
  for (lvl, sig), ids in sorted(groups.items(), key=lambda kv: kv[0][0]):
    ids = np.asarray(ids, np.int32)
    free = sig == (JointType.FREE,)
    par = m.body_parentid[ids].astype(np.int32)
    jn = len(sig)
    jids = np.stack([m.body_jntadr[ids] + k for k in range(jn)],
                    axis=1).astype(np.int32) if jn else np.zeros(
                        (len(ids), 0), np.int32)
    # concatenated qpos addresses for the signature
    qcols = []
    for k, jt in enumerate(sig):
      base = m.jnt_qposadr[jids[:, k]]
      for c in range(JOINT_NQ[jt]):
        qcols.append(base + c)
    qadr = (np.stack(qcols, axis=1).astype(np.int32) if qcols
            else np.zeros((len(ids), 0), np.int32))
    kin_groups.append(dict(ids=ids, par=par, sig=sig, free=free,
                           jids=jids, qadr=qadr))
  tr.kin_groups = kin_groups
  tr.depth = int(level.max()) if nbody > 1 else 0

  # --- subtree mask: sub[b, c] = 1 iff c is in subtree(b) --------------------
  sub = np.zeros((nbody, nbody))
  for c in range(nbody):
    b = c
    while True:
      sub[b, c] = 1.0
      if b == 0:
        break
      b = int(m.body_parentid[b])
  tr.subtree_mask = sub

  # --- cdof_dot velocity mask ------------------------------------------------
  # dof_before[i, j] = 1 iff dof j's velocity contributes to the spatial
  # velocity used for cdof_dot[i]: all dofs of strict ancestors, dofs of
  # earlier joints on the same body, and (for free-joint rotational dofs)
  # the joint's own translational triple.
  dof_before = np.zeros((nv, nv))
  free_trans = np.zeros(nv, bool)
  for i in range(nv):
    j = int(m.dof_jntid[i])
    b = int(m.dof_bodyid[i])
    p = int(m.body_parentid[b])
    dof_before[i] = m.body_dof_mask[p]
    jadr = int(m.body_jntadr[b])
    for jj in range(jadr, j):
      a = int(m.jnt_dofadr[jj])
      n = JOINT_NV[JointType(int(m.jnt_type[jj]))]
      dof_before[i, a:a + n] = 1.0
    if int(m.jnt_type[j]) == int(JointType.FREE):
      a = int(m.jnt_dofadr[j])
      if i >= a + 3:
        dof_before[i, a:a + 3] = 1.0
      else:
        free_trans[i] = True
  tr.dof_before = dof_before
  tr.free_trans = free_trans

  # --- per-joint-type index sets ----------------------------------------------
  def jids_of(*jts):
    sel = [j for j in range(njnt)
           if JointType(int(m.jnt_type[j])) in jts]
    return np.asarray(sel, np.int32)

  tr.hinge_jids = jids_of(JointType.HINGE)
  tr.slide_jids = jids_of(JointType.SLIDE)
  tr.hs_jids = jids_of(JointType.HINGE, JointType.SLIDE)
  tr.ball_jids = jids_of(JointType.BALL)
  tr.free_jids = jids_of(JointType.FREE)

  def adr_mat(jids, base, n):
    if not len(jids):
      return np.zeros((0, n), np.int32)
    return (base[jids][:, None] + np.arange(n)[None, :]).astype(np.int32)

  tr.hs_qadr = m.jnt_qposadr[tr.hs_jids].astype(np.int32) if len(
      tr.hs_jids) else np.zeros(0, np.int32)
  tr.hs_dadr = m.jnt_dofadr[tr.hs_jids].astype(np.int32) if len(
      tr.hs_jids) else np.zeros(0, np.int32)
  tr.ball_qmat = adr_mat(tr.ball_jids, m.jnt_qposadr, 4)
  tr.ball_dmat = adr_mat(tr.ball_jids, m.jnt_dofadr, 3)
  tr.free_qmat = adr_mat(tr.free_jids, m.jnt_qposadr, 7)
  tr.free_dmat = adr_mat(tr.free_jids, m.jnt_dofadr, 6)
  return tr
