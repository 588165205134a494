"""Collision candidate groups (static, host numpy) and the collide stage.

The port of `dm_control_tpu/_src/collision.py`.  Candidate pairs are
enumerated once per Model and grouped by (geom-type pair, condim,
friction), so each group is one batched narrowphase call with static
shapes.  A group larger than `Option.broadphase_threshold`, or a plane
group larger than a positive `Option.broadphase_plane_cap`, is dynamic:
each step a top-K broadphase (`colliders.collide_all`) selects, per
lane, the K pairs of smallest broadphase score and only those run
narrowphase, so the contact capacity and the efc layout stay static.
"""

from __future__ import annotations

from typing import List

import numpy as np

from dm_control_tpu_torch._src.types import Data, DisableBit, GeomType, Model

# max contact points each type-pair collider can emit
_PAIR_NCON = {
    (GeomType.PLANE, GeomType.SPHERE): 1,
    (GeomType.PLANE, GeomType.CAPSULE): 2,
    (GeomType.PLANE, GeomType.CYLINDER): 4,
    (GeomType.PLANE, GeomType.ELLIPSOID): 1,
    (GeomType.PLANE, GeomType.BOX): 4,
    (GeomType.SPHERE, GeomType.SPHERE): 1,
    (GeomType.SPHERE, GeomType.CAPSULE): 1,
    (GeomType.SPHERE, GeomType.CYLINDER): 1,
    (GeomType.SPHERE, GeomType.ELLIPSOID): 1,
    (GeomType.SPHERE, GeomType.BOX): 1,
    (GeomType.SPHERE, GeomType.MESH): 1,
    (GeomType.PLANE, GeomType.MESH): 3,
    (GeomType.CAPSULE, GeomType.CAPSULE): 2,
    (GeomType.CAPSULE, GeomType.CYLINDER): 2,
    (GeomType.CAPSULE, GeomType.ELLIPSOID): 1,
    (GeomType.CAPSULE, GeomType.BOX): 2,
    (GeomType.CAPSULE, GeomType.MESH): 2,
    (GeomType.ELLIPSOID, GeomType.ELLIPSOID): 1,
    (GeomType.ELLIPSOID, GeomType.BOX): 1,
    (GeomType.ELLIPSOID, GeomType.CYLINDER): 1,
    (GeomType.CYLINDER, GeomType.CYLINDER): 2,
    (GeomType.CYLINDER, GeomType.BOX): 4,
    (GeomType.BOX, GeomType.BOX): 8,
    (GeomType.BOX, GeomType.MESH): 1,
    (GeomType.MESH, GeomType.MESH): 1,
    (GeomType.HFIELD, GeomType.SPHERE): 1,
    (GeomType.HFIELD, GeomType.CAPSULE): 2,
    (GeomType.HFIELD, GeomType.ELLIPSOID): 1,
    (GeomType.HFIELD, GeomType.CYLINDER): 4,
}


class PairGroup:
  """One batched narrowphase group (uniform type pair/condim/friction)."""

  def __init__(self, t1, t2, condim, friction, pairs, params, K):
    self.t1, self.t2 = t1, t2
    self.condim = condim
    self.friction = friction               # (5,) shared by the group
    self.g1 = np.asarray([p[0] for p in pairs], np.int32)
    self.g2 = np.asarray([p[1] for p in pairs], np.int32)
    self.npairs = len(pairs)
    self.K = K                             # pairs run through narrowphase
    self.dynamic = K < self.npairs         # selected per lane and step
    self.ncon_per_pair = _PAIR_NCON[(t1, t2)]
    self.ncon = self.K * self.ncon_per_pair
    self.solref = np.asarray([p['solref'] for p in params])
    self.solimp = np.asarray([p['solimp'] for p in params])
    self.margin = np.asarray([p['margin'] for p in params])
    self.gap = np.asarray([p['gap'] for p in params])


def groups(m: Model) -> List[PairGroup]:
  cached = m.__dict__.get('_pair_groups')
  if cached is not None:
    return cached
  out = _build_groups(m)
  m.__dict__['_pair_groups'] = out
  return out


def _build_groups(m: Model) -> List[PairGroup]:
  from dm_control_tpu_torch._src import colliders
  if m.collision_pairs is None:
    return []
  if m.opt.disableflags & (DisableBit.CONTACT | DisableBit.CONSTRAINT):
    return []
  threshold = int(m.opt.broadphase_threshold)
  cap = int(m.opt.broadphase_cap)
  plane_cap = int(m.opt.broadphase_plane_cap)

  keyed = {}
  for (t1, t2), lst in sorted(m.collision_pairs.items()):
    tp = (GeomType(t1), GeomType(t2))
    if tp not in _PAIR_NCON:
      raise NotImplementedError(
          f'collider for ({tp[0].name}, {tp[1].name}) is not ported yet')
    for g1, g2, pairinfo in lst:
      condim, friction, solref, solimp, margin, gap = (
          colliders._combine_params(m, g1, g2, pairinfo))
      key = (tp, condim, tuple(np.asarray(friction, np.float64)))
      keyed.setdefault(key, []).append(
          ((g1, g2), dict(solref=solref, solimp=solimp,
                          margin=margin, gap=gap)))

  out = []
  for (tp, condim, friction), entries in sorted(
      keyed.items(), key=lambda kv: (kv[0][0][0], kv[0][0][1], kv[0][1])):
    pairs = [e[0] for e in entries]
    if tp[0] == GeomType.PLANE and 0 < plane_cap < len(pairs):
      # plane scores are the exact narrowphase distances: the selection is
      # exact unless more than plane_cap pairs are within margin at once
      K = plane_cap
    else:
      K = len(pairs) if len(pairs) <= threshold else min(len(pairs), cap)
    out.append(PairGroup(tp[0], tp[1], condim, np.asarray(friction), pairs,
                         [e[1] for e in entries], K))
  return out


def count_max_contacts(m: Model) -> int:
  return sum(g.ncon for g in groups(m))


def contact_slots(m: Model, ga: int, gb: int) -> np.ndarray:
  """Contact-buffer slots of geom pair (ga, gb), the same in every lane.

  Only a pair of a static group has such slots: the pair's slots are
  empty if it never collides, and a pair of a dynamic (top-K) group
  raises, as its slots change from lane to lane and step to step."""
  out = []
  base = 0
  want = {int(ga), int(gb)}
  for grp in groups(m):
    k = grp.ncon_per_pair
    for i, (g1, g2) in enumerate(zip(grp.g1, grp.g2)):
      if {int(g1), int(g2)} == want:
        if grp.dynamic:
          raise ValueError(
              f'pair {sorted(want)} is selected by the top-K broadphase; its '
              f'contact slots are not static')
        out.extend(range(base + i * k, base + (i + 1) * k))
    base += grp.ncon
  return np.asarray(out, np.int32)


def collide(m: Model, d: Data) -> Data:
  """Run all narrowphase colliders; fill the padded Contact buffer."""
  if count_max_contacts(m) == 0:
    return d
  from dm_control_tpu_torch._src import colliders
  return colliders.collide_all(m, d)
