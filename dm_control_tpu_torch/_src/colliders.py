"""Vectorized narrowphase colliders (torch).

The port of the parts of `dm_control_tpu/_src/colliders.py` the walker
path reaches: contact-parameter mixing, the contact frame, the
plane-capsule collider and the `collide_all` dispatch.  Every other
geom-type pair raises NotImplementedError naming the pair.
"""

from __future__ import annotations

import numpy as np
import torch

from dm_control_tpu_torch._src import math
from dm_control_tpu_torch._src.types import (Contact, Data, GeomType, Model,
                                             mirror)


def _combine_params(m: Model, g1: int, g2: int, pairinfo):
  """(condim, friction(5), solref(2), solimp(5), margin, gap) for a pair."""
  if pairinfo is not None:
    return (pairinfo['condim'], pairinfo['friction'], pairinfo['solref'],
            pairinfo['solimp'], pairinfo['margin'], pairinfo['gap'])
  p1, p2 = int(m.geom_priority[g1]), int(m.geom_priority[g2])
  if p1 != p2:
    g = g1 if p1 > p2 else g2
    condim = int(m.geom_condim[g])
    fr3 = m.geom_friction[g]
    solref = m.geom_solref[g]
    solimp = m.geom_solimp[g]
  else:
    condim = max(int(m.geom_condim[g1]), int(m.geom_condim[g2]))
    fr3 = np.maximum(m.geom_friction[g1], m.geom_friction[g2])
    # solmix weighting
    s1, s2 = float(m.geom_solmix[g1]), float(m.geom_solmix[g2])
    mix = s1 / (s1 + s2) if (s1 + s2) > 1e-12 else 0.5
    if m.geom_solref[g1, 0] > 0 and m.geom_solref[g2, 0] > 0:
      solref = mix * m.geom_solref[g1] + (1 - mix) * m.geom_solref[g2]
    else:
      solref = np.minimum(m.geom_solref[g1], m.geom_solref[g2])
    solimp = mix * m.geom_solimp[g1] + (1 - mix) * m.geom_solimp[g2]
  friction = np.array([fr3[0], fr3[0], fr3[1], fr3[2], fr3[2]])
  margin = max(float(m.geom_margin[g1]), float(m.geom_margin[g2]))
  gap = max(float(m.geom_gap[g1]), float(m.geom_gap[g2]))
  return condim, friction, solref, solimp, margin, gap


def make_frame(normal: torch.Tensor) -> torch.Tensor:
  """(..., 3, 3) frame with rows (normal, tangent1, tangent2).

  The auxiliary seed is the world y axis unless |n_y| > 0.5, then z;
  t2 = normalize(n x seed), t1 = t2 x n (the oracle's mju_makeFrame)."""
  n = math.normalize(normal)
  zero, one = torch.zeros_like(n[..., 0]), torch.ones_like(n[..., 0])
  z = torch.stack([zero, zero, one], -1)
  y = torch.stack([zero, one, zero], -1)
  seed = torch.where(n[..., 1:2].abs() > 0.5, z, y)
  t2 = math.normalize(math.cross(n, seed))
  t1 = math.cross(t2, n)
  return torch.stack([n, t1, t2], dim=-2)


def _plane_capsule(p_pos, p_mat, p_size, c_pos, c_mat, c_size):
  """Two contacts, one at each capsule end; frame t1 along the projected
  capsule axis (the generic frame when the axis is near the normal)."""
  n = p_mat[..., :, 2]
  axis = c_mat[..., :, 2]
  r = c_size[..., 0]
  hl = c_size[..., 1]
  axp = axis - n * (axis * n).sum(-1, keepdim=True)
  ok = (axp * axp).sum(-1, keepdim=True) > 1e-12
  t1 = torch.where(ok, math.normalize(axp), make_frame(n)[..., 1, :])
  t2 = math.cross(n, t1)
  frame = torch.stack([n, t1, t2], dim=-2)
  dists, poss = [], []
  for sign in (1.0, -1.0):
    end = c_pos + sign * hl[..., None] * axis
    h = (n * (end - p_pos)).sum(-1)
    dist = h - r
    dists.append(dist)
    poss.append(end - n * (r + dist / 2)[..., None])
  return (torch.stack(dists, -1), torch.stack(poss, -2),
          torch.stack([frame, frame], -3))


_COLLIDERS = {
    (GeomType.PLANE, GeomType.CAPSULE): _plane_capsule,
}


def collide_all(m: Model, d: Data) -> Data:
  """Narrowphase for every static group, concatenated in group order."""
  from dm_control_tpu_torch._src import collision as coll
  ref = d.qpos
  B = ref.shape[0]
  out = {k: [] for k in ('dist', 'pos', 'frame', 'includemargin', 'friction',
                         'solref', 'solimp', 'geom1', 'geom2', 'body1',
                         'body2', 'dim')}
  for grp in coll.groups(m):
    fn = _COLLIDERS.get((grp.t1, grp.t2))
    if fn is None:
      raise NotImplementedError(
          f'collider for ({grp.t1.name}, {grp.t2.name}) is not ported yet')
    k, K = grp.ncon_per_pair, grp.K
    g1 = mirror(m, ref, grp.g1)
    g2 = mirror(m, ref, grp.g2)
    size1 = mirror(m, ref, m.geom_size[grp.g1])
    size2 = mirror(m, ref, m.geom_size[grp.g2])
    dist, pos, frame = fn(d.geom_xpos[:, g1], d.geom_xmat[:, g1], size1,
                          d.geom_xpos[:, g2], d.geom_xmat[:, g2], size2)
    n = K * k

    def rep(x):
      """Per-pair constant (K, ...) -> per-contact (B, K*k, ...)."""
      x = np.repeat(np.asarray(x), k, axis=0)
      t = mirror(m, ref, x)
      if t.dtype == torch.int64:
        t = t.to(torch.int32)
      return t.expand((B,) + t.shape)

    out['dist'].append(dist.reshape(B, n))
    out['pos'].append(pos.reshape(B, n, 3))
    out['frame'].append(frame.reshape(B, n, 3, 3))
    out['includemargin'].append(rep(grp.margin - grp.gap))
    out['friction'].append(rep(np.broadcast_to(grp.friction, (K, 5))))
    out['solref'].append(rep(grp.solref))
    out['solimp'].append(rep(grp.solimp))
    out['geom1'].append(rep(grp.g1))
    out['geom2'].append(rep(grp.g2))
    out['body1'].append(rep(m.geom_bodyid[grp.g1]))
    out['body2'].append(rep(m.geom_bodyid[grp.g2]))
    out['dim'].append(rep(np.full(K, grp.condim)))
  contact = Contact(**{k: torch.cat(v, dim=1) for k, v in out.items()})
  return d.replace(contact=contact)
