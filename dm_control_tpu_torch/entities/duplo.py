"""An interlocking 2x4 Duplo brick prop.

The port of `dm_control_tpu/entities/duplo.py`: the same MJCF, built with
ElementTree as there, so both packages compose the same XML.  It
re-expresses the reference's Duplo model (entities/props/duplo/
__init__.py:1-174, duplo2x4.xml) for this engine's collider set:

* The brick's retention physics is an interference fit: the studs on a
  lower brick are slightly wider than the gap between the tubes/walls
  inside the brick above, so clicking bricks together stores elastic
  energy in the contact solver and separating them requires force.
* The reference offers cylinder studs or capsule studs (its
  `easy_align` variant, duplo2x4.xml `stud-capsule` class).  Here studs
  are ALWAYS capsules: capsule-cylinder and capsule-box are exact
  analytic pairs in `_src/colliders.py`, while cylinder-cylinder is
  not.  This is the reference's own easy-align geometry, adopted as the
  single configuration.
* Flanges (24 extra sliver boxes per brick in the reference) are
  omitted; retention comes from the stud-tube interference, with the
  outer walls bounding lateral rattle.  Stud radius is autotuned for a
  separation force in the reference's empirical band (see
  the JAX package's `tools/duplo_autotune.py`, the analog of
  entities/props/duplo/autotune.py:1-165).
* Contact bitmask scheme is the reference's: base 3/2, walls+tubes 4/0,
  studs 0/4, so studs engage only the walls/tubes of OTHER bricks and
  bricks rest base-on-base when stacked.

Sites: stud_RC (top, z=.0238) and hole_RC (bottom, z=.0046) for
R in {0,1}, C in {0..3} — used by the stacking rewards exactly like the
reference's `_min_stud_to_hole_distance` (manipulation/bricks.py:420) —
plus 8 bounding-box vertex sites for the Lift reward
(manipulation/lift.py:67-103).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from dm_control_tpu_torch.composer.entity import Entity

# Stud capsule radius: autotuned (tools/duplo_autotune.py, on the JAX
# package's engine) so that the quasistatic separation force of a
# clicked pair lands at the reference's lower-quartile target
# (DESIRED_FORCES.lower_quartile=10 N, autotune.py:36): 0.00478 -> 10..11
# N (0.0047 -> 9..10 N); holds at 9 N for >=1 s, separates at 11 N.
STUD_RADIUS = 0.00478

# Stud/hole site grids (local frame).  Rows along x, columns along y.
_STUD_XY = [(-0.008, -0.024), (-0.008, -0.008), (-0.008, 0.008),
            (-0.008, 0.024), (0.008, -0.024), (0.008, -0.008),
            (0.008, 0.008), (0.008, 0.024)]
STUD_Z = 0.0238
HOLE_Z = 0.0046
# Stacked offset between a stud site below and the matching hole site
# above (= brick height): .0238 - .0046.
STACK_DZ = STUD_Z - HOLE_Z

# Bounding half-extents of the brick body (matches the reference's
# bounding_box site: size .016 .0319 .012 at z .0119).
BBOX_SIZE = np.array([0.016, 0.0319, 0.012])
BBOX_POS = np.array([0.0, 0.0, 0.0119])

_SOLREF = '.01 1'
_SOLIMP = '.99 .999 .001'


def _site_name(kind: str, row: int, col: int) -> str:
  return f'{kind}_{row}{col}'


def duplo_entity(name: str = 'duplo', color=(1.0, 0.0, 0.0),
                 stud_radius: float = STUD_RADIUS,
                 vertex_sites: bool = False,
                 hint: bool = False,
                 free: bool = True) -> Entity:
  """Builds a 2x4 Duplo brick as an attachable Entity.

  Args:
    name: entity name (becomes the attachment prefix).
    color: RGB for the visible shell.
    stud_radius: capsule stud radius (interference-fit control knob).
    vertex_sites: add the 8 bounding-box corner sites used by Lift.
    hint: translucent, contactless, massless-dynamics goal-hint variant
      (reference bricks.py:536-566 `_hintify`); built WITHOUT a
      freejoint so its pose is driven through the model_var body_pos /
      body_quat overlay.
    free: attach with a freejoint (ignored when hint=True).
  """
  r, g, b = color
  alpha = 0.3 if hint else 1.0
  rgba = f'{r} {g} {b} {alpha}'

  root = ET.Element('mujoco')
  wb = ET.SubElement(root, 'worldbody')
  body = ET.SubElement(wb, 'body', dict(name=name))
  if free and not hint:
    ET.SubElement(body, 'freejoint', dict(name=f'{name}_root'))

  def geom(gname, **attrs):
    base = dict(name=gname, solref=_SOLREF, solimp=_SOLIMP,
                friction='.35 .005 .0001', rgba=rgba)
    if hint:
      attrs = dict(attrs, contype='0', conaffinity='0')
    base.update(attrs)
    ET.SubElement(body, 'geom', base)

  # Collision core: one box filling the shell (rests base-on-base when
  # stacked and carries the floor contact), reference class 'base'.
  geom('base', type='box', pos='0 0 0.0096', size='0.0159 0.0318 0.0096',
       contype='3', conaffinity='2', mass='0',
       rgba=f'{r} {g} {b} {0.0 if not hint else 0.0}')
  # Visible shell walls (reference class 'wall', contype 4).
  geom('wall_x0', type='box', pos='-.0151 0 .0088', size='.0008 .0302 .0088',
       contype='4', conaffinity='0')
  geom('wall_x1', type='box', pos='.0151 0 .0088', size='.0008 .0302 .0088',
       contype='4', conaffinity='0')
  geom('wall_y0', type='box', pos='0 -.031 .0088', size='.0159 .0008 .0088',
       contype='4', conaffinity='0')
  geom('wall_y1', type='box', pos='0 .031 .0088', size='.0159 .0008 .0088',
       contype='4', conaffinity='0')
  geom('wall_z1', type='box', pos='0 0 .0184', size='.0159 .0318 .0008',
       contype='4', conaffinity='0')
  # Tubes: the three interior cylinders a stud from below wedges
  # against (reference class 'tube').
  for i, y in enumerate((-0.016, 0.0, 0.016)):
    geom(f'tube_{i}', type='cylinder', pos=f'0 {y} .0098',
         size='.0066999 .0078', density='300',
         contype='4', conaffinity='0')
  # Studs: capsules (easy-align geometry; exact colliders here).
  for i, (x, y) in enumerate(_STUD_XY):
    row, col = divmod(i, 4)
    geom(_site_name('stud', row, col) + '_geom', type='capsule',
         pos=f'{x} {y} .0215', size=f'{stud_radius} .0023',
         density='500', margin='.0001', contype='0', conaffinity='4')

  # Reward sites.
  for i, (x, y) in enumerate(_STUD_XY):
    row, col = divmod(i, 4)
    ET.SubElement(body, 'site', dict(
        name=_site_name('stud', row, col), type='sphere', size='0.001',
        pos=f'{x} {y} {STUD_Z}', rgba='1 0 0 0.3'))
    ET.SubElement(body, 'site', dict(
        name=_site_name('hole', row, col), type='sphere', size='0.001',
        pos=f'{x} {y} {HOLE_Z}', rgba='1 0 0 0.3'))

  if vertex_sites:
    k = 0
    for sx in (-1, 1):
      for sy in (-1, 1):
        for sz in (-1, 1):
          p = BBOX_POS + np.array([sx, sy, sz]) * BBOX_SIZE
          ET.SubElement(body, 'site', dict(
              name=f'vertex_{k}', type='sphere', size='0.002',
              pos=f'{p[0]} {p[1]} {p[2]}', rgba='1 0 0 0.3'))
          k += 1

  return Entity(mjcf_root=root, name=name)


# ---------------------------------------------------------------------------
# Index helpers (resolved once per compiled model).

def corner_site_ids(m, prefix: str):
  """(stud_ids, hole_ids) for the two diagonal corners, the exact pair
  set the reference's reward reads (bricks.py:420-430: studs[[0,-1],
  [0,-1]] == stud_00, stud_13; same for holes)."""
  studs = np.array([m.name2id('site', f'{prefix}/stud_00'),
                    m.name2id('site', f'{prefix}/stud_13')])
  holes = np.array([m.name2id('site', f'{prefix}/hole_00'),
                    m.name2id('site', f'{prefix}/hole_13')])
  return studs, holes


def all_stud_hole_ids(m, prefix: str):
  studs = np.array([m.name2id('site', f'{prefix}/stud_{r}{c}')
                    for r in range(2) for c in range(4)])
  holes = np.array([m.name2id('site', f'{prefix}/hole_{r}{c}')
                    for r in range(2) for c in range(4)])
  return studs, holes


def vertex_site_ids(m, prefix: str):
  return np.array([m.name2id('site', f'{prefix}/vertex_{k}')
                   for k in range(8)])


# Local-frame site positions used to assemble stacks analytically.
STUD_00_LOCAL = np.array([-0.008, -0.024, STUD_Z])
HOLE_00_LOCAL = np.array([-0.008, -0.024, HOLE_Z])
HOLE_13_LOCAL = np.array([0.008, 0.024, HOLE_Z])
