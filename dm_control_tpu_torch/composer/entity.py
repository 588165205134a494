"""Build-time entities: MJCF fragments with observables and batched hooks.

The port of `dm_control_tpu/composer/entity.py`, the functional
replacement for dm_control.composer.Entity (composer/entity.py:199-594):
an Entity owns an XML fragment and `attach()` grafts a child fragment
under a parent body with full name prefixing (the job of PyMJCF
attachment frames, dm_control/mjcf/element.py:903-1046 + namescope.py).
All composition happens before compilation, so the resulting Model is
static.  `attach` and the prefixing are plain ElementTree, as in the JAX
package, so both packages compose the same XML.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Optional
import xml.etree.ElementTree as ET

# attributes that reference names of other elements (must be re-prefixed)
_NAME_REF_ATTRS = (
    'joint', 'site', 'geom', 'body', 'tendon', 'actuator', 'class',
    'childclass', 'material', 'target', 'body1', 'body2', 'geom1', 'geom2',
    'joint1', 'joint2', 'tendon1', 'tendon2', 'objname', 'refname',
    'mesh', 'hfield',
)

_SECTIONS = ('default', 'asset', 'tendon', 'actuator', 'sensor',
             'equality', 'contact', 'keyframe')


@dataclasses.dataclass
class Entity:
  """An attachable model fragment.

  mjcf_root: a <mujoco> element whose worldbody holds the fragment.
  observables: name -> ObservableSpec factory taking the final prefix
    (so index lookups can resolve prefixed names after compilation).

  Lifecycle hooks — the functional analog of the reference's 7-callback
  entity protocol (composer/entity.py:266-291).  Build-time hooks run on
  the host; episode and step hooks take batched (Model, Data), every
  field with the lanes on its leading axis, and draw from the
  torch.Generator they are given:

    mjcf_hook(mjcf_root, random_state)         initialize_episode_mjcf:
        mutate this entity's OWN fragment before (re)compilation; when
        present the composer environment recompiles the model each
        episode (reference environment.py:296-323).
    after_compile_hook(model, prefix)          after_compile: host-side,
        once per compilation.
    init_hook(model, data, generator, prefix)->Data  initialize_episode.
    before_step_hook(m, d, generator, prefix)->Data      before_step
    before_substep_hook(m, d, generator, prefix)->Data   before_substep
    after_substep_hook(m, d, generator, prefix)->Data    after_substep
    after_step_hook(m, d, generator, prefix)->Data       after_step
  """
  mjcf_root: ET.Element
  name: str = 'entity'
  observables: Dict[str, Callable] = dataclasses.field(default_factory=dict)
  init_hook: Optional[Callable] = None    # (m, d, generator, prefix)->Data
  mjcf_hook: Optional[Callable] = None
  after_compile_hook: Optional[Callable] = None
  before_step_hook: Optional[Callable] = None
  before_substep_hook: Optional[Callable] = None
  after_substep_hook: Optional[Callable] = None
  after_step_hook: Optional[Callable] = None

  @classmethod
  def from_xml_string(cls, xml: str, name: str = 'entity', **kw):
    return cls(mjcf_root=ET.fromstring(xml), name=name, **kw)

  @classmethod
  def from_xml_path(cls, path: str, name: str = 'entity', **kw):
    from dm_control_tpu_torch.mjcf.compiler import _load_xml
    return cls(mjcf_root=_load_xml(path), name=name, **kw)

  def prefixed(self, prefix: str) -> ET.Element:
    """Deep copy of the fragment with all names prefixed 'prefix/name'
    (the reference's namescope full_identifier convention).  Defaults
    classes are names too: <default class='x'> DEFINES x, so class /
    childclass references to locally-defined classes are re-prefixed
    along with element names."""
    root = copy.deepcopy(self.mjcf_root)
    local_names = set()
    local_classes = set()
    for el in root.iter():
      if 'name' in el.attrib:
        local_names.add(el.attrib['name'])
      if el.tag == 'default' and 'class' in el.attrib:
        local_classes.add(el.attrib['class'])
    for el in root.iter():
      if 'name' in el.attrib:
        el.attrib['name'] = f'{prefix}/{el.attrib["name"]}'
      if el.tag == 'default':
        if el.attrib.get('class') in local_classes:
          el.attrib['class'] = f'{prefix}/{el.attrib["class"]}'
        continue
      for attr in _NAME_REF_ATTRS:
        ref = el.attrib.get(attr)
        if ref is None:
          continue
        if attr in ('class', 'childclass'):
          if ref in local_classes:
            el.attrib[attr] = f'{prefix}/{ref}'
        elif ref in local_names:
          el.attrib[attr] = f'{prefix}/{ref}'
    return root


def attach(parent_root: ET.Element, child: Entity,
           prefix: Optional[str] = None,
           site_body: Optional[str] = None,
           pos: Optional[str] = None) -> ET.Element:
  """Graft `child`'s worldbody under a body of `parent_root` (or its
  worldbody), merging the non-body sections; returns parent_root."""
  prefix = prefix or child.name
  croot = child.prefixed(prefix)

  pworld = parent_root.find('worldbody')
  target = pworld
  if site_body is not None:
    for el in pworld.iter('body'):
      if el.attrib.get('name') == site_body:
        target = el
        break
    else:
      raise ValueError(f'no body named {site_body!r} in parent')

  # Defaults-aware merge (reference element.py:903-1047 + the compiled
  # model's default-class nesting): the child's WHOLE default tree is
  # wrapped in a '{prefix}/' class nested under the parent's root
  # default, and every grafted element is pointed at it (childclass on
  # bodies, class on free-standing class-bearing elements).  Without
  # this, the child's unclassed defaults would leak onto the parent's
  # elements and vice versa.
  child_defaults = croot.findall('default')
  scope_class = None
  if child_defaults and any(len(cd) for cd in child_defaults):
    scope_class = f'{prefix}/'
    pdef = parent_root.find('default')
    if pdef is None:
      pdef = ET.SubElement(parent_root, 'default')
    wrapper = ET.SubElement(pdef, 'default', {'class': scope_class})
    for cd in child_defaults:
      for el in list(cd):
        wrapper.append(el)

  _CLASS_TAGS = ('geom', 'site', 'joint', 'camera', 'light', 'mesh',
                 'material', 'pair', 'motor', 'position', 'velocity',
                 'general', 'muscle', 'cylinder', 'damper', 'adhesion',
                 'intvelocity', 'spatial', 'fixed', 'connect', 'weld')

  def scope(el):
    if scope_class is None:
      return el
    if el.tag == 'body':
      if 'childclass' not in el.attrib:
        el.set('childclass', scope_class)
    elif el.tag in _CLASS_TAGS and 'class' not in el.attrib:
      el.set('class', scope_class)
    return el

  cworld = croot.find('worldbody')
  if cworld is not None:
    for el in list(cworld):
      if pos is not None and el.tag == 'body':
        el.set('pos', pos)
      target.append(scope(el))

  for section in _SECTIONS:
    if section == 'default':
      continue  # handled above
    for csec in croot.findall(section):
      psec = parent_root.find(section)
      if psec is None:
        psec = ET.SubElement(parent_root, section)
      for el in list(csec):
        psec.append(scope(el))
  return parent_root
