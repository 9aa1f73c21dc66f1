"""MuJoCo model variants for the custom DMControl tasks (a copy of
tdmpc2_tpu/envs/tasks/_models.py).

The reference ships 8 forked XML files (reference: tdmpc2/envs/tasks/*.xml)
whose deltas vs the stock dm_control suite models are tiny: wider ground
planes for the backwards-locomotion tasks, four obstacle walls for
fish-obstacles, and 3-/4-link arm chains for the long reachers. Instead of
forking XML blobs, we derive each variant programmatically from the stock
suite model at load time — the stock XMLs stay the single source of truth
and the patch *is* the documentation of what changed.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

from dm_control import suite as _suite
from dm_control.utils import io as resources

_SUITE_DIR = os.path.dirname(_suite.__file__)


def stock_xml(domain: str) -> str:
    """The stock dm_control suite model for `domain`, as an XML string."""
    return resources.GetResource(os.path.join(_SUITE_DIR, domain + '.xml'))


def _find_geom(root, name):
    for geom in root.iter('geom'):
        if geom.get('name') == name:
            return geom
    raise ValueError(f'geom {name!r} not found')


def widened_arena(domain: str, geom_name: str, half_length: float) -> str:
    """Stock model with a longer ground plane (x half-extent -> half_length).

    Needed so backwards locomotion never runs off the arena
    (reference cheetah.xml: 100->200; walker.xml: 250->500).
    """
    root = ET.fromstring(stock_xml(domain))
    geom = _find_geom(root, geom_name)
    size = geom.get('size').split()
    size[0] = f'{half_length:g}'
    geom.set('size', ' '.join(size))
    return ET.tostring(root, encoding='unicode')


def fish_with_walls() -> str:
    """Stock fish model plus four box obstacles around the tank center
    (reference fish.xml adds wall0..wall3 at (+-.15, +-.15))."""
    root = ET.fromstring(stock_xml('fish'))
    default = root.find('default')
    wall_cls = ET.SubElement(default, 'default', {'class': 'wall'})
    ET.SubElement(wall_cls, 'geom', type='box', material='self')
    world = root.find('worldbody')
    corners = [(-.15, -.15), (.15, -.15), (.15, .15), (-.15, .15)]
    for i, (x, y) in enumerate(corners):
        attrs = {'name': f'wall{i}', 'class': 'wall',
                 'pos': f'{x:g} {y:g} .1', 'size': '.05 .05 .1'}
        ET.SubElement(world, 'geom', attrs)
    return ET.tostring(root, encoding='unicode')


def multilink_reacher(links: int) -> str:
    """Stock reacher with the 2-link arm replaced by a `links`-link chain.

    Geometry matches the reference models (reference
    reacher_three_links.xml / reacher_four_links.xml): upper segments of
    length .09 (3 links) / .06 (4 links), a .1-long hand, all joints after
    the shoulder limited to +-80 deg, one motor per joint.
    """
    assert links in (3, 4), links
    seg = {3: 0.09, 4: 0.06}[links]
    root = ET.fromstring(stock_xml('reacher'))
    root.set('model', f'{links}-link planar reacher')
    world = root.find('worldbody')

    old_arm = next(b for b in world.findall('body') if b.get('name') == 'arm')
    world.remove(old_arm)
    # finger body (innermost), identical to stock but repositioned
    finger = ET.Element('body', name='finger', pos=f'{seg:g} 0 0')
    ET.SubElement(finger, 'camera', name='hand', pos='0 0 .2', mode='track')
    ET.SubElement(finger, 'geom', name='finger', type='sphere', size='.01',
                  material='effector')
    # hand with its wrist joint
    hand = ET.Element('body', name='hand', pos=f'{seg:g} 0 0')
    ET.SubElement(hand, 'geom', name='hand', type='capsule',
                  fromto='0 0 0 0.1 0 0', size='.01', material='self')
    ET.SubElement(hand, 'joint', name='wrist', limited='true', range='-80 80')
    hand.append(finger)
    # upper arm segments arm{links-2} .. arm0, innermost outwards
    inner = hand
    joints = ['wrist']
    for i in reversed(range(links - 1)):
        body = ET.Element(
            'body', name=f'arm{i}',
            pos='0 0 .01' if i == 0 else f'{seg:g} 0 0')
        ET.SubElement(body, 'geom', name=f'arm{i}', type='capsule',
                      fromto=f'0 0 0 {seg:g} 0 0', size='.01', material='self')
        joint = ET.SubElement(body, 'joint', name=f'shoulder{i}')
        if i > 0:  # all but the root joint are range-limited
            joint.set('limited', 'true')
            joint.set('range', '-80 80')
        body.append(inner)
        inner = body
        joints.append(f'shoulder{i}')
    world.append(inner)

    actuator = root.find('actuator')
    for motor in list(actuator):
        actuator.remove(motor)
    for j in reversed(joints):  # shoulder0, shoulder1, ..., wrist
        ET.SubElement(actuator, 'motor', name=j, joint=j)
    return ET.tostring(root, encoding='unicode')
