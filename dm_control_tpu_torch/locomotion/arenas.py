"""Procedural arenas (reference: locomotion/arenas/floors.py:30,
corridors.py:75,181,340).

The port of `dm_control_tpu/locomotion/arenas.py`: arenas are composer
Entities whose XML is generated at build time with numpy and ElementTree
(the same text as the JAX package's), so batched environments share one
compiled model."""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from dm_control_tpu_torch.composer.entity import Entity


def _base(timestep=0.0025):
  root = ET.Element('mujoco')
  ET.SubElement(root, 'option', dict(timestep=str(timestep)))
  ET.SubElement(root, 'worldbody')
  return root


def floor(size=(8.0, 8.0), name='floor', timestep=0.0025) -> Entity:
  """An infinite-plane floor arena (reference arenas/floors.py:30)."""
  root = _base(timestep)
  wb = root.find('worldbody')
  ET.SubElement(wb, 'geom', dict(
      name='groundplane', type='plane',
      size=f'{size[0]} {size[1]} 0.25', friction='0.7 0.005 0.0001'))
  return Entity(mjcf_root=root, name=name)


def empty_corridor(length=40.0, width=4.0, timestep=0.0025) -> Entity:
  """EmptyCorridor (reference arenas/corridors.py:75): a floor strip with
  side walls running along +x."""
  root = _base(timestep)
  wb = root.find('worldbody')
  ET.SubElement(wb, 'geom', dict(
      name='floor', type='plane', pos=f'{length / 2} 0 0',
      size=f'{length / 2 + 1} {width / 2} 0.25'))
  for sign, tag in ((1.0, 'left'), (-1.0, 'right')):
    ET.SubElement(wb, 'geom', dict(
        name=f'wall_{tag}', type='box',
        pos=f'{length / 2} {sign * (width / 2 + 0.1)} 0.5',
        size=f'{length / 2 + 1} 0.1 0.5'))
  return Entity(mjcf_root=root, name='corridor')


def gaps_corridor(length=40.0, width=4.0, platform_length=2.5,
                  gap_length=0.5, timestep=0.0025) -> Entity:
  """GapsCorridor (reference arenas/corridors.py:181): floor platforms
  separated by gaps over a lethal ground plane."""
  root = _base(timestep)
  wb = root.find('worldbody')
  ET.SubElement(wb, 'geom', dict(
      name='lava', type='plane', pos=f'{length / 2} 0 -1',
      size=f'{length / 2 + 2} {width / 2 + 2} 0.25'))
  x = 0.0
  i = 0
  while x < length:
    plen = platform_length if i else 3.0  # longer start platform
    ET.SubElement(wb, 'geom', dict(
        name=f'platform_{i}', type='box',
        pos=f'{x + plen / 2} 0 -0.25',
        size=f'{plen / 2} {width / 2} 0.25'))
    x += plen + gap_length
    i += 1
  for sign, tag in ((1.0, 'left'), (-1.0, 'right')):
    ET.SubElement(wb, 'geom', dict(
        name=f'wall_{tag}', type='box',
        pos=f'{length / 2} {sign * (width / 2 + 0.1)} 0.5',
        size=f'{length / 2 + 1} 0.1 0.5'))
  return Entity(mjcf_root=root, name='corridor')


def generate_maze(n_cells=7, seed=0):
  """Recursive-backtracker maze on an n x n cell grid (build time,
  replaces the reference's labmaze C++ dependency —
  arenas/mazes.py:28,54).  Returns a (2n+1, 2n+1) bool wall grid where
  odd-odd entries are cells (always open)."""
  rng = np.random.RandomState(seed)
  g = 2 * n_cells + 1
  walls = np.ones((g, g), bool)
  stack = [(0, 0)]
  visited = np.zeros((n_cells, n_cells), bool)
  visited[0, 0] = True
  walls[1, 1] = False
  while stack:
    cx, cy = stack[-1]
    nbrs = [(cx + dx, cy + dy, dx, dy)
            for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1))
            if 0 <= cx + dx < n_cells and 0 <= cy + dy < n_cells
            and not visited[cx + dx, cy + dy]]
    if not nbrs:
      stack.pop()
      continue
    nx, ny, dx, dy = nbrs[rng.randint(len(nbrs))]
    visited[nx, ny] = True
    walls[2 * nx + 1, 2 * ny + 1] = False
    walls[2 * cx + 1 + dx, 2 * cy + 1 + dy] = False
    stack.append((nx, ny))
  return walls


def maze(n_cells=7, cell_size=2.0, wall_height=1.0, seed=0,
         timestep=0.0025):
  """MazeWithTargets-style arena (reference arenas/mazes.py:45-300):
  procedural maze walls over a floor.  Returns (entity, open_positions)
  where open_positions is the (K, 2) array of cell centers usable as
  spawn/target sites (the role of labmaze's spawn/object tokens)."""
  walls = generate_maze(n_cells, seed)
  g = walls.shape[0]
  half = g * cell_size / 4.0          # grid unit = cell_size / 2
  unit = cell_size / 2.0
  root = _base(timestep)
  wb = root.find('worldbody')
  ET.SubElement(wb, 'geom', dict(
      name='floor', type='plane', size=f'{half + 1} {half + 1} 0.25',
      friction='0.7 0.005 0.0001'))

  def center(i, j):
    return ((i + 0.5) * unit - half, (j + 0.5) * unit - half)

  # greedy covering of wall cells with merged horizontal boxes
  # (the role of the reference's covering.py wall decomposition)
  used = np.zeros_like(walls)
  k = 0
  for j in range(g):
    i = 0
    while i < g:
      if walls[i, j] and not used[i, j]:
        i0 = i
        while i < g and walls[i, j] and not used[i, j]:
          used[i, j] = True
          i += 1
        x0, y0 = center(i0, j)
        x1, _ = center(i - 1, j)
        ET.SubElement(wb, 'geom', dict(
            name=f'wall_{k}', type='box',
            pos=f'{(x0 + x1) / 2} {y0} {wall_height / 2}',
            size=f'{(x1 - x0 + unit) / 2} {unit / 2} '
                 f'{wall_height / 2}'))
        k += 1
      else:
        i += 1
  open_positions = np.array(
      [center(i, j) for i in range(g) for j in range(g)
       if not walls[i, j]])
  return Entity(mjcf_root=root, name='maze'), open_positions


def bowl_heights(res=64, rim=0.9):
  """Normalized bowl heightfield in [0, 1]: flat center, quartic rise to
  the rim (reference arenas/bowl.py:38 semantics)."""
  xs = np.linspace(-1, 1, res)
  r = np.sqrt(xs[None, :] ** 2 + xs[:, None] ** 2)
  h = np.clip((r / rim) ** 4, 0.0, 1.0)
  return h


def bowl(radius=8.0, depth=2.0, res=64, timestep=0.0025):
  """Heightfield bowl arena (reference arenas/bowl.py:38).  Returns
  (entity, heights) — heights must be written into
  model_var['hfield_data'] by the task's init hook (hfield assets
  compile with zero data; see locomotion/tasks.py escape)."""
  root = _base(timestep)
  asset = ET.SubElement(root, 'asset')
  ET.SubElement(asset, 'hfield', dict(
      name='bowl', nrow=str(res), ncol=str(res),
      size=f'{radius} {radius} {depth} 0.1'))
  wb = root.find('worldbody')
  ET.SubElement(wb, 'geom', dict(
      name='terrain', type='hfield', hfield='bowl', pos='0 0 -0.01'))
  return Entity(mjcf_root=root, name='bowl'), bowl_heights(res)


def walls_corridor(length=40.0, width=4.0, wall_gap=2.0, wall_width=1.2,
                   rng_seed=0, timestep=0.0025) -> Entity:
  """WallsCorridor (reference arenas/corridors.py:340): staggered wall
  obstacles the walker must slalom through."""
  root = _base(timestep)
  wb = root.find('worldbody')
  ET.SubElement(wb, 'geom', dict(
      name='floor', type='plane', pos=f'{length / 2} 0 0',
      size=f'{length / 2 + 1} {width / 2} 0.25'))
  rng = np.random.RandomState(rng_seed)
  x = 4.0
  i = 0
  while x < length:
    side = 1.0 if i % 2 == 0 else -1.0
    y = side * (width / 2 - wall_width / 2)
    ET.SubElement(wb, 'geom', dict(
        name=f'obstacle_{i}', type='box', pos=f'{x} {y} 0.5',
        size=f'0.1 {wall_width / 2} 0.5'))
    x += wall_gap + rng.uniform(0, 1.0)
    i += 1
  for sign, tag in ((1.0, 'left'), (-1.0, 'right')):
    ET.SubElement(wb, 'geom', dict(
        name=f'wall_{tag}', type='box',
        pos=f'{length / 2} {sign * (width / 2 + 0.1)} 0.5',
        size=f'{length / 2 + 1} 0.1 0.5'))
  return Entity(mjcf_root=root, name='corridor')
