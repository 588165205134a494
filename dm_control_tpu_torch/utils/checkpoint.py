"""Checkpoint and restore of the port's state objects.

The port of `dm_control_tpu/utils/checkpoint.py`.  A `RunnerState` (its
batched `Data` and reset pool included), a `SACState` or a `Replay` saves
as one npz: its leaves as numpy arrays, and its structure (every leaf's
path and kind, in order) recorded beside them, as the JAX package records
the treedef.  `restore` rebuilds an object of the structure of `like`,
each tensor on the device and at the dtype of `like`'s, and rejects a
checkpoint whose structure or whose leaf shapes differ.

Containers walked: dataclasses (by field), `nn.Module`s (by
`state_dict`), dicts (by key), lists and tuples (by index).  Leaves:
tensors, Python ints, floats and bools, and None.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from typing import Any, List, Tuple

import numpy as np
import torch
from torch import nn


def _flatten(tree: Any, path: str, out: List[Tuple[str, str, Any]]) -> None:
  if isinstance(tree, torch.Tensor):
    out.append((path, 'tensor', tree))
  elif isinstance(tree, nn.Module):
    for k, v in tree.state_dict().items():
      out.append((f'{path}.{k}', 'tensor', v))
  elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    for f in dataclasses.fields(tree):
      _flatten(getattr(tree, f.name), f'{path}.{f.name}', out)
  elif isinstance(tree, dict):
    for k in sorted(tree):
      _flatten(tree[k], f'{path}[{k!r}]', out)
  elif isinstance(tree, (list, tuple)):
    for i, v in enumerate(tree):
      _flatten(v, f'{path}[{i}]', out)
  elif tree is None:
    out.append((path, 'none', None))
  elif isinstance(tree, (bool, int, float)):
    out.append((path, type(tree).__name__, tree))
  else:
    raise TypeError(f'{path}: cannot checkpoint a {type(tree).__name__}')


def _structure(tree: Any) -> List[Tuple[str, str, Any]]:
  out: List[Tuple[str, str, Any]] = []
  _flatten(tree, type(tree).__name__, out)
  return out


def save(path: str, tree: Any) -> None:
  leaves = _structure(tree)
  arrays = {}
  for i, (_, kind, x) in enumerate(leaves):
    if kind == 'tensor':
      arrays[f'leaf_{i}'] = x.detach().cpu().numpy()
    elif kind != 'none':
      arrays[f'leaf_{i}'] = np.asarray(x)
  treedef = json.dumps([(p, kind) for p, kind, _ in leaves])
  np.savez_compressed(path, __treedef__=np.frombuffer(
      treedef.encode(), dtype=np.uint8), **arrays)


def _rebuild(like: Any, it) -> Any:
  """`like` with its leaves taken in order from `it`, an iterator of
  restored leaves."""
  if isinstance(like, torch.Tensor):
    return next(it)
  if isinstance(like, nn.Module):
    twin = copy.deepcopy(like)
    state = twin.state_dict()
    twin.load_state_dict({k: next(it) for k in state})
    return twin
  if dataclasses.is_dataclass(like):
    return dataclasses.replace(like, **{
        f.name: _rebuild(getattr(like, f.name), it)
        for f in dataclasses.fields(like)})
  if isinstance(like, dict):
    return {k: _rebuild(like[k], it) for k in sorted(like)}
  if isinstance(like, (list, tuple)):
    return type(like)(_rebuild(v, it) for v in like)
  return next(it)


def restore(path: str, like: Any) -> Any:
  """Restore into the structure of `like` (structure and shapes must
  match)."""
  data = np.load(path)
  leaves = _structure(like)
  saved_def = bytes(data['__treedef__']).decode()
  treedef = json.dumps([(p, kind) for p, kind, _ in leaves])
  if saved_def != treedef:
    raise ValueError(
        f'checkpoint structure mismatch:\nsaved: {saved_def}\n'
        f'expected: {treedef}')
  out = []
  for i, (p, kind, leaf) in enumerate(leaves):
    if kind == 'none':
      out.append(None)
      continue
    arr = data[f'leaf_{i}']
    if np.shape(leaf) != arr.shape:
      raise ValueError(f'leaf {i} ({p}) shape {arr.shape} != '
                       f'{tuple(np.shape(leaf))}')
    if kind == 'tensor':
      out.append(torch.as_tensor(arr, dtype=leaf.dtype, device=leaf.device))
    else:
      out.append({'bool': bool, 'int': int, 'float': float}[kind](arr))
  return _rebuild(like, iter(out))
