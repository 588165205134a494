"""Numpy <-> batch-first Data converters.

States cross between the port and anything else (the JAX package in the
tests, checkpoints, a learner) as a flat dict of numpy arrays keyed by
field name, with the Contact fields under 'contact.<name>' and the
per-lane model overrides (`Data.model_var`, e.g. reacher's target
`geom_pos` or point_mass-hard's tendon coefficients `wrap_prm`) under
'model_var.<name>'.  The tendon fields (`ten_length`, `ten_velocity`,
`ten_J`) cross like every other field.  Every array carries the batch on
its leading axis.  Floating fields take the dtype asked for; integer and
boolean fields keep their own.

A SAC learner's state crosses as a dict of numpy arrays in the JAX
package's `SACState` layout (`sac_state_from_numpy`, `sac_state_to_numpy`).
A composer `BatchedEnvironment`'s carry crosses as its Data's flat dict,
its observation buffers and its substep counters
(`composer_carry_from_numpy`), each `model_var` key with it (the
manipulation tier's `site_pos`, `body_pos`, `body_quat`, `lift_target`,
`duplo_pin`, `duplo_pin_qpos` and the int32 `duplo_order`); the JAX
carry's PRNG key does not cross, since torch generators do not reproduce
`jax.random`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from dm_control_tpu_torch._src.types import Contact, Data


def _to_tensor(x: np.ndarray, device, dtype) -> torch.Tensor:
  x = np.asarray(x)
  if x.dtype.kind == 'f':
    return torch.tensor(x, dtype=dtype, device=device)
  return torch.tensor(x, device=device)


def data_from_numpy(fields: Dict[str, np.ndarray], device,
                    dtype: torch.dtype) -> Data:
  """Batch-first Data from a flat dict of numpy arrays.

  `device` and `dtype` (of the floating fields) are the caller's to name:
  there is no default, so that a state never lands on the CPU at float64
  unasked."""
  contact = Contact(**{
      f.name: _to_tensor(fields['contact.' + f.name], device, dtype)
      for f in dataclasses.fields(Contact)})
  kw = {}
  for f in dataclasses.fields(Data):
    if f.name in ('contact', 'model_var'):
      continue
    kw[f.name] = _to_tensor(fields[f.name], device, dtype)
  model_var = {k[len('model_var.'):]: _to_tensor(x, device, dtype)
               for k, x in fields.items() if k.startswith('model_var.')}
  return Data(contact=contact, model_var=model_var, **kw)


def data_to_numpy(d: Data) -> Dict[str, np.ndarray]:
  """Flat dict of numpy arrays from a batch-first Data."""
  out = {}
  for f in dataclasses.fields(Data):
    if f.name == 'model_var':
      for k, x in (d.model_var or {}).items():
        out['model_var.' + k] = x.detach().cpu().numpy()
      continue
    if f.name == 'contact':
      for cf in dataclasses.fields(Contact):
        out['contact.' + cf.name] = (
            getattr(d.contact, cf.name).detach().cpu().numpy())
      continue
    out[f.name] = getattr(d, f.name).detach().cpu().numpy()
  return out


def composer_carry_from_numpy(fields: Dict[str, np.ndarray],
                              obs_state: Dict[str, Dict[str, np.ndarray]],
                              substep: np.ndarray, device,
                              dtype: torch.dtype):
  """A port `composer.Carry` from the JAX `BatchedEnvironment` carry
  (d, obs_state, substep, key), as numpy, without its key.

  `fields` is the flat dict of the batched Data (`data_from_numpy`'s
  keys, the lanes' `model_var` under 'model_var.<name>'); `obs_state`
  maps each observable to its ring buffer {'values' (B, capacity, ...),
  'visible_at' (B, capacity), 'write_idx' (B,)}; `substep` is (B,).
  Floating buffers take `dtype`; the counters stay int32."""
  from dm_control_tpu_torch.composer.environment import Carry
  buffers = {
      name: {k: (_to_tensor(x, device, dtype) if k == 'values'
                 else torch.tensor(np.asarray(x, np.int32), device=device))
             for k, x in st.items()}
      for name, st in obs_state.items()}
  return Carry(data_from_numpy(fields, device, dtype), buffers,
               torch.tensor(np.asarray(substep, np.int32), device=device))


# ---------------------------------------------------------------------------
# SAC state.
# ---------------------------------------------------------------------------

_NETS = ('actor', 'q1', 'q2')


def _mlp_from_numpy(layers, device, dtype):
  from dm_control_tpu_torch.rl import sac
  sizes = [layers[0]['w'].shape[0]] + [l['w'].shape[1] for l in layers]
  net = sac.MLP(sizes, dtype=dtype, device=device)
  with torch.no_grad():
    for layer, l in zip(net.layers, layers):
      layer.weight.copy_(torch.tensor(np.asarray(l['w']).T, dtype=dtype))
      layer.bias.copy_(torch.tensor(np.asarray(l['b']), dtype=dtype))
  return net


def _mlp_to_numpy(tensors):
  """[{'w', 'b'}] from a network's (weight, bias) tensors in layer order."""
  out = []
  for w, b in zip(tensors[0::2], tensors[1::2]):
    out.append({'w': w.detach().cpu().numpy().T.copy(),
                'b': b.detach().cpu().numpy()})
  return out


def _moments_from_numpy(tree, device, dtype):
  """The JAX package's moment tree (actor, q1, q2, log_alpha), each net a
  list of {'w', 'b'}, as the port's flat list in `SAC.trained`'s order:
  each layer's weight (transposed to nn.Linear's (out, in)), then bias."""
  out = []
  for layers in tree[:3]:
    for l in layers:
      out.append(torch.tensor(np.asarray(l['w']).T, dtype=dtype,
                              device=device))
      out.append(torch.tensor(np.asarray(l['b']), dtype=dtype,
                              device=device))
  out.append(torch.tensor(np.asarray(tree[3]), dtype=dtype, device=device))
  return out


def _moments_to_numpy(flat, state):
  out, i = [], 0
  for name in _NETS:
    n = 2 * len(getattr(state, name).layers)
    out.append(_mlp_to_numpy(flat[i:i + n]))
    i += n
  out.append(flat[i].detach().cpu().numpy())
  return tuple(out)


def sac_state_from_numpy(fields: Dict[str, Any], device,
                         dtype: torch.dtype):
  """A port `SACState` from the JAX package's, as numpy.

  `fields` holds the JAX `SACState`'s fields: 'actor', 'q1', 'q2',
  'q1_target', 'q2_target' (each a list of {'w': (in, out), 'b': (out,)}
  per layer), 'log_alpha' (), 'opt_m' and 'opt_v' (each (actor, q1, q2,
  log_alpha) in that layout) and 'step' ().  `nn.Linear` keeps its weight
  as (out, in), so every `w` is transposed on the way in and out."""
  from dm_control_tpu_torch.rl import sac
  nets = {k: _mlp_from_numpy(fields[k], device, dtype)
          for k in _NETS + ('q1_target', 'q2_target')}
  for k in ('q1_target', 'q2_target'):
    nets[k].requires_grad_(False)
  return sac.SACState(
      **nets,
      log_alpha=torch.tensor(np.asarray(fields['log_alpha']), dtype=dtype,
                             device=device),
      opt_m=_moments_from_numpy(fields['opt_m'], device, dtype),
      opt_v=_moments_from_numpy(fields['opt_v'], device, dtype),
      step=torch.tensor(np.asarray(fields['step']), dtype=torch.int32,
                        device=device))


def sac_state_to_numpy(state) -> Dict[str, Any]:
  """The JAX package's `SACState` layout, as numpy, of a port `SACState`
  (`sac_state_from_numpy`'s inverse)."""
  out = {k: _mlp_to_numpy(list(getattr(state, k).parameters()))
         for k in _NETS + ('q1_target', 'q2_target')}
  out['log_alpha'] = state.log_alpha.detach().cpu().numpy()
  out['opt_m'] = _moments_to_numpy(state.opt_m, state)
  out['opt_v'] = _moments_to_numpy(state.opt_v, state)
  out['step'] = state.step.cpu().numpy()
  return out
