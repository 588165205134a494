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
"""

from __future__ import annotations

import dataclasses
from typing import Dict

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
