"""The port's walker Model and Data bridge against the JAX package.

The port compiles its own copy of walker.xml with its own copy of the
compiler and finalizes the constants with its own torch set_const; every
Model field must match `dm_control_tpu._src.engine.load_model` (exact for
everything the compiler emits, 1e-12 scaled for the set_const outputs).
The bridge must carry a JAX Data into the port and back exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dm_control_tpu._src import engine as jax_engine
from dm_control_tpu._src import forward as jax_forward
from dm_control_tpu.suite import common as jax_common
from dm_control_tpu_torch import bridge
from dm_control_tpu_torch._src import engine
from dm_control_tpu_torch.suite import common

# outputs of set_const: floating-point results of a linear solve, held
# to 1e-12 scaled (torch and XLA sum in different orders)
SETCONST_FIELDS = ('dof_invweight0', 'body_invweight0', 'actuator_acc0',
                   'stat_meaninertia')


@pytest.fixture(scope='module')
def models():
  ref = jax_engine.load_model(jax_common.model_path('walker.xml'))
  port = engine.load_model(common.model_path('walker.xml'), device='cpu')
  return ref, port


def _assert_same(name, a, b):
  if isinstance(a, dict):
    assert isinstance(b, dict) and a.keys() == b.keys(), name
    for k in a:
      _assert_same(f'{name}[{k!r}]', a[k], b[k])
  elif isinstance(a, (list, tuple)):
    assert len(a) == len(b), name
    for i, (x, y) in enumerate(zip(a, b)):
      _assert_same(f'{name}[{i}]', x, y)
  elif dataclasses.is_dataclass(a):
    for f in dataclasses.fields(a):
      _assert_same(f'{name}.{f.name}', getattr(a, f.name),
                   getattr(b, f.name))
  elif a is None or isinstance(a, (str, int, float, bool)):
    assert a == b, f'{name}: {a!r} != {b!r}'
  else:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, name
    np.testing.assert_array_equal(a, b, err_msg=name)


def test_model_fields_match_jax(models):
  ref, port = models
  names = [f.name for f in dataclasses.fields(ref)]
  assert names == [f.name for f in dataclasses.fields(port)]
  for name in names:
    if name in SETCONST_FIELDS:
      continue
    _assert_same(name, getattr(ref, name), getattr(port, name))


@pytest.mark.parametrize('name', SETCONST_FIELDS)
def test_setconst_outputs_match_jax(models, name):
  ref, port = models
  a = np.asarray(getattr(ref, name), np.float64)
  b = np.asarray(getattr(port, name), np.float64)
  assert a.shape == b.shape
  err = np.abs(a - b) / np.maximum(1.0, np.abs(a))
  assert err.max(initial=0.0) <= 1e-12, f'{name}: {err.max():.2e}'


def test_model_without_cuda_needs_explicit_cpu():
  if torch.cuda.is_available():
    pytest.skip('a CUDA device is present: the default device is valid')
  with pytest.raises(RuntimeError, match='device="cpu"'):
    engine.load_model(common.model_path('walker.xml'))


def test_bridge_round_trip_of_jax_data(models):
  ref, _ = models
  rng = np.random.RandomState(0)
  qpos = ref.qpos0 + 0.3 * rng.randn(4, ref.nq)
  qvel = rng.randn(4, ref.nv)

  def one(q, v):
    d = jax_forward.make_data(ref)
    return jax_forward.forward(ref, d.replace(qpos=q, qvel=v))

  dj = jax.jit(jax.vmap(one))(jnp.asarray(qpos), jnp.asarray(qvel))
  fields = {f.name: np.asarray(getattr(dj, f.name))
            for f in dataclasses.fields(dj)
            if f.name not in ('contact', 'model_var')}
  fields.update({'contact.' + f.name: np.asarray(getattr(dj.contact, f.name))
                 for f in dataclasses.fields(dj.contact)})
  d = bridge.data_from_numpy(fields, device='cpu', dtype=torch.float64)
  back = bridge.data_to_numpy(d)
  assert back.keys() == fields.keys()
  for k, v in fields.items():
    assert back[k].dtype == v.dtype, k
    np.testing.assert_array_equal(back[k], v, err_msg=k)
