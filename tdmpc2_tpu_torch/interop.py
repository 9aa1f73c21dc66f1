"""Parameters and checkpoints from the JAX package into the port.

`params_from_jax` maps a JAX parameter pytree whose leaves are numpy arrays
(what `TDMPC2.save` pickles, or `jax.tree.map(np.asarray, params)`) onto the
port's pytree: the same dict keys and tuple positions, torch tensors for
leaves, bf16 upcast to f32 as the JAX agent does on load
(tdmpc2_tpu/tdmpc2.py:320-323).

`opt_states_from_jax` carries optax's Adam moments of both optimiser chains
across, from a live JAX TrainState or from a pickled one alike (the same
namedtuple fields); `state_from_jax` carries a whole JAX TrainState:
parameters, target Q heads, both optimiser states, the running scale and
the planner's per-env warm starts, so one JAX state and one port state take
the same update step and plan from the same means. `fleet_states_from_jax`
cuts a JAX fleet's seed-stacked TrainState into the port's K states.

`load_blob` reads a checkpoint file (pickle, gzip-sniffed) of the JAX
package or of the port without `jax`, `optax` or `ml_dtypes`: a restricted
unpickler admits numpy's array reconstructor (under both numpy 1 and numpy
2 module names) and dtype, `ml_dtypes.bfloat16`, whose raw 2-byte
words are widened to f32 as `(u32 << 16).view(f32)` (exact: a bf16 value
is the upper half of its f32), and the optax state classes the JAX
checkpoints hold, each as a port-owned namedtuple with optax's fields in
optax's order. Any other class raises `pickle.UnpicklingError`.
"""

from __future__ import annotations

import dataclasses
import gzip
import pickle
from types import SimpleNamespace
from typing import Any, NamedTuple

import numpy as np
import torch


def _leaf(x, device):
    x = np.asarray(x)
    if x.dtype.kind == 'V' or x.dtype.name == 'bfloat16':
        # ml_dtypes bf16: torch.from_numpy rejects it; upcast on the numpy side
        x = x.astype(np.float32)
    elif x.dtype.kind == 'f':
        x = x.astype(np.float32)
    else:
        x = np.array(x)         # a tensor of its own: load_blob's are read-only
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def params_from_jax(tree, device='cpu'):
    """JAX pytree of numpy leaves -> the port's pytree of f32 tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(params_from_jax(v, device) for v in tree)
    return _leaf(tree, device)


def _adam_from_optax(adam, select, device):
    """A ScaleByAdamState (count, mu, nu) -> the port's Adam state, its
    moment trees cut to the subtree `select` picks."""
    return {'count': torch.tensor(np.asarray(adam.count), device=device),
            'mu': params_from_jax(select(adam.mu), device),
            'nu': params_from_jax(select(adam.nu), device)}


def opt_states_from_jax(opt_state, pi_opt_state, device='cpu'):
    """optax's states of the JAX agent's two chains (tdmpc2.py:102-114) ->
    (the port's model optimiser state {'enc', 'rest'}, the policy's). The
    model chain's state is (clip, partition), whose 'enc' and 'rest' Adam
    moments are masked to their group; the policy chain's is
    (clip, (adam, scale)). Takes a live state or one `load_blob` read."""
    from tdmpc2_tpu_torch.ops.optim import model_groups
    inner = opt_state[1].inner_states
    model = {g: _adam_from_optax(inner[g].inner_state[0],
                                 lambda t, g=g: model_groups(t)[g], device)
             for g in ('enc', 'rest')}
    return model, _adam_from_optax(pi_opt_state[1][0], lambda t: t, device)


def state_from_jax(state, device='cpu'):
    """A JAX TrainState (tdmpc2_tpu/tdmpc2.py:42-50) -> the port's
    TrainState (its PRNG key apart: the port draws from torch generators)."""
    from tdmpc2_tpu_torch.tdmpc2 import TrainState
    opt_state, pi_opt_state = opt_states_from_jax(state.opt_state,
                                                  state.pi_opt_state, device)
    return TrainState(
        params=params_from_jax(state.params, device),
        target_Qs=params_from_jax(state.target_Qs, device),
        opt_state=opt_state,
        pi_opt_state=pi_opt_state,
        scale=torch.tensor(np.asarray(state.scale, np.float32), device=device),
        prev_mean=_leaf(state.prev_mean, device))


def _seed_slice(tree, k: int):
    """Leaf [k] of every array leaf of a JAX pytree of numpy leaves (dicts,
    tuples, namedtuples such as optax's states, dataclasses such as the
    TrainState); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _seed_slice(v, k) for key, v in tree.items()}
    if hasattr(tree, '_fields'):
        return type(tree)(*(_seed_slice(v, k) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_seed_slice(v, k) for v in tree)
    if dataclasses.is_dataclass(tree):
        return SimpleNamespace(**{f.name: _seed_slice(getattr(tree, f.name), k)
                                  for f in dataclasses.fields(tree)})
    return np.asarray(tree)[k]


def fleet_states_from_jax(state, device='cpu') -> list:
    """A JAX `FleetAgent.state` (every leaf with a leading [K] seed axis,
    numpy leaves: `jax.tree.map(np.asarray, fleet.state)`) -> the port's K
    TrainStates, seed k's from leaf [k] (JAX fleet.py:49-53), for
    `FleetAgent.load_states`."""
    k_seeds = int(np.asarray(state.scale).shape[0])
    return [state_from_jax(_seed_slice(state, k), device)
            for k in range(k_seeds)]


# ------------------------------------------------------ reading a checkpoint

# optax's state classes as the committed JAX checkpoints name them, with
# optax's fields in optax's order (a namedtuple pickles as its class and its
# fields)
class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: Any
    mu: Any
    nu: Any


class PartitionState(NamedTuple):
    inner_states: Any


class MaskedState(NamedTuple):
    inner_state: Any


class MaskedNode(NamedTuple):
    pass


class _BF16:
    """`ml_dtypes.bfloat16` as the pickle names it: a marker, never built."""


class _BF16Dtype:
    """The dtype of a bf16 array: its raw words are 2-byte bf16 values. The
    dtype's pickled state (byte order, sizes) is a bf16's and is not read."""

    def __setstate__(self, state):
        pass


_BF16_DTYPE = _BF16Dtype()


def _dtype(obj, align=False, copy=False):
    if obj is _BF16:
        return _BF16_DTYPE
    return np.dtype(obj, align, copy)


def _from_bytes(raw, dtype, shape, order='C'):
    """An array over the bytes `raw` (read-only, no copy), bf16 widened."""
    if not isinstance(raw, (bytes, bytearray)):
        raise pickle.UnpicklingError('an array of Python objects is not read')
    if isinstance(dtype, _BF16Dtype):
        words = np.frombuffer(raw, np.uint16)
        arr = (words.astype(np.uint32) << 16).view(np.float32)
    else:
        arr = np.frombuffer(raw, dtype)
    return arr.reshape(shape, order=order)


class _Array:
    """What numpy's `_reconstruct` returns: an array its __setstate__ fills.
    `_resolve` puts the array in its place once the pickle is read."""

    def __setstate__(self, state):
        _, shape, dtype, fortran, raw = state   # numpy's (version, ...)
        self.array = _from_bytes(raw, dtype, shape, 'F' if fortran else 'C')


def _reconstruct(cls, shape, typecode):
    if cls is not np.ndarray:
        raise pickle.UnpicklingError(f'not an ndarray: {cls}')
    return _Array()


_ALLOWED = {
    ('numpy', 'ndarray'): np.ndarray,
    ('numpy', 'dtype'): _dtype,
    ('ml_dtypes', 'bfloat16'): _BF16,
    ('optax._src.base', 'EmptyState'): EmptyState,
    ('optax._src.transform', 'ScaleByAdamState'): ScaleByAdamState,
    ('optax.transforms._combining', 'PartitionState'): PartitionState,
    ('optax.transforms._masking', 'MaskedState'): MaskedState,
    ('optax.transforms._masking', 'MaskedNode'): MaskedNode,
}
# numpy 2 writes numpy._core.*, numpy 1 numpy.core.*: both are read, and
# neither is looked up in the installed numpy
for _core in ('numpy.core', 'numpy._core'):
    _ALLOWED[(f'{_core}.multiarray', '_reconstruct')] = _reconstruct


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return _ALLOWED[(module, name)]
        except KeyError:
            raise pickle.UnpicklingError(
                f'a checkpoint may not name {module}.{name}') from None


def _resolve(obj):
    """The unpickled tree with each `_Array` replaced by its array."""
    if isinstance(obj, _Array):
        return obj.array
    if isinstance(obj, dict):
        return {k: _resolve(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_resolve(v) for v in obj]
    if isinstance(obj, tuple):
        items = [_resolve(v) for v in obj]
        return type(obj)(*items) if hasattr(obj, '_fields') else tuple(items)
    return obj


def load_blob(path) -> dict:
    """Read a checkpoint of the JAX package or of the port (plain or gzipped
    pickle) into a dict of numpy arrays, optax-like namedtuples and Python
    values, without `jax`, `optax` or `ml_dtypes`. bf16 arrays come back as
    f32; other arrays are read-only views of the file's bytes (copy before
    writing). The file is read as a stream: its bytes are held once."""
    with open(path, 'rb') as f:
        magic = f.read(2)
    opener = gzip.open if magic == b'\x1f\x8b' else open
    with opener(str(path), 'rb') as f:
        return _resolve(_Unpickler(f).load())
