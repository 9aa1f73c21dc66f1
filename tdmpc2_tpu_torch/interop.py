"""Parameters from the JAX package into the port.

`params_from_jax` maps a JAX parameter pytree whose leaves are numpy arrays
(what `TDMPC2.save` pickles, or `jax.tree.map(np.asarray, params)`) onto the
port's pytree: the same dict keys and tuple positions, torch tensors for
leaves, bf16 upcast to f32 as the JAX agent does on load
(tdmpc2_tpu/tdmpc2.py:320-323).

`state_from_jax` carries a whole JAX TrainState across: parameters, the
target Q heads, optax's Adam moments of both optimiser chains, the
running scale and the planner's per-env warm starts, so one JAX state and
one port state take the same update step and plan from the same means.

`load_blob` reads a JAX checkpoint file (pickle, gzip-sniffed). The
committed checkpoints (results/checkpoints/*.pkl.gz) hold ml_dtypes bf16
arrays, and unpickling those imports `ml_dtypes`; so `load_blob` is a
CPU/test utility for machines that have that package, not part of the
path that runs on the card.
"""

from __future__ import annotations

import gzip
import pickle

import numpy as np
import torch


def _leaf(x, device):
    x = np.asarray(x)
    if x.dtype.kind == 'V' or x.dtype.name == 'bfloat16':
        # ml_dtypes bf16: torch.from_numpy rejects it; upcast on the numpy side
        x = x.astype(np.float32)
    elif x.dtype.kind == 'f':
        x = x.astype(np.float32)
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


def state_from_jax(state, device='cpu'):
    """A JAX TrainState (tdmpc2_tpu/tdmpc2.py:42-50) -> the port's
    TrainState. The model chain's state is optax's
    (clip, multi_transform) pair, whose 'enc' and 'rest' Adam moments are
    masked to their group; the policy chain's is (clip, (adam, scale))."""
    from tdmpc2_tpu_torch.ops.optim import model_groups
    from tdmpc2_tpu_torch.tdmpc2 import TrainState
    params = params_from_jax(state.params, device)
    inner = state.opt_state[1].inner_states
    opt_state = {
        g: _adam_from_optax(inner[g].inner_state[0],
                            lambda t, g=g: model_groups(t)[g], device)
        for g in ('enc', 'rest')}
    return TrainState(
        params=params,
        target_Qs=params_from_jax(state.target_Qs, device),
        opt_state=opt_state,
        pi_opt_state=_adam_from_optax(state.pi_opt_state[1][0],
                                      lambda t: t, device),
        scale=torch.tensor(np.asarray(state.scale, np.float32), device=device),
        prev_mean=_leaf(state.prev_mean, device))


def load_blob(path) -> dict:
    """Unpickle a JAX checkpoint (plain or gzipped pickle) into a dict.

    Needs `ml_dtypes` when the file holds bf16 arrays, as the committed
    checkpoints do. Unpickling runs code: load only files this project wrote.
    """
    with open(path, 'rb') as f:
        magic = f.read(2)
    opener = gzip.open if magic == b'\x1f\x8b' else open
    with opener(str(path), 'rb') as f:
        return pickle.load(f)
