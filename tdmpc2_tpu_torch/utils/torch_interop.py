"""The reference's published artifacts: PyTorch checkpoints and dataset chunks
(the port's copy of tdmpc2_tpu/utils/torch_interop.py).

The reference ships trained checkpoints (torch ``state_dict`` pickles,
loaded by reference tdmpc2/tdmpc2.py:81-95) and multi-task datasets as
TensorDict ``.pt`` chunks (reference tdmpc2/trainer/offline_trainer.py:42-65).
This module reads both without the ``tensordict`` and ``torchrl`` packages:

- `tolerant_torch_load`: ``torch.load`` with an unpickler that puts inert
  stubs in place of any class whose module is missing, so TensorDict
  containers unpickle into shells around their tensors.
- `extract_named_tensors`: ``{name: tensor}`` mined from those shells.
- `convert_reference_state_dict`: a reference WorldModel state_dict (old or
  new API key scheme; the old-to-new renaming follows reference
  common/layers.py:167-221 ``api_model_conversion``) onto the port's
  parameter tree, torch's [out, in] linear weights turned into the port's
  [in, out], and a pixel model's conv weights torch's OIHW turned into the
  port's HWIO (the JAX package's layout).
- `read_tensordict_chunk`: a published dataset chunk -> a dict of numpy
  arrays (obs, action, reward, task, ...), ready for ``Buffer.load``.

Unpickling runs code: read only files from a source you trust.
"""

from __future__ import annotations

import io
import pickle
import types
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Tolerant unpickling
# ---------------------------------------------------------------------------


class _Stub:
    """Inert placeholder for a class that cannot be imported: keeps every
    constructor argument and ``__setstate__`` payload for
    `extract_named_tensors` to mine."""

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj._stub_args = args
        obj._stub_kwargs = kwargs
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self._stub_state = state

    # some reduce protocols call the restored object (classmethod
    # constructors): keep what they pass
    def __call__(self, *args, **kwargs):
        child = _Stub(*args, **kwargs)
        child._stub_parent = self
        return child

    def __repr__(self):
        return f'<stub {type(self).__module__}.{type(self).__name__}>'


_stub_cache: Dict[Tuple[str, str], type] = {}


def _stub_class(module: str, name: str) -> type:
    key = (module, name)
    if key not in _stub_cache:
        _stub_cache[key] = type(name, (_Stub,), {'__module__': module})
    return _stub_cache[key]


class _TolerantUnpickler(pickle.Unpickler):
    """An unpickler that puts stubs in place of classes it cannot import."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return _stub_class(module, name)


def _pickle_shim() -> types.ModuleType:
    """A pickle-module lookalike for ``torch.load(pickle_module=...)``."""
    shim = types.ModuleType('tolerant_pickle')
    shim.Unpickler = _TolerantUnpickler
    shim.load = lambda f, **kw: _TolerantUnpickler(f).load()
    shim.loads = lambda b, **kw: _TolerantUnpickler(io.BytesIO(b)).load()
    shim.dump = pickle.dump
    shim.dumps = pickle.dumps
    shim.HIGHEST_PROTOCOL = pickle.HIGHEST_PROTOCOL
    return shim


def tolerant_torch_load(fp) -> Any:
    """``torch.load`` that survives missing ``tensordict``/``torchrl``: the
    tensor storages are restored by torch's reader, the container classes
    become stubs."""
    return torch.load(fp, map_location='cpu', weights_only=False,
                      pickle_module=_pickle_shim())


def extract_named_tensors(obj, _to_numpy: bool = True) -> Dict[str, np.ndarray]:
    """``{name: array}`` from an unpickled object graph: dicts, sequences and
    stub shells are walked, and the first tensor under each string key wins
    (TensorDict keeps its leaves in an inner ``_tensordict`` dict, so none
    compete)."""
    found: Dict[str, np.ndarray] = {}
    seen = set()

    def walk(o):
        if id(o) in seen:
            return
        seen.add(id(o))
        if isinstance(o, dict):
            for k, v in o.items():
                if isinstance(k, str) and torch.is_tensor(v) and k not in found:
                    found[k] = v.detach().cpu().numpy() if _to_numpy else v
                walk(v)
        elif isinstance(o, (list, tuple, set)):
            for v in o:
                walk(v)
        elif isinstance(o, _Stub):
            walk(o.__dict__)
            walk(list(o._stub_args))
            walk(o._stub_kwargs)
        elif hasattr(o, '__dict__') and not torch.is_tensor(o):
            walk(o.__dict__)

    walk(obj)
    return found


# ---------------------------------------------------------------------------
# Reference checkpoint -> parameter tree
# ---------------------------------------------------------------------------

_NAME_MAP = ('weight', 'bias', 'ln.weight', 'ln.bias')
# the reference conv() Sequential's Conv2d layers (ShiftAug at 0,
# PixelPreprocess at 1; reference layers.py:136-150)
_CONV_SEQ_IDX = (2, 4, 6, 8)


def _to_np(v) -> np.ndarray:
    if hasattr(v, 'detach'):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _normalize_keys(sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Old-to-new API renaming, tensors only (reference
    common/layers.py:167-221): the old flat Q-ensemble keys
    ``_Qs.params.<n>`` map to layer ``n // 4`` and parameter
    ``_NAME_MAP[n % 4]``; ``_target_Qs.params.<n>`` likewise."""
    out: Dict[str, np.ndarray] = {}
    for key, val in sd.items():
        if key.endswith('__batch_size') or key.endswith('__device'):
            continue
        tail = key.rsplit('.', 1)[-1]
        if key.startswith('_Qs.params.') and tail.isdigit():
            n = int(tail)
            out[f'_Qs.params.{n // 4}.{_NAME_MAP[n % 4]}'] = _to_np(val)
        elif key.startswith('_target_Qs.params.') and tail.isdigit():
            n = int(tail)
            out[f'_target_Qs_params.{n // 4}.{_NAME_MAP[n % 4]}'] = _to_np(val)
        else:
            out[key] = _to_np(val)
    return out


def _mlp_from_keys(sd: Dict[str, np.ndarray], prefix: str):
    """``{prefix}.{i}.*`` -> the port's MLP, a tuple of layer dicts (torch
    Linear weight [out, in] -> 'w' [in, out])."""
    layers = []
    i = 0
    while f'{prefix}.{i}.weight' in sd:
        layer = {'w': np.ascontiguousarray(sd[f'{prefix}.{i}.weight'].T),
                 'b': sd[f'{prefix}.{i}.bias']}
        if f'{prefix}.{i}.ln.weight' in sd:
            layer['ln_w'] = sd[f'{prefix}.{i}.ln.weight']
            layer['ln_b'] = sd[f'{prefix}.{i}.ln.bias']
        layers.append(layer)
        i += 1
    return tuple(layers) if layers else None


def _qs_from_keys(sd: Dict[str, np.ndarray], prefix: str):
    """The stacked Q ensemble ``{prefix}.{layer}.*`` ([num_q, out, in] ->
    'w' [num_q, in, out])."""
    layers = []
    i = 0
    while f'{prefix}.{i}.weight' in sd:
        layer = {'w': np.ascontiguousarray(
                     sd[f'{prefix}.{i}.weight'].transpose(0, 2, 1)),
                 'b': sd[f'{prefix}.{i}.bias']}
        if f'{prefix}.{i}.ln.weight' in sd:
            layer['ln_w'] = sd[f'{prefix}.{i}.ln.weight']
            layer['ln_b'] = sd[f'{prefix}.{i}.ln.bias']
        layers.append(layer)
        i += 1
    return tuple(layers) if layers else None


def _conv_encoder_from_keys(sd: Dict[str, np.ndarray], prefix: str):
    """The reference's conv() Sequential -> a tuple of {'w' HWIO, 'b'}
    layers (JAX torch_interop.py:225-235); None when a conv layer is
    missing."""
    out = []
    for i in _CONV_SEQ_IDX:
        w = sd.get(f'{prefix}.{i}.weight')
        if w is None:
            return None
        # torch OIHW -> HWIO
        out.append({'w': np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
                    'b': sd[f'{prefix}.{i}.bias']})
    return tuple(out)


def convert_reference_state_dict(
        sd: Dict[str, Any],
        params_template: Optional[dict] = None) -> Tuple[dict, Any]:
    """A reference WorldModel state_dict -> ``(params, target_Qs)`` trees of
    numpy arrays in the port's layout.

    ``sd`` may be the raw checkpoint (``{'model': state_dict}``) or the
    state_dict itself, in either API key scheme. With ``params_template``
    (a parameter tree, numpy arrays or tensors) every converted leaf's shape
    is held against it, and a mismatch raises a ValueError that names it.
    """
    if 'model' in sd and isinstance(sd['model'], dict):
        sd = sd['model']
    sd = _normalize_keys(sd)

    params: Dict[str, Any] = {}
    encoder: Dict[str, Any] = {}
    state_enc = _mlp_from_keys(sd, '_encoder.state')
    if state_enc:
        encoder['state'] = state_enc
    rgb_enc = _conv_encoder_from_keys(sd, '_encoder.rgb')
    if rgb_enc:
        encoder['rgb'] = rgb_enc
    if not encoder:
        raise ValueError(
            'no encoder keys found: not a reference TD-MPC2 checkpoint? '
            f'(keys: {sorted(sd)[:8]}...)')
    params['encoder'] = encoder
    params['dynamics'] = _mlp_from_keys(sd, '_dynamics')
    params['reward'] = _mlp_from_keys(sd, '_reward')
    params['pi'] = _mlp_from_keys(sd, '_pi')
    params['Qs'] = _qs_from_keys(sd, '_Qs.params')
    term = _mlp_from_keys(sd, '_termination')
    if term:
        params['termination'] = term
    if '_task_emb.weight' in sd:
        params['task_emb'] = {'w': sd['_task_emb.weight']}
    for name in ('dynamics', 'reward', 'pi', 'Qs'):
        if not params[name]:
            raise ValueError(f'checkpoint is missing the {name} head')

    target_Qs = _qs_from_keys(sd, '_target_Qs_params')
    if target_Qs is None:
        target_Qs = _map_leaves(np.array, params['Qs'])

    if params_template is not None:
        _validate_against(params, params_template)
    return params, target_Qs


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def _validate_against(params, template, path='params'):
    if isinstance(template, dict):
        missing = set(template) - set(params or {})
        extra = set(params or {}) - set(template)
        if missing or extra:
            raise ValueError(
                f'{path}: structure mismatch (checkpoint lacks {sorted(missing)}, '
                f'has unexpected {sorted(extra)}): architecture differs from cfg')
        for k in template:
            _validate_against(params[k], template[k], f'{path}.{k}')
    elif isinstance(template, tuple):
        if len(params) != len(template):
            raise ValueError(
                f'{path}: {len(params)} layers in checkpoint vs '
                f'{len(template)} in model: architecture differs from cfg')
        for i, (p, t) in enumerate(zip(params, template)):
            _validate_against(p, t, f'{path}[{i}]')
    elif tuple(np.shape(params)) != tuple(template.shape):
        raise ValueError(
            f'{path}: shape {np.shape(params)} in checkpoint vs '
            f'{tuple(template.shape)} in model: architecture differs from cfg')


def load_reference_checkpoint(fp, params_template: Optional[dict] = None):
    """A published reference ``.pt`` checkpoint file -> ``(params,
    target_Qs)`` numpy trees in the port's layout."""
    blob = tolerant_torch_load(fp)
    if not isinstance(blob, dict):
        blob = extract_named_tensors(blob)
    return convert_reference_state_dict(blob, params_template)


# ---------------------------------------------------------------------------
# Published dataset chunks
# ---------------------------------------------------------------------------

_CHUNK_KEYS = ('obs', 'action', 'reward', 'terminated', 'task', 'episode')


def read_tensordict_chunk(fp) -> Dict[str, np.ndarray]:
    """A published TensorDict ``.pt`` dataset chunk -> a dict of numpy
    arrays laid out [n_episodes, episode_rows, ...] per key (reference
    offline_trainer.py:42-65 asserts td.shape[1] == episode_length + 1).
    The container unpickles into stubs; the tensors are mined from them."""
    obj = tolerant_torch_load(fp)
    named = extract_named_tensors(obj)
    out = {k: v for k, v in named.items() if k in _CHUNK_KEYS}
    if 'obs' not in out and named:
        # a nested obs dict ({'state': ...}): take the state leaf
        for k, v in named.items():
            if k.endswith('state') and v.ndim >= 2:
                out['obs'] = v
                break
    required = {'obs', 'action', 'reward'}
    if not required <= set(out):
        raise ValueError(
            f'{fp}: recovered keys {sorted(named)} lack {required}: '
            'not a TD-MPC2 dataset chunk?')
    for k, v in out.items():
        if v.dtype == np.float64:
            out[k] = v.astype(np.float32)
    return out
