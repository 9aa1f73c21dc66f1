"""The port's `Config` against the JAX package's: every JAX key is either a
field of the port's config with JAX's default (honoured), or in
`REFUSED_KEYS` with the reason the port refuses it, where JAX's default
value asks nothing and loads, and any other value raises with the reason."""

import dataclasses

import pytest

from tdmpc2_tpu.config import Config as JConfig
from tdmpc2_tpu_torch.config import REFUSED_KEYS, Config, load_cfg
from torch_threads import one_torch_thread  # noqa: F401

JAX_FIELDS = {f.name: f for f in dataclasses.fields(JConfig)}
PORT_FIELDS = {f.name for f in dataclasses.fields(Config)}


def _cli(v):
    return 'null' if v is None else str(v).lower() if isinstance(v, bool) else str(v)


def test_every_jax_key_is_honoured_or_refused():
    jdefault, default = JConfig(), Config()
    for k in JAX_FIELDS:
        if k in PORT_FIELDS:
            assert k not in REFUSED_KEYS, k
            assert getattr(default, k) == getattr(jdefault, k), k
        else:
            assert k in REFUSED_KEYS, f'{k}: neither honoured nor refused'
            accepted, reason = REFUSED_KEYS[k]
            assert accepted[0] == getattr(jdefault, k), k
            assert reason, k
    assert set(REFUSED_KEYS) <= set(JAX_FIELDS)
    assert PORT_FIELDS - set(JAX_FIELDS) == {'device'}


def test_a_config_with_every_jax_key_at_its_default_loads():
    """A recipe that names every JAX key at JAX's default loads in the
    port, and each honoured key keeps JAX's value."""
    jdefault = JConfig()
    over = ['task=toy-reach'] + [f'{k}={_cli(getattr(jdefault, k))}'
                                 for k in JAX_FIELDS if k != 'task']
    cfg = load_cfg(overrides=over)
    derived = ('task', 'work_dir', 'task_title', 'tasks', 'multitask',
               'task_dim', 'bin_size')
    for k in JAX_FIELDS:
        if k in PORT_FIELDS and k not in derived:
            assert getattr(cfg, k) == getattr(jdefault, k), k


@pytest.mark.parametrize('key,value,names', [
    ('mesh_shape', '4x2', 'A10'), ('vec_mode', 'subproc', 'A11'),
    ('compile', 'false', 'CUDA graphs'), ('use_pallas', 'false', 'CUDA kernels'),
    ('platform', 'cpu', 'device='), ('matmul_precision', 'highest', 'TF32'),
    ('enable_wandb', 'true', 'wandb'), ('wandb_project', 'x', 'wandb'),
    ('wandb_entity', 'x', 'wandb'), ('wandb_silent', 'true', 'wandb'),
    ('profiler_port', '9012', 'profile_dir')])
def test_a_refused_key_raises_with_its_reason(key, value, names):
    with pytest.raises(ValueError, match=names):
        load_cfg(overrides=['task=toy-reach', f'{key}={value}'])


def test_honoured_new_keys():
    cfg = load_cfg(overrides=['task=toy-reach', 'bf16_update=true',
                              'seeds=3,7', 'vec_mode=inproc'])
    assert cfg.bf16_update is True and cfg.seeds == '3,7'
