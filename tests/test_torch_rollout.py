"""PyTorch port vs the JAX package: the reward+dynamics rollout and the
kernel-engine canary (CPU).

- The rollout's plain version against JAX `fused_value_rollout` (the
  Pallas `_rollout_kernel`, interpreted with f32 dots) at the shapes of
  tests/test_pallas_rollout.py, at its tolerance (1e-4 / 1e-5).
- The canary's verdict: the CPU needs no child; a child that times out
  or fails gives False, cached for the process; and a False verdict makes
  a CUDA agent's construction raise (no fallback).

The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdmpc2_tpu.models import layers as jl
from tdmpc2_tpu.ops.pallas_rollout import fused_value_rollout as jrollout
from tdmpc2_tpu_torch.config import Config, parse_cfg
from tdmpc2_tpu_torch.interop import params_from_jax
from tdmpc2_tpu_torch.ops import _build, probe, rollout
from tdmpc2_tpu_torch.tdmpc2 import TDMPC2
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)


def _jax_case(S, L, A, B, D=32):
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(0), 4)
    dyn = jl.mlp_init(k1, L + A, [D, D], L, final_normed=True)
    rew = jl.mlp_init(k2, L + A, [D, D], B)
    rew = rew[:-1] + ({'w': 0.1 * jax.random.normal(k3, (D, B)),
                       'b': jnp.zeros(B)},)
    z0 = jl.simnorm(jax.random.normal(k4, (S, L)), 8)
    actions = jax.random.uniform(jax.random.PRNGKey(5), (3, S, A),
                                 minval=-1, maxval=1)
    return dyn, rew, z0, actions


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize('S,L,A,B', [(32, 32, 4, 5), (16, 64, 8, 101)])
def test_rollout_plain_matches_pallas_rollout_kernel(S, L, A, B):
    dyn, rew, z0, actions = _jax_case(S, L, A, B)
    kw = dict(horizon=3, discount=0.97, simnorm_dim=8, vmin=-10.0, vmax=10.0)
    G_ref, z_ref = jrollout(dyn, rew, z0, actions, interpret=True,
                            dot_dtype=jnp.float32, **kw)
    G, zH = rollout.fused_value_rollout_plain(
        params_from_jax(_np(dyn)), params_from_jax(_np(rew)), _t(z0),
        _t(actions), **kw)
    assert G.shape == (S, 1) and zH.shape == (S, L)
    np.testing.assert_allclose(G.numpy(), np.asarray(G_ref), **TOL)
    np.testing.assert_allclose(zH.numpy(), np.asarray(z_ref), **TOL)


def test_rollout_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    dyn, rew, z0, actions = _jax_case(16, 32, 4, 5)
    dyn, rew = params_from_jax(_np(dyn)), params_from_jax(_np(rew))
    kw = dict(horizon=3, discount=0.9, simnorm_dim=8, vmin=-10.0, vmax=10.0)
    n0 = rollout.rollout_prepared.launches
    got = rollout.fused_value_rollout(dyn, rew, _t(z0), _t(actions),
                                      dot_dtype=torch.float32, **kw)
    ref = rollout.fused_value_rollout_plain(dyn, rew, _t(z0), _t(actions),
                                            **kw)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert rollout.rollout_prepared.launches == n0   # no kernel on the CPU
    prep = rollout.prepare_rollout_params(dyn, rew, 32, -10.0, 10.0)
    with pytest.raises(ValueError, match='unsupported device'):
        rollout.rollout_prepared(prep, _t(z0).to('meta'),
                                 _t(actions).to('meta'), horizon=3,
                                 discount=0.9)


def test_canary_on_cpu_needs_no_child(monkeypatch):
    monkeypatch.setattr(probe, '_verdict', None)
    monkeypatch.setattr(subprocess, 'run',
                        lambda *a, **kw: (_ for _ in ()).throw(AssertionError))
    assert probe.kernel_engine_alive('cpu') is True
    assert probe.verdict() is None
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    torch.testing.assert_close(probe.add_one(x), x + 1.0, rtol=0, atol=0)


@pytest.mark.parametrize('failure', ['timeout', 'exit'])
def test_canary_failure_gives_false_and_is_cached(monkeypatch, failure):
    monkeypatch.setattr(probe, '_verdict', None)
    monkeypatch.setattr(_build, 'build', lambda names: {})

    def fake_run(*a, **kw):
        if failure == 'timeout':
            raise subprocess.TimeoutExpired(cmd='canary', timeout=kw['timeout'])
        return subprocess.CompletedProcess(a[0], 3, stdout='', stderr='boom')
    monkeypatch.setattr(subprocess, 'run', fake_run)
    assert probe.kernel_engine_alive('cuda', timeout=0.01) is False
    reason = probe.verdict()['reason']
    assert ('timed out' in reason) if failure == 'timeout' else ('rc=3' in reason)
    # the verdict is cached: no second child
    monkeypatch.setattr(subprocess, 'run',
                        lambda *a, **kw: (_ for _ in ()).throw(AssertionError))
    assert probe.kernel_engine_alive('cuda') is False


def test_false_canary_makes_a_cuda_agent_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(probe, '_verdict', dict(
        ok=False, seconds=150.0, reason='the canary child timed out after 150 s'))
    cfg = parse_cfg(Config(task='toy', device='cuda'))
    cfg.obs_shape, cfg.action_dim, cfg.episode_length = {'state': (6,)}, 2, 50
    with pytest.raises(RuntimeError, match='timed out'):
        TDMPC2(cfg)
