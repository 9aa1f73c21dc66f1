"""PyTorch port vs the JAX package: math, layers, world-model heads, inits
and parameter interop (CPU, small widths, f32).

The same numpy inputs go through both; every random draw the JAX function
makes inside (dropout mask, pi eps, Q heads, Gumbel noise) is made with the
JAX key here and handed to the port as data."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdmpc2_tpu.config import Config as JConfig, parse_cfg as jparse
from tdmpc2_tpu.models import layers as jl
from tdmpc2_tpu.models.world_model import WorldModel as JWorldModel
from tdmpc2_tpu.ops import math as jm
from tdmpc2_tpu_torch.config import Config, parse_cfg
from tdmpc2_tpu_torch.interop import load_blob, params_from_jax
from tdmpc2_tpu_torch.models import layers as tl
from tdmpc2_tpu_torch.models.world_model import WorldModel
from tdmpc2_tpu_torch.ops import math as tm
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
OBS, ACT = 10, 4


def _dims(cfg, episodic=False):
    cfg.obs_shape = {'state': (OBS,)}
    cfg.action_dim = ACT
    cfg.episode_length = 20
    cfg.enc_dim, cfg.mlp_dim, cfg.latent_dim, cfg.num_q = 48, 64, 32, 3
    cfg.episodic = episodic
    return cfg


def _cfgs(episodic=False):
    return (_dims(jparse(JConfig(task='toy')), episodic),
            _dims(parse_cfg(Config(task='toy', device='cpu')), episodic))


def _perturb(params, seed=0):
    leaves, treedef = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree.unflatten(
        treedef, [x + 0.05 * jax.random.normal(k, x.shape, x.dtype)
                  for x, k in zip(leaves, keys)])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **tol)


@pytest.fixture(scope='module')
def models():
    jcfg, tcfg = _cfgs(episodic=True)
    jmodel = JWorldModel(jcfg)
    jparams = _perturb(jmodel.init(jax.random.PRNGKey(0)))
    return jmodel, jparams, WorldModel(tcfg), params_from_jax(_np(jparams))


# ----------------------------------------------------------------- math


def test_symlog_symexp_log_std():
    x = np.random.default_rng(0).normal(0, 3, (7, 5)).astype(np.float32)
    _close(tm.symlog(_t(x)), jm.symlog(x))
    _close(tm.symexp(_t(x)), jm.symexp(x))
    _close(tm.log_std(_t(x), -10.0, 12.0), jm.log_std(x, -10.0, 12.0))


@pytest.mark.parametrize('num_bins', [1, 5, 101])
def test_two_hot_inv(num_bins):
    x = np.random.default_rng(1).normal(0, 2, (6, num_bins)).astype(np.float32)
    _close(tm.two_hot_inv(_t(x), num_bins, -10.0, 10.0),
           jm.two_hot_inv(x, num_bins, -10.0, 10.0))


def test_int_to_one_hot():
    x = np.array([[0, 3], [2, 1]], np.int32)
    _close(tm.int_to_one_hot(torch.from_numpy(x), 4), jm.int_to_one_hot(x, 4))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_gumbel_softmax_sample_with_injected_noise(seed):
    key = jax.random.PRNGKey(seed)
    p = np.random.default_rng(seed).uniform(0.01, 1.0, 16).astype(np.float32)
    p /= p.sum()
    ref = int(jm.gumbel_softmax_sample(key, p))
    g = np.asarray(jax.random.gumbel(key, p.shape, jnp.float32))
    assert int(tm.gumbel_softmax_sample(_t(p), _t(g))) == ref


# ----------------------------------------------------------------- layers


def test_mish_simnorm_layer_norm():
    x = np.random.default_rng(2).normal(0, 4, (5, 32)).astype(np.float32)
    x[0, :4] = [20.0, -30.0, 15.0, 0.0]          # both sides of the clamp
    _close(tl.mish(_t(x)), jl.mish(x))
    _close(tl.simnorm(_t(x), 8), jl.simnorm(x, 8))
    w = np.linspace(0.5, 1.5, 32).astype(np.float32)
    b = np.linspace(-0.1, 0.1, 32).astype(np.float32)
    _close(tl.layer_norm(_t(x), _t(w), _t(b)), jl.layer_norm(x, w, b))


def test_normed_linear_with_injected_dropout_mask():
    key = jax.random.PRNGKey(3)
    kp, kd = jax.random.split(key)
    p = _perturb(jl.normed_linear_init(kp, 12, 16))
    x = np.random.default_rng(3).normal(size=(6, 12)).astype(np.float32)
    ref = jl.normed_linear_apply(p, x, dropout=0.25, key=kd, training=True)
    mask = np.array(jax.random.bernoulli(kd, 0.75, (6, 16)))
    got = tl.normed_linear(params_from_jax(_np(p)), _t(x),
                           keep_mask=torch.from_numpy(mask), dropout=0.25)
    _close(got, ref)
    _close(tl.normed_linear(params_from_jax(_np(p)), _t(x)),
           jl.normed_linear_apply(p, x))


@pytest.mark.parametrize('final', ['linear', 'simnorm'])
def test_mlp(final):
    p = _perturb(jl.mlp_init(jax.random.PRNGKey(4), 10, [16, 16], 24,
                             final_normed=(final == 'simnorm')))
    x = np.random.default_rng(4).normal(size=(5, 10)).astype(np.float32)
    fa = (lambda v: jl.simnorm(v, 8)) if final == 'simnorm' else None
    ta = (lambda v: tl.simnorm(v, 8)) if final == 'simnorm' else None
    _close(tl.mlp(params_from_jax(_np(p)), _t(x), final_act=ta),
           jl.mlp_apply(p, x, final_act=fa))


def test_ensemble():
    p = _perturb(jl.ensemble_init(
        jax.random.PRNGKey(5), 3, lambda k: jl.mlp_init(k, 10, [16], 7)))
    x = np.random.default_rng(5).normal(size=(2, 4, 10)).astype(np.float32)
    ref = jl.ensemble_apply(jl.mlp_apply, p, x)
    _close(tl.ensemble(params_from_jax(_np(p)), _t(x)), ref)


@pytest.mark.parametrize('episodic', [False, True])
def test_init_matches_jax_tree_and_scale(episodic):
    jcfg, tcfg = _cfgs(episodic)
    ref = _np(JWorldModel(jcfg).init(jax.random.PRNGKey(0)))
    got = WorldModel(tcfg).init(torch.Generator().manual_seed(0))
    assert (jax.tree.structure(ref)
            == jax.tree.structure(jax.tree.map(lambda t: t.numpy(), got)))
    for r, g in zip(jax.tree.leaves(ref), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), got))):
        assert r.shape == g.shape
    # zero-init reward/Q output heads, unit LN gains, trunc-normal(0.02) weights
    assert not got['reward'][-1]['w'].any() and not got['Qs'][-1]['w'].any()
    assert torch.equal(got['dynamics'][0]['ln_w'], torch.ones(tcfg.mlp_dim))
    w = got['dynamics'][1]['w']
    assert abs(float(w.std()) - 0.02) < 2e-3 and abs(float(w.mean())) < 1e-3


# ----------------------------------------------------------------- heads


def test_world_model_heads(models):
    jmodel, jp, tmodel, tp = models
    rng = np.random.default_rng(6)
    obs = rng.normal(size=(5, OBS)).astype(np.float32)
    a = rng.uniform(-1, 1, (5, ACT)).astype(np.float32)
    z = jmodel.encode(jp, obs)
    _close(tmodel.encode(tp, _t(obs)), z)
    zt = _t(z)
    _close(tmodel.next(tp, zt, _t(a)), jmodel.next(jp, z, a))
    _close(tmodel.reward(tp, zt, _t(a)), jmodel.reward(jp, z, a))
    _close(tmodel.termination(tp, zt), jmodel.termination(jp, z))
    _close(tmodel.termination(tp, zt, unnormalized=True),
           jmodel.termination(jp, z, unnormalized=True))


def test_pi_with_injected_eps(models):
    jmodel, jp, tmodel, tp = models
    z = jmodel.encode(jp, np.random.default_rng(7).normal(
        size=(6, OBS)).astype(np.float32))
    key = jax.random.PRNGKey(7)
    a_ref, info = jmodel.pi(jp, z, key)
    eps = jax.random.normal(key, (6, ACT), jnp.float32)
    a, tinfo = tmodel.pi(tp, _t(z), _t(eps))
    _close(a, a_ref)
    _close(tinfo['mean'], info['mean'])
    _close(tinfo['log_std'], info['log_std'])


@pytest.mark.parametrize('return_type', ['min', 'avg', 'all'])
def test_Q_with_injected_heads(models, return_type):
    jmodel, jp, tmodel, tp = models
    rng = np.random.default_rng(8)
    z = jmodel.encode(jp, rng.normal(size=(5, OBS)).astype(np.float32))
    a = rng.uniform(-1, 1, (5, ACT)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    ref = jmodel.Q(jp, z, a, key=key, return_type=return_type)
    qidx = np.array(jax.random.permutation(key, 3)[:2])
    got = tmodel.Q(tp, _t(z), _t(a), qidx=torch.from_numpy(qidx).long(),
                   return_type=return_type)
    _close(got, ref)


# ----------------------------------------------------------------- interop


def test_params_from_jax_round_trip(models):
    _, jp, _, tp = models
    ref = jax.tree.leaves(_np(jp))
    got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tp))
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, r)


def test_params_from_jax_upcasts_bf16():
    x = np.asarray(jnp.asarray([[1.5, -2.25], [3.0e-3, 7.0]], jnp.bfloat16))
    got = params_from_jax({'w': x, 'seq': (x,)})
    assert got['w'].dtype == torch.float32
    np.testing.assert_array_equal(got['seq'][0].numpy(), x.astype(np.float32))


def test_checkpoint_heads_match_jax():
    """Every head on the committed cartpole-swingup checkpoint (bf16 weights,
    default 5M architecture) against the JAX heads on the same weights."""
    blob = load_blob('results/checkpoints/cartpole-swingup-s1.pkl.gz')
    arch = blob['arch']
    kw = {k: arch[k] for k in ('latent_dim', 'mlp_dim', 'enc_dim', 'num_q',
                               'num_bins', 'simnorm_dim', 'num_enc_layers')}
    jcfg = jparse(JConfig(task='cartpole-swingup', **kw))
    tcfg = parse_cfg(Config(task='cartpole-swingup', device='cpu', **kw))
    for c in (jcfg, tcfg):
        c.obs_shape, c.action_dim = dict(arch['obs_shape']), arch['action_dim']
    jp = jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.float32), blob['model'])
    tp = params_from_jax(blob['model'])
    jmodel, tmodel = JWorldModel(jcfg), WorldModel(tcfg)
    rng = np.random.default_rng(9)
    obs = rng.normal(size=(4, 5)).astype(np.float32)
    a = rng.uniform(-1, 1, (4, 1)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    z = jmodel.encode(jp, obs)
    zt = _t(z)
    tol = dict(rtol=1e-4, atol=1e-5)  # 512-wide f32 sums, another order
    _close(tmodel.encode(tp, _t(obs)), z, tol)
    _close(tmodel.next(tp, zt, _t(a)), jmodel.next(jp, z, a), tol)
    _close(tmodel.reward(tp, zt, _t(a)), jmodel.reward(jp, z, a), tol)
    a_ref, _ = jmodel.pi(jp, z, key)
    a_pi, _ = tmodel.pi(tp, zt, _t(jax.random.normal(key, (4, 1))))
    _close(a_pi, a_ref, tol)
    qidx = torch.from_numpy(np.array(jax.random.permutation(key, 5)[:2]))
    _close(tmodel.Q(tp, zt, _t(a), qidx=qidx.long(), return_type='avg'),
           jmodel.Q(jp, z, a, key=key, return_type='avg'), tol)
