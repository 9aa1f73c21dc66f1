"""PyTorch port vs the JAX package: the planner (CPU, small widths, f32).

- the value step against JAX `value_prepared` (the Pallas value kernel, run
  interpreted with f32 dots) and against the JAX agent's plain value;
- the CEM loop against JAX `cem_prepared` (the whole-CEM Pallas kernel,
  interpreted, f32 dots), including the all-tied case of its tie rule;
- the whole plan against the JAX agent's `_plan(fused=False)`, with the
  port fed the noise that the JAX key splits give.

On the CPU every wrapper runs its plain version; the kernels themselves
are held against these on the card (tests/test_torch_cuda.py,
chip_smoke.py). Tolerances are the JAX suite's (tests/test_pallas_cem.py):
1e-4 for values and plan means, 1e-3 for actions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdmpc2_tpu.config import Config as JConfig, parse_cfg as jparse
from tdmpc2_tpu.models import layers as jl
from tdmpc2_tpu.ops.pallas_cem import cem_prepared
from tdmpc2_tpu.ops.pallas_rollout import (prepare_value_params as jprepare,
                                           value_prepared)
from tdmpc2_tpu.tdmpc2 import TDMPC2 as JTDMPC2
from tdmpc2_tpu_torch.config import Config, parse_cfg
from tdmpc2_tpu_torch.interop import params_from_jax
from tdmpc2_tpu_torch.ops import cem
from tdmpc2_tpu_torch.ops.value import prepare_value_params, value_estimate
from tdmpc2_tpu_torch.tdmpc2 import TDMPC2, PlanNoise

VTOL = dict(rtol=1e-4, atol=1e-4)
ATOL = dict(rtol=1e-3, atol=1e-3)


def _small(cfg, n_pi=8):
    cfg.obs_shape = {'state': (10,)}
    cfg.action_dim = 4
    cfg.episode_length = 20
    cfg.enc_dim, cfg.mlp_dim, cfg.latent_dim = 64, 64, 32
    cfg.num_samples, cfg.num_elites, cfg.num_pi_trajs = 64, 8, n_pi
    cfg.iterations, cfg.num_q = 2, 3
    return cfg


def _perturb(params, seed=0):
    leaves, treedef = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree.unflatten(
        treedef, [x + 0.05 * jax.random.normal(k, x.shape, x.dtype)
                  for x, k in zip(leaves, keys)])


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **tol)


def _agents(n_pi=8, perturb=True):
    jagent = JTDMPC2(_small(jparse(JConfig(task='toy')), n_pi))
    jp = jagent.state.params
    if perturb:
        jp = _perturb(jp)
    tagent = TDMPC2(_small(parse_cfg(Config(task='toy', device='cpu')), n_pi))
    tagent.load_params(params_from_jax(jax.tree.map(np.asarray, jp)))
    return jagent, jp, tagent


@pytest.fixture(scope='module')
def agents():
    return _agents()


def _heads(agent):
    return dict(log_std_min=agent.model.log_std_min,
                log_std_dif=agent.model.log_std_dif)


# ----------------------------------------------------------------- value


@pytest.mark.parametrize('qidx', [(0, 2), (1, 1), (2, 1)])
def test_value_estimate_matches_pallas_value_kernel(agents, qidx):
    jagent, jp, tagent = agents
    cfg = jagent.cfg
    S, H, A, L = 32, cfg.horizon, cfg.action_dim, cfg.latent_dim
    rng = np.random.default_rng(sum(qidx))
    z0 = np.asarray(jl.simnorm(rng.normal(size=(S, L)).astype(np.float32), 8))
    actions = rng.uniform(-1, 1, (H, S, A)).astype(np.float32)
    eps = rng.normal(size=(S, A)).astype(np.float32)
    q = np.asarray(qidx, np.int32)
    discs = (0.95 ** np.arange(H + 1)).astype(np.float32)
    ref = value_prepared(
        jprepare(jp, cfg, dot_dtype=jnp.float32), z0, actions, eps, q, discs,
        horizon=H, episodic=False, dot_dtype=jnp.float32, interpret=True,
        **_heads(jagent))
    got = value_estimate(
        prepare_value_params(tagent.params, tagent.cfg, torch.float32),
        *(_t(x)[None] for x in (z0, actions, eps, q, discs)), **_heads(tagent))
    assert got.shape == (1, S, 1)
    _close(got[0], ref, VTOL)


def test_value_estimate_matches_jax_plain_value(agents):
    """The prepared-weight value step and the port's model-head value both
    against the JAX agent's plain branch (tdmpc2.py:498-521)."""
    jagent, jp, tagent = agents
    cfg = jagent.cfg
    S, H, A = 16, cfg.horizon, cfg.action_dim
    key = jax.random.PRNGKey(5)
    rng = np.random.default_rng(5)
    z = np.asarray(jagent.model.encode(
        jp, rng.normal(size=(S, 10)).astype(np.float32)))
    actions = rng.uniform(-1, 1, (H, S, A)).astype(np.float32)
    ref = jagent._estimate_value(jp, z, actions, key, None, fused=False)
    k_pi, k_q = jax.random.split(key)
    eps = _t(jax.random.normal(k_pi, (S, A), jnp.float32))
    qidx = _t(jax.random.permutation(k_q, cfg.num_q)[:2]).to(torch.int32)
    _close(tagent._estimate_value(_t(z), _t(actions), eps, qidx), ref, VTOL)
    _close(value_estimate(
        prepare_value_params(tagent.params, tagent.cfg, torch.float32),
        *(x[None] for x in (_t(z), _t(actions), eps, qidx, tagent.discs)),
        **_heads(tagent))[0], ref, VTOL)


def test_wrappers_refuse_unsupported_input(agents):
    _, _, tagent = agents
    prep = tagent.prep
    z = torch.zeros(1, 4, 32)
    a = torch.zeros(1, 3, 4, 4)
    args = (prep, z, a, torch.zeros(1, 4, 4),
            torch.zeros(1, 2, dtype=torch.int32), tagent.discs[None])
    meta = [t.to('meta') if isinstance(t, torch.Tensor) else t for t in args]
    with pytest.raises(ValueError, match='unsupported device'):
        value_estimate(*meta, **_heads(tagent))
    with pytest.raises(ValueError, match='unsupported device'):
        cem.elite_moments(torch.zeros(1, 4, device='meta'),
                          torch.zeros(1, 4, 8, device='meta'),
                          torch.ones(4, device='meta'), num_elites=2,
                          temperature=0.5, min_std=0.05, max_std=2.0)


# ----------------------------------------------------------------- CEM


def _cem_inputs(jagent, jp, seed=0):
    cfg = jagent.cfg
    H, S, A, L = cfg.horizon, cfg.num_samples, cfg.action_dim, cfg.latent_dim
    I, n_pi, HA = jagent.iterations, cfg.num_pi_trajs, cfg.horizon * cfg.action_dim
    rng = np.random.default_rng(seed)
    f = np.float32
    z0 = np.asarray(jagent.model.encode(jp, rng.normal(size=(1, 10)).astype(f)))
    pi_eps = rng.normal(size=(max(n_pi, 1), HA)).astype(f)
    noise = rng.normal(size=(I, S, HA)).astype(f)
    noise[:, :n_pi] = 0.0                  # JAX pads the pi rows with zeros
    eps = rng.normal(size=(I, S, A)).astype(f)
    qidx = np.stack([rng.permutation(cfg.num_q)[:2] for _ in range(I)]
                    ).astype(np.int32)
    discs = (jagent.discount ** np.arange(H + 1)).astype(f)
    mean0 = (0.1 * rng.normal(size=(1, HA))).astype(f)
    std0 = np.full((1, HA), cfg.max_std, f)
    assert z0.shape == (1, L)
    return z0, pi_eps, noise, eps, qidx, discs, mean0, std0


@pytest.mark.parametrize('n_pi,perturb', [(8, True), (0, True), (8, False)],
                         ids=['pi-rows', 'no-pi-rows', 'all-tied'])
def test_cem_plan_matches_pallas_cem_kernel(n_pi, perturb):
    """perturb=False keeps the zero-init reward/Q heads: every sample's value
    ties, and the bisection tie rule must give the uniform E/S weighting
    (tests/test_pallas_cem.py:155) on both sides, finite."""
    jagent, jp, tagent = _agents(n_pi, perturb)
    cfg = jagent.cfg
    H, A, I = cfg.horizon, cfg.action_dim, jagent.iterations
    inputs = _cem_inputs(jagent, jp)
    kw = dict(iterations=I, n_pi=n_pi, num_elites=cfg.num_elites,
              temperature=cfg.temperature, min_std=cfg.min_std,
              max_std=cfg.max_std)
    ref = cem_prepared(
        jprepare(jp, cfg, dot_dtype=jnp.float32), *inputs,
        jnp.ones((1, A), jnp.float32), horizon=H, episodic=False,
        dot_dtype=jnp.float32, interpret=True, **kw, **_heads(jagent))
    # one env: a leading env axis of 1 (mean0/std0 [1, H*A] already)
    z0, pi_eps, noise, eps, qidx, discs = (_t(x)[None] for x in inputs[:6])
    got = cem.cem_plan(
        prepare_value_params(tagent.params, tagent.cfg, torch.float32), z0,
        pi_eps, noise, eps, qidx, discs, _t(inputs[6]), _t(inputs[7]),
        torch.ones(A), simnorm_dim=8, **kw, **_heads(tagent))
    for g, r in zip(got, ref):
        assert g.shape[0] == 1 and torch.isfinite(g).all()
        _close(g[0], r, VTOL)
    if not perturb:
        v = got[2][0, :, 0]
        assert torch.all(v == v[0])        # every value tied


def test_elite_moments_tie_rule():
    """Distinct values: exactly the top E. All tied: uniform weights, so the
    mean is the plain average of all samples."""
    S, HA, E = 32, 6, 4
    acts = torch.linspace(-1, 1, S * HA).reshape(S, HA)
    v = torch.arange(S, dtype=torch.float32)
    kw = dict(num_elites=E, temperature=0.5, min_std=0.0, max_std=10.0)

    def elite(values):                      # one env: N=1
        return [x[0] for x in cem.elite_moments(values[None], acts[None],
                                                torch.ones(2), **kw)]
    mean, _, _ = elite(v)
    w = torch.exp(0.5 * (v[-E:] - v[-1]))
    w = w / w.sum()
    torch.testing.assert_close(mean, (w[:, None] * acts[-E:]).sum(0) / (w.sum() + 1e-9))
    mean, std, _ = elite(torch.zeros(S))
    torch.testing.assert_close(mean, acts.mean(0), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(std, acts.std(0, unbiased=False), rtol=1e-5, atol=1e-6)
    nan_v = v.clone()
    nan_v[3], nan_v[5] = float('nan'), float('inf')
    _, _, guarded = elite(nan_v)
    assert guarded[3] == 0 and guarded[5] == 0


# ----------------------------------------------------------------- plan


def _jax_plan_noise(key, cfg, iterations) -> PlanNoise:
    """The draws of `TDMPC2._plan` for `key`, replayed from its key splits,
    as the draws of one env (a leading axis of 1); on a pixel config also
    the encoder's ShiftAug shifts, from k_enc (layers.py:229)."""
    H, S, A, E = cfg.horizon, cfg.num_samples, cfg.action_dim, cfg.num_elites
    n_pi = cfg.num_pi_trajs
    _, k_enc, k_pi_roll, k_loop, k_gumbel, k_noise, _ = jax.random.split(key, 7)
    samples, epss, qidxs = [], [], []
    k = k_loop
    for _ in range(iterations):
        k, k_r, k_v = jax.random.split(k, 3)
        r = jax.random.normal(k_r, (H, S - n_pi, A))
        k_pi, k_q = jax.random.split(k_v)
        epss.append(jax.random.normal(k_pi, (S, A), jnp.float32))
        qidxs.append(jax.random.permutation(k_q, cfg.num_q)[:2])
        r = jnp.pad(r, ((0, 0), (n_pi, 0), (0, 0)))
        samples.append(jnp.moveaxis(r, 0, 1).reshape(S, H * A))
    pi_eps = jnp.concatenate(
        [jax.random.normal(kh, (n_pi, A), jnp.float32)
         for kh in jax.random.split(k_pi_roll, H)], axis=-1)
    return PlanNoise(
        pi_eps=_t(pi_eps)[None], sample=_t(jnp.stack(samples))[None],
        eps=_t(jnp.stack(epss))[None],
        qidx=_t(jnp.stack(qidxs)).to(torch.int32)[None],
        gumbel=_t(jax.random.gumbel(k_gumbel, (E,), jnp.float32))[None],
        act=_t(jax.random.normal(k_noise, (A,)))[None],
        shift=(torch.from_numpy(np.array(jax.random.randint(k_enc, (1, 2), 0, 7))).long()
               if cfg.obs == 'rgb' else None))


@pytest.mark.parametrize('seed,eval_mode', [(7, True), (8, False)])
def test_plan_matches_jax_plan(agents, seed, eval_mode):
    jagent, jp, tagent = agents
    cfg = jagent.cfg
    ko, kp, key = jax.random.split(jax.random.PRNGKey(seed), 3)
    obs = jax.random.normal(ko, (1, 10))
    prev_mean = 0.1 * jax.random.normal(kp, (cfg.horizon, cfg.action_dim))
    a_ref, mean_ref, _ = jagent._plan(jp, obs, prev_mean, jnp.asarray(False),
                                      key, None, eval_mode=eval_mode,
                                      fused=False)
    tagent.prev_mean = _t(prev_mean)[None]
    a, mean = tagent.plan_vec(_t(obs), np.array([False]), eval_mode=eval_mode,
                              noise=_jax_plan_noise(key, cfg, jagent.iterations))
    _close(mean[0], mean_ref, VTOL)
    _close(a[0], a_ref, ATOL)
    _close(tagent.prev_mean[0], mean_ref, VTOL)


def test_act_draws_its_own_noise_and_warm_starts(agents):
    _, _, tagent = agents
    obs = np.zeros(10, np.float32)
    tagent.generator.manual_seed(0)
    a1 = tagent.act(obs, t0=True, eval_mode=True)
    m1 = tagent.prev_mean.clone()
    tagent.generator.manual_seed(0)
    a2 = tagent.act(obs, t0=True, eval_mode=True)
    np.testing.assert_array_equal(a1, a2)          # same generator state
    assert a1.shape == (4,) and np.all(np.abs(a1) <= 1.0)
    tagent.act(obs, t0=False, eval_mode=False)     # warm start from m1
    assert tagent.prev_mean.shape == m1.shape
