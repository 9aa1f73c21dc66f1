"""The planner's sampled value step and the agent's plan body (CPU).

- `value_sampled`, the value kernel's sampled mode (the CEM sampling done
  where the kernel stages each step's actions), against JAX: the same
  numpy inputs through the TPU kernel's sampling (pallas_cem.py:136-147:
  clip(mean + std * noise), the policy-prior rows, the action mask) and
  `value_prepared` (the Pallas value kernel, interpreted with f32 dots).
  Values at the JAX suite's 1e-4; the actions exactly
  `sample_actions_plain`'s, and JAX's within 1e-6 (XLA may fuse the
  multiply-add into one rounding).
- `TDMPC2._plan_body`, what the plan's CUDA graph captures on the card,
  against the plan as it was written before the graph (kept below as the
  reference): the same draws give the same actions, means and warm starts
  bit for bit, with episode starts on a negative warm start (reset through
  `where` to +0.0, as the host loop's `zero_` did) and without.
- The draws: `draw_noise` keeps the order and shapes of its draws, and
  drawing into the graph's input tensors gives the same bits.
- The warm starts and the prep follow the state: `prev_mean` is copied in
  place where the shapes agree, and a new parameter tree gets a new prep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_episodic
import test_torch_planner
from test_torch_planner import VTOL, _heads
from tdmpc2_tpu.ops.pallas_rollout import (prepare_value_params as jprepare,
                                           value_prepared)
from tdmpc2_tpu_torch.config import Config, parse_cfg
from tdmpc2_tpu_torch.ops import cem
from tdmpc2_tpu_torch.ops import value as tv
from tdmpc2_tpu_torch.tdmpc2 import TDMPC2, PlanDraws, PlanNoise
from torch_threads import one_torch_thread  # noqa: F401

S = 40          # a ragged row count, room for 24 policy-prior rows
OBS = 10


@pytest.fixture(scope='module')
def agents():
    """{episodic: (JAX agent, its params, port agent)} at the small widths
    of the planner and episodic tests (the termination head spread so that
    the gate splits the rows)."""
    return {False: test_torch_planner._agents(),
            True: test_torch_episodic._agents()}


def _sampled_inputs(jagent, jp, n, n_pi, seed):
    cfg = jagent.cfg
    H, A, L = cfg.horizon, cfg.action_dim, cfg.latent_dim
    rng = np.random.default_rng(seed)
    z = np.asarray(jagent.model.encode(
        jp, rng.normal(size=(n, 1, OBS)).astype(np.float32)))
    amask = np.ones(A, np.float32)
    amask[-1] = 0.0
    return dict(
        z=np.broadcast_to(z, (n, S, L)),
        mean=rng.uniform(-0.8, 0.8, (n, H * A)).astype(np.float32),
        std=rng.uniform(0.1, 2.0, (n, H * A)).astype(np.float32),
        noise=rng.normal(size=(n, S, H * A)).astype(np.float32),
        pi_acts=rng.uniform(-1, 1, (n, n_pi, H * A)).astype(np.float32),
        amask=amask,
        eps=rng.normal(size=(n, S, A)).astype(np.float32),
        qidx=np.stack([rng.permutation(cfg.num_q)[:2] for _ in range(n)]
                      ).astype(np.int32),
        discs=np.stack([g ** np.arange(H + 1) for g in (0.95, 0.9, 0.99)][:n]
                       ).astype(np.float32))


def _jax_sampled(jagent, jp, x, episodic):
    """Each env's actions as the TPU kernel samples them and its values by
    the Pallas value kernel (interpreted, f32 dots). The action mask also
    masks the terminal policy, as in the JAX planner wherever a mask is
    set: folded into the pi mean head, and the eps masked
    (tdmpc2_tpu/tdmpc2.py:467-470, 589-590)."""
    cfg = jagent.cfg
    H, A = cfg.horizon, cfg.action_dim
    n, n_pi = x['pi_acts'].shape[:2]
    jprep = jprepare(jp, cfg, action_mask=jnp.asarray(x['amask']),
                     dot_dtype=jnp.float32)
    is_pi = (jnp.arange(S) < n_pi).astype(jnp.float32)[:, None]
    values, acts = [], []
    for e in range(n):
        steps = []
        for t in range(H):
            sl = slice(t * A, (t + 1) * A)
            samp = jnp.clip(x['mean'][e, sl] + x['std'][e, sl] * x['noise'][e, :, sl],
                            -1.0, 1.0)
            if n_pi:
                pi_rows = jnp.concatenate(
                    [x['pi_acts'][e, :, sl], jnp.zeros((S - n_pi, A), jnp.float32)])
                samp = is_pi * pi_rows + (1.0 - is_pi) * samp
            steps.append(samp * x['amask'])
        a = jnp.stack(steps)                                   # [H, S, A]
        acts.append(jnp.moveaxis(a, 0, 1).reshape(S, H * A))
        values.append(value_prepared(
            jprep, x['z'][e], a, x['eps'][e] * x['amask'], x['qidx'][e], x['discs'][e],
            horizon=H, episodic=episodic, dot_dtype=jnp.float32, interpret=True,
            block_s=8, **_heads(jagent)))
    return np.stack(values), np.stack(acts)


@pytest.mark.parametrize('episodic', [False, True], ids=['plain', 'episodic'])
@pytest.mark.parametrize('n_pi', [0, 24])
@pytest.mark.parametrize('n', [1, 3])
def test_value_sampled_matches_jax(agents, n, n_pi, episodic):
    jagent, jp, tagent = agents[episodic]
    x = _sampled_inputs(jagent, jp, n, n_pi, 100 + 10 * n + n_pi)
    ref_v, ref_a = _jax_sampled(jagent, jp, x, episodic)
    prep = tv.prepare_value_params(tagent.params, tagent.cfg, torch.float32)
    args = (prep, *(torch.from_numpy(np.ascontiguousarray(x[k])) for k in (
        'z', 'mean', 'std', 'noise', 'pi_acts', 'amask', 'eps', 'qidx',
        'discs')))
    got_v, got_a = tv.value_sampled(*args, **_heads(tagent), episodic=episodic)
    assert got_v.shape == (n, S, 1) and got_a.shape == (n, S, x['mean'].shape[1])
    np.testing.assert_allclose(got_v.numpy(), ref_v, **VTOL)
    assert torch.equal(got_a, tv.sample_actions_plain(*args[2:7]))
    np.testing.assert_allclose(got_a.numpy(), ref_a, rtol=0, atol=1e-6)
    if n_pi:
        assert torch.equal(got_a[:, :n_pi], args[5] * args[6].repeat(
            tagent.cfg.horizon))


# ------------------------------------------------------------ the plan body


def _plan_before_graph(agent, obs, t0, eval_mode, noise):
    """The plan as `TDMPC2.plan_vec` computed it before the CUDA graph:
    the warm starts reset by a host loop, the CEM loop as separate sample
    and value steps (their plain versions: the CPU's path)."""
    cfg = agent.cfg
    H, E, A, I = cfg.horizon, cfg.num_elites, cfg.action_dim, agent.iterations
    n = obs.shape[0]
    heads = dict(log_std_min=agent.model.log_std_min,
                 log_std_dif=agent.model.log_std_dif, simnorm_dim=cfg.simnorm_dim)
    prep = agent.prep
    z0 = agent.model.encode(agent.params, obs.reshape(n, -1).float())[:, None]
    mean0 = torch.cat([agent.prev_mean[:n, 1:], torch.zeros(n, 1, A)], 1)
    for i in np.flatnonzero(t0):
        mean0[int(i)].zero_()
    mean, std = mean0.reshape(n, H * A), torch.full((n, H * A), cfg.max_std)
    pi_acts = cem.pi_rollout_plain(prep, z0, noise.pi_eps[:, :cfg.num_pi_trajs],
                                   **heads)
    S_ = cfg.num_samples
    z = z0.expand(n, S_, z0.shape[-1])
    for it in range(I):
        acts = tv.sample_actions_plain(mean, std, noise.sample[:, it], pi_acts,
                                       agent.amask)
        v = tv.value_estimate_plain(
            prep, z, acts.view(n, S_, H, A).permute(0, 2, 1, 3), noise.eps[:, it],
            noise.qidx[:, it], agent.discs.expand(n, -1), episodic=cfg.episodic,
            **heads)
        mean, std, v = cem.elite_moments_plain(
            v, acts, agent.amask, num_elites=E, temperature=cfg.temperature,
            min_std=cfg.min_std, max_std=cfg.max_std)
    elite_value, elite_idx = torch.topk(v, E, dim=-1)
    score = torch.exp(cfg.temperature * (
        elite_value - elite_value.max(-1, keepdim=True).values))
    score = score / score.sum(-1, keepdim=True)
    idx = torch.argmax(torch.log(score) + noise.gumbel, dim=-1)
    rows = torch.arange(n)
    a = acts[rows, elite_idx[rows, idx], :A]
    if not eval_mode:
        a = a + std[:, :A] * noise.act
    means = mean.reshape(n, H, A)
    agent.prev_mean[:n] = means
    return torch.clamp(a, -1.0, 1.0), means


@pytest.fixture(scope='module')
def vec_agent():
    """A port agent at the planner tests' small widths with 3 envs."""
    _, jp, _ = test_torch_planner._agents()
    ag = TDMPC2(test_torch_planner._small(parse_cfg(Config(
        task='toy', device='cpu', num_envs=3))))
    from tdmpc2_tpu_torch.interop import params_from_jax
    ag.load_params(params_from_jax(jax.tree.map(np.asarray, jp)))
    return ag


@pytest.mark.parametrize('eval_mode', [True, False])
@pytest.mark.parametrize('n', [1, 3])
def test_plan_body_equals_the_plan_before_the_graph(vec_agent, n, eval_mode):
    ag = vec_agent
    cfg = ag.cfg
    rng = np.random.default_rng(7 + n)
    obs = torch.from_numpy(rng.normal(size=(n, OBS)).astype(np.float32))
    warm = torch.from_numpy(rng.uniform(-0.5, 0.5, (3, cfg.horizon, cfg.action_dim))
                            .astype(np.float32))
    warm[0] = -torch.abs(warm[0]) - 0.1     # a negative warm start, reset
    warm[-1] = -torch.abs(warm[-1]) - 0.1   # and one kept (at n = 3)
    t0 = np.array([True, False, False][:n])
    ag.generator.manual_seed(11)
    noise = ag.draw_noise(n)
    ag.prev_mean = warm
    ref_a, ref_m = _plan_before_graph(ag, obs, t0, eval_mode, noise)
    ref_pm = ag.prev_mean.clone()
    ag.prev_mean = warm
    got_a, got_m = ag._plan_body(ag.prep, obs, torch.tensor(t0), noise, eval_mode)
    assert torch.equal(got_a, ref_a) and torch.equal(got_m, ref_m)
    assert torch.equal(ag.prev_mean, ref_pm)
    # plan_vec on the CPU runs the body on the generator's draws
    ag.prev_mean = warm
    ag.generator.manual_seed(11)
    a, m = ag.plan_vec(obs, t0, eval_mode=eval_mode)
    assert torch.equal(a, ref_a) and torch.equal(m, ref_m)


def _draw_noise_before(agent, n):
    """`draw_noise` as it was written before the raw draws were split
    out: the same calls in the same order."""
    cfg, g, dev = agent.cfg, agent.generator, agent.device
    H, S_, A, I = cfg.horizon, cfg.num_samples, cfg.action_dim, agent.iterations
    u = torch.rand(n, cfg.num_elites, generator=g, device=dev)
    pi_eps = torch.randn(n, max(cfg.num_pi_trajs, 1), H * A, generator=g, device=dev)
    sample = torch.randn(n, I, S_, H * A, generator=g, device=dev)
    eps = torch.randn(n, I, S_, A, generator=g, device=dev)
    r = torch.rand(n, I, cfg.num_q, generator=g, device=dev)
    qidx = torch.argsort(r, dim=-1)[..., :2].to(torch.int32).contiguous()
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    act = torch.randn(n, A, generator=g, device=dev)
    return PlanNoise(pi_eps, sample, eps, qidx, gumbel, act)


@pytest.mark.parametrize('into', [False, True], ids=['fresh', 'into-buffers'])
def test_draws_are_the_draws_before(vec_agent, into):
    ag, n = vec_agent, 3
    ag.generator.manual_seed(5)
    ref = _draw_noise_before(ag, n)
    ag.generator.manual_seed(5)
    if into:
        out = PlanDraws(**{k: torch.full(shape, float('nan')) for k, (_, shape)
                           in ag._draws(n).items()})
        assert ag._draw(n, out=out) is not None
        got = ag._noise_from(out)
    else:
        got = ag.draw_noise(n)
    for k, v in vars(ref).items():      # shift: None on a state model
        assert (getattr(got, k) is None if v is None
                else torch.equal(getattr(got, k), v)), k


def test_warm_starts_and_prep_follow_the_state(vec_agent):
    ag = vec_agent
    pm = ag.prev_mean
    ag.prev_mean = torch.ones_like(pm)
    assert ag.prev_mean is pm and bool((pm == 1).all())   # copied in place
    ag.prev_mean = torch.zeros(5, *pm.shape[1:])
    assert ag.prev_mean.shape[0] == 5                    # replaced
    ag.prev_mean = torch.zeros_like(pm)
    prep = ag.prep
    assert ag.prep is prep
    other = TDMPC2(ag.cfg)
    ag.state = other.state.to('cpu')                     # another parameter tree
    new = ag.prep
    assert new is not prep
    torch.testing.assert_close(new['dWz'], other.prep['dWz'], rtol=0, atol=0)
