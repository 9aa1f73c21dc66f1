"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; without a card every test skips. On the card:

    python -m pytest -m cuda tests/test_torch_cuda.py -q

Small widths with ragged edges (row counts that are not a multiple of the
kernels' row block). Both sides use bf16 weights and bf16-rounded dot
inputs with f32 accumulation, so they differ only in summation order and
in last-bit rounding ahead of bf16 roundings: values and the rollout are
held at 2e-2, the elite update (no dots) at 1e-4, the canary exactly. The
value kernel's sampled mode (the planner's step) is held exactly: its
actions against `sample_actions_plain`, its values against the
given-actions mode on those actions. Every planner operand has a leading
env axis (N=1 for one env);
each planner kernel's env axis is held against its plain version and, bit
for bit, against one-env launches. One update on the card is held
against the CPU's (f32, TF32 off) at 1e-4. On an episodic agent the value
kernel's termination gate is held under `ops.value.gate_check`: the 2e-2
band where the flags agree, a flip only where the plain logit is within
1e-2 of 0 (at most 1% of the rows). The tensor-core kernels are also held
at the widths of model_size 1, 19 and 48 (row tiles of 32, 32 and 16 rows
with 4, 8 and 16 column pairs a warp), and a width that no engine takes
raises, naming the widths. At model_size 317's widths (mlp_dim 4096: the
wide engine, ops/wide.py) the value step (both branches), the sampled
step, the pi rollout and the rollout are held against their plain versions
at one env and N=8, N=8 against 8 one-env launches bit for bit, and the
plan's graph against its eager body; the rollout (on the wide engine at
every width) also at model_size 1, 5, 19 and 48, and at a 128-column
latent whose products split K; the engine mirror (tests/wide_mirror.py)
and the product's tile plan against the built library's, and the layouts
a card prep holds; and the wide engine's product alone (wgmma on a TMA
ring) at each distinct product of the 317M model at 512 and 4,096 rows
against the plain product, within 1e-4 of |x| @ |W|, its plan the
mirror's, each env's rows of an N=8 launch bit for bit a one-env
launch's; and its row kernel alone (tdm_wide_rows) in every mode at 512,
1,920 and 4,096 rows of the 317M model's widths (tests/row_cases.py, the
cases chip_smoke.py's row phase shares), a LayerNorm row of 8 partial
rows and LayerNorm + SimNorm at groups 2, 4 and 16, against ops/wide.py
rows_plain: bf16 outputs within one bf16 step, f32 outputs at 1e-4, its
plan the mirror's, N=8 bit for bit one-env launches; its staging alone
(tdm_wide_stage) over a sampled step's H launches at 512, 4,096 and 40,960
rows, the latent broadcast, one a row and folded, a mask per env or
shared, against stage_plain bit for bit; and a folded first layer's two
kernels: the u product (the envs' latents, packed into shared tiles, into
u's partial rows) against fold_plain's u at 1e-4 of |zb| . |Wz|, and the
fused layer (the action columns times the action block plus u's row of the
env plus its task's bias row, LayerNorm + Mish) against fold_hidden_plain
within one bf16 step, with 80 distinct tasks and with repeated ones, at
317's widths and at each thread count a row it is built for (38 actions at
512, 1024 and 1792 columns, 6 at 3000, 21 at 4096), each plan the
mirror's, N = 8 bit for bit one-env launches; the value step at 38
actions (model_size 5, folded; 317, not folded) and 21 (317, folded)
against the plain value step. The
elite kernel is held at its edges (S = 77, 2048 and 28,000, HA = 114, E =
1 and E = S, ties across the boundary, all tied, NaN, inf and +-3e38), its
N=8 launch against 8 one-env launches bit for bit, and the canary at n =
1, 3, 1027 and at a storage offset. The
agent's plan, a replayed CUDA graph, is held bit for bit against its eager
body (`TDMPC2._plan_body`) on the same draws: at n = 1 and n = num_envs,
in both modes, with mixed episode starts, after an update (the prep
refreshed in place) and after `load_params` (the graphs captured anew).
On the task axis (a multi-task model: each env's task id picks its rows of
the prep's first-layer bias tables, and its action mask masks the policy
and the samples): the three planner kernels at N = 6 envs on 5 tasks with
mixed action dims against their plain versions and, bit for bit, against
one-task launches, masked columns 0; the episodic value step under the
gate rule; `act_tasks` (one graph replay of 1 + 2 x iterations launches
for every task) against its eager body bit for bit; and a single-task
model as task 0 of a one-row table, unchanged bit for bit. On the committed
checkpoints' trained weights (read on the card without jax, optax or
ml_dtypes), at one env on recorded observations: the planner's kernels
against their plain versions and the plan's graph against its eager body,
and one update from the full hopper-hop train state against the CPU's.
Pixels: ShiftAug on the recorded walker frames (uint8) against the CPU's
bit for bit, the conv encoder (cuDNN, f32) against the CPU's at 1e-4 on a
small pixel model and on the committed walker-walk-rgb model's trained
weights, and the pixel plan's graph (uint8 frames and the shift draw among
its inputs, the encoder in it) against its eager body. The update's graph
(the whole `_update` a replay) against its eager body from the same state
on the same batch and draws, bit for bit (info, parameters, targets, Adam
states, scale), on a state, an episodic, a pixel and a multi-task model;
`update_many(4)` against four eager steps; a new parameter tree captured
anew; `vec_step` against `act` + `update_many`, with four updates and
with none (actions, info, state, warm starts). The bf16 update
(bf16_update=true): its graph against its eager body bit for bit on the
four kinds of model, the bf16 product (cuBLAS, f32 sums) against the
plain one, one bf16 update against one f32 update under JAX's contract
(losses within 5% of max(|f32|, 1), weights within 2e-3), and a bf16
agent's plan the f32 agent's bit for bit. The fleet: seed k's initial
state, plans and updates (graph replays) the single agent of seed k's bit
for bit."""

from pathlib import Path

import numpy as np
import pytest
import torch

from tdmpc2_tpu_torch.config import Config, parse_cfg
from tdmpc2_tpu_torch.models import layers
from tdmpc2_tpu_torch.models.layers import simnorm
from tdmpc2_tpu_torch.data.buffer import Buffer
from tdmpc2_tpu_torch.ops import _build, cem, probe, rollout, wide
from tdmpc2_tpu_torch.ops.value import (PACKED, WIDE, dynamics_plain, gate_check,
                                        kernel_plan, pi_action_plain, pi_head_plain,
                                        prepare_value_params, sample_actions_plain,
                                        termination_trace_plain, value_estimate,
                                        value_estimate_plain, value_sampled,
                                        value_sampled_plain)
from tdmpc2_tpu_torch.tdmpc2 import PLAN_WRAPPERS, TDMPC2, UpdateNoise
from tdmpc2_tpu_torch.utils import tree
from tdmpc2_tpu_torch.utils.cuda_graph import Graph
import row_cases as rc  # tests/ is on pytest's path; a `tests` package may be installed
import wide_mirror as wm

pytestmark = pytest.mark.cuda

BAND = dict(rtol=2e-2, atol=2e-2)
ELITE = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope='module')
def agent():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (python -m pytest -m cuda on the card)')
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = parse_cfg(Config(task='toy', device='cuda', enc_dim=48, mlp_dim=64,
                           latent_dim=64, num_q=3, num_samples=77,
                           num_elites=9, num_pi_trajs=5, iterations=3))
    cfg.obs_shape, cfg.action_dim, cfg.episode_length = {'state': (10,)}, 3, 30
    ag = TDMPC2(cfg)
    g = torch.Generator().manual_seed(0)
    params = ag.model.init(g)

    def perturb(t):
        if isinstance(t, dict):
            return {k: perturb(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(perturb(v) for v in t)
        return t + 0.05 * torch.randn(t.shape, generator=g)
    ag.load_params(perturb(params))
    return ag


def _heads(ag):
    return dict(log_std_min=ag.model.log_std_min,
                log_std_dif=ag.model.log_std_dif, simnorm_dim=8)


def test_value_kernel_matches_plain(agent):
    cfg, dev = agent.cfg, agent.device
    S, H, A = cfg.num_samples, cfg.horizon, cfg.action_dim
    g = torch.Generator(device=dev).manual_seed(1)
    z0 = simnorm(torch.randn(S, cfg.latent_dim, device=dev, generator=g), 8)
    acts = torch.rand(S, H * A, device=dev, generator=g) * 2 - 1
    args = (agent.prep, z0[None], acts.view(1, S, H, A).permute(0, 2, 1, 3),
            torch.randn(1, S, A, device=dev, generator=g),
            torch.tensor([[2, 0]], dtype=torch.int32, device=dev),
            agent.discs[None])
    n0 = value_estimate.launches
    got = value_estimate(*args, **_heads(agent))
    assert value_estimate.launches == n0 + 1
    torch.testing.assert_close(got, value_estimate_plain(*args, **_heads(agent)),
                               **BAND)
    # broadcast latent rows (stride 0), as the planner passes them
    zb = z0[None, :1].expand(1, S, -1)
    torch.testing.assert_close(
        value_estimate(agent.prep, zb, *args[2:], **_heads(agent)),
        value_estimate_plain(agent.prep, zb, *args[2:], **_heads(agent)), **BAND)


def test_value_wrapper_refuses_f32_weights(agent):
    prep32 = prepare_value_params(agent.params, agent.cfg, torch.float32)
    S, dev = 8, agent.device
    with pytest.raises(ValueError, match='prepared weight'):
        value_estimate(prep32, torch.zeros(1, S, agent.cfg.latent_dim, device=dev),
                       torch.zeros(1, 3, S, 3, device=dev),
                       torch.zeros(1, S, 3, device=dev),
                       torch.zeros(1, 2, dtype=torch.int32, device=dev),
                       agent.discs[None], **_heads(agent))


def test_pi_rollout_kernel_matches_plain(agent):
    noise = agent.draw_noise()          # one env: a leading axis of 1
    z0 = agent.model.encode(agent.params, torch.randn(1, 10, device=agent.device))
    n_pi = agent.cfg.num_pi_trajs
    args = (agent.prep, z0[None], noise.pi_eps[:, :n_pi])
    pa = cem.pi_rollout(*args, **_heads(agent))
    torch.testing.assert_close(pa, cem.pi_rollout_plain(*args, **_heads(agent)), **BAND)


def _sampled_inputs(ag, n, n_pi, seed):
    """The sampled value step's operands for n envs with n_pi policy rows:
    a broadcast latent, strided noise views, means and stds that clip some
    samples, every per-env operand its own."""
    cfg, dev = ag.cfg, ag.device
    H, A, S = cfg.horizon, cfg.action_dim, cfg.num_samples
    g = torch.Generator(device=dev).manual_seed(seed)
    z0 = ag.model.encode(ag.params, torch.randn(n, 1, 10, device=dev, generator=g))
    noise = torch.randn(n, 2, S, H * A, device=dev, generator=g)[:, 1]
    pi_acts = torch.rand(n, n_pi, H * A, device=dev, generator=g) * 2 - 1
    amask = torch.ones(A, device=dev)
    amask[-1] = 0
    qidx = torch.stack([torch.randperm(cfg.num_q, device=dev, generator=g)[:2]
                        for _ in range(n)]).to(torch.int32)
    return (ag.prep, z0.expand(n, S, -1),
            torch.rand(n, H * A, device=dev, generator=g) * 1.6 - 0.8,
            torch.rand(n, H * A, device=dev, generator=g) * 1.9 + 0.1, noise, pi_acts,
            amask, torch.randn(n, S, A, device=dev, generator=g), qidx,
            ag.discs.expand(n, -1))


def _hold_sampled(ag, args, episodic, task=None):
    """The fused kernel's actions equal sample_actions_plain's and its values
    (and flags) the given-actions launch's on those actions (with the same
    mask on the terminal policy, and the same task ids), exactly."""
    n, S = args[1].shape[:2]
    H, A = ag.cfg.horizon, ag.cfg.action_dim
    k_at = torch.empty(n, S, dtype=torch.int32, device=ag.device)
    at = torch.empty_like(k_at)
    n0 = value_sampled.launches
    v, acts = value_sampled(*args, **_heads(ag), episodic=episodic, term_at=k_at,
                            task=task)
    assert value_sampled.launches == n0 + 1
    torch.testing.assert_close(acts, sample_actions_plain(*args[2:7]), rtol=0, atol=0)
    ref = value_estimate(args[0], args[1], acts.view(n, S, H, A).permute(0, 2, 1, 3),
                         *args[7:], **_heads(ag), episodic=episodic, term_at=at,
                         task=task, amask=args[6])
    torch.testing.assert_close(v, ref, rtol=0, atol=0)
    assert torch.equal(k_at, at)
    return v, acts, k_at


@pytest.mark.parametrize('n_pi', [0, 24])
@pytest.mark.parametrize('n', [1, 8])
def test_value_sampled_matches_sample_plain_and_value_kernel(agent, n, n_pi):
    """S = 77 (a ragged last row tile); the rows below n_pi take the policy
    prior's actions."""
    args = _sampled_inputs(agent, n, n_pi, 30 + n + n_pi)
    v, acts, _ = _hold_sampled(agent, args, False)
    if n_pi:
        torch.testing.assert_close(acts[:, :n_pi], args[5] * args[6].repeat(
            agent.cfg.horizon), rtol=0, atol=0)
    # and the plain version of the whole step, in the value band
    v_p, acts_p = value_sampled_plain(*args, **_heads(agent))
    torch.testing.assert_close(acts, acts_p, rtol=0, atol=0)
    torch.testing.assert_close(v, v_p, **BAND)


def test_value_sampled_n8_equals_single_env_launches(agent):
    n = 8
    args = _sampled_inputs(agent, n, 24, 41)
    v, acts = value_sampled(*args, **_heads(agent))
    for i in range(n):
        one = value_sampled(*[a if a is args[0] or a is args[6] else a[i:i + 1]
                              for a in args], **_heads(agent))
        assert torch.equal(v[i:i + 1], one[0]) and torch.equal(acts[i:i + 1], one[1])


@pytest.mark.parametrize('values', ['distinct', 'tied', 'nan'])
def test_elite_kernel_matches_plain(agent, values):
    dev, S, HA = agent.device, 300, 9
    g = torch.Generator(device=dev).manual_seed(2)
    acts = torch.rand(1, S, HA, device=dev, generator=g) * 2 - 1
    v = torch.randn(1, S, 1, device=dev, generator=g)
    if values == 'tied':
        v = torch.full_like(v, 0.25)
    elif values == 'nan':
        v[:, ::7] = float('nan')
        v[0, 3] = float('inf')
    kw = dict(num_elites=17, temperature=0.5, min_std=0.05, max_std=2.0)
    amask = torch.ones(3, device=dev)
    got = cem.elite_moments(v, acts, amask, **kw)
    ref = cem.elite_moments_plain(v, acts, amask, **kw)
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, **ELITE)


@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (python -m pytest -m cuda on the card)')
    return torch.device('cuda')


def _elite_values(kind, n, S, g):
    """[n, S, 1] values: distinct, integer ties across the elite boundary,
    all tied, or normal values with NaN, +-inf, +-3e38 and 3.3e38 (guarded
    to 0) among them."""
    dev = g.device
    if kind == 'boundary-ties':
        return torch.randint(-3, 4, (n, S, 1), device=dev, generator=g).float()
    if kind == 'all-tied':
        return torch.full((n, S, 1), 0.25, device=dev)
    v = torch.randn(n, S, 1, device=dev, generator=g)
    if kind == 'guarded':
        v[:, ::7] = float('nan')
        v[:, 1::9] = float('inf')
        v[:, 2::11] = -float('inf')
        v[:, 3::5] = 3.0e38
        v[:, 4::13] = -3.0e38
        v[:, 5::17] = 3.3e38
    return v


def _elite_check(got, ref):
    for a, b in zip(got[:2], ref[:2]):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, **ELITE)
    torch.testing.assert_close(got[2], ref[2], rtol=0, atol=0)


@pytest.mark.parametrize('S,HA,A', [(77, 6, 2), (2048, 6, 2), (512, 114, 38)])
@pytest.mark.parametrize('E', ['1', 'S', 'S/8'])
@pytest.mark.parametrize('kind', ['distinct', 'boundary-ties', 'all-tied', 'guarded'])
def test_elite_kernel_edge_cases(card, kind, E, S, HA, A):
    """Registers (S <= 512) and shared memory (S = 2048) for the values;
    actions staged in shared memory (HA = 6) or read from L2 (HA = 114)."""
    g = torch.Generator(device=card).manual_seed(S + HA)
    v = _elite_values(kind, 1, S, g)
    acts = torch.rand(1, S, HA, device=card, generator=g) * 2 - 1
    amask = torch.ones(A, device=card)
    amask[-1] = 0
    kw = dict(num_elites={'1': 1, 'S': S, 'S/8': S // 8}[E], temperature=0.5,
              min_std=0.05, max_std=2.0)
    n0 = cem.elite_moments.launches
    got = cem.elite_moments(v, acts, amask, **kw)
    assert cem.elite_moments.launches == n0 + 1
    _elite_check(got, cem.elite_moments_plain(v, acts, amask, **kw))


@pytest.mark.parametrize('S,HA,A', [(512, 6, 2), (2048, 6, 2), (512, 114, 38)])
def test_elite_kernel_n8_equals_single_env_launches(card, S, HA, A):
    n = 8
    g = torch.Generator(device=card).manual_seed(5)
    kinds = ['distinct', 'boundary-ties', 'all-tied', 'guarded']
    v = torch.cat([_elite_values(kinds[i % 4], 1, S, g) for i in range(n)])
    acts = torch.rand(n, S, HA, device=card, generator=g) * 2 - 1
    amask = torch.ones(A, device=card)
    kw = dict(num_elites=S // 8, temperature=0.5, min_std=0.05, max_std=2.0)
    got = cem.elite_moments(v, acts, amask, **kw)
    _elite_check(got, cem.elite_moments_plain(v, acts, amask, **kw))
    for i in range(n):
        one = cem.elite_moments(v[i:i + 1], acts[i:i + 1], amask, **kw)
        for a, b in zip(got, one):
            torch.testing.assert_close(a[i:i + 1], b, rtol=0, atol=0)


def test_elite_kernel_shared_memory_limit(card):
    """S = 28,000 fits (values and row list, 8 bytes a sample); 30,000 does
    not and raises, naming the shape."""
    g = torch.Generator(device=card).manual_seed(6)
    kw = dict(num_elites=100, temperature=0.5, min_std=0.05, max_std=2.0)
    amask = torch.ones(2, device=card)
    v = torch.randn(1, 28000, device=card, generator=g)
    acts = torch.rand(1, 28000, 6, device=card, generator=g) * 2 - 1
    _elite_check(cem.elite_moments(v, acts, amask, **kw),
                 cem.elite_moments_plain(v, acts, amask, **kw))
    with pytest.raises(ValueError, match='S=30000 samples of HA=6 columns'):
        cem.elite_moments(torch.zeros(1, 30000, device=card),
                          torch.zeros(1, 30000, 6, device=card), amask, **kw)


def test_cem_plan_kernels_match_plain(agent):
    cfg = agent.cfg
    noise = agent.draw_noise()
    z0 = agent.model.encode(agent.params, torch.randn(1, 10, device=agent.device))
    HA = cfg.horizon * cfg.action_dim
    args = (agent.prep, z0[None], noise.pi_eps, noise.sample, noise.eps,
            noise.qidx, agent.discs[None], torch.zeros(1, HA, device=agent.device),
            torch.full((1, HA), cfg.max_std, device=agent.device), agent.amask)
    kw = dict(iterations=agent.iterations, n_pi=cfg.num_pi_trajs,
              num_elites=cfg.num_elites, temperature=cfg.temperature,
              min_std=cfg.min_std, max_std=cfg.max_std, **_heads(agent))
    mk, sk, vk, ak = cem.cem_plan(*args, **kw)
    mp, sp, vp, ap = cem.cem_plan_plain(*args, **kw)
    torch.testing.assert_close(mk, mp, rtol=0, atol=0.15)
    torch.testing.assert_close(sk, sp, rtol=0, atol=0.15)
    assert vk.shape == vp.shape and ak.shape == ap.shape


def test_act_on_card(agent):
    import numpy as np
    counts = cem.elite_moments.launches
    a = agent.act(np.zeros(10, np.float32), t0=True, eval_mode=True)
    assert a.shape == (3,) and np.isfinite(a).all()
    assert cem.elite_moments.launches == counts + agent.iterations


def _n_env_inputs(agent, n):
    """Per-env operands of one CEM iteration for n envs, as the planner
    lays them out (strided noise views, a broadcast latent)."""
    cfg, dev = agent.cfg, agent.device
    H, A, S, L = cfg.horizon, cfg.action_dim, cfg.num_samples, cfg.latent_dim
    noise = agent.draw_noise(n)
    z0 = agent.model.encode(agent.params, torch.randn(n, 10, device=dev))[:, None]
    n_pi = cfg.num_pi_trajs
    pa = cem.pi_rollout_plain(agent.prep, z0, noise.pi_eps[:, :n_pi], **_heads(agent))
    mean = torch.rand(n, H * A, device=dev) * 0.4 - 0.2
    std = torch.rand(n, H * A, device=dev) + 0.1
    acts = sample_actions_plain(mean, std, noise.sample[:, 0], pa, agent.amask)
    discs = torch.stack([g ** torch.arange(H + 1, device=dev, dtype=torch.float32)
                         for g in torch.linspace(0.9, 0.99, n).tolist()])
    return dict(noise=noise, z0=z0, z=z0.expand(n, S, L), pa=pa, mean=mean,
                std=std, acts=acts, discs=discs,
                actions=acts.view(n, S, H, A).permute(0, 2, 1, 3))


def test_n_env_kernels_match_plain_and_single_env_launches(agent):
    """Each kernel's env axis: one launch for n envs against the plain
    version (the bands above) and against n one-env launches, bit for bit
    (every env's blocks compute as a one-env launch's do)."""
    n, cfg = 4, agent.cfg
    x = _n_env_inputs(agent, n)
    noise, n_pi = x['noise'], cfg.num_pi_trajs
    kw = dict(num_elites=cfg.num_elites, temperature=0.5, min_std=0.05, max_std=2.0)
    v_args = (agent.prep, x['z'], x['actions'], noise.eps[:, 0], noise.qidx[:, 0],
              x['discs'])
    calls = {
        'value': (value_estimate, value_estimate_plain, v_args, _heads(agent), BAND),
        'pi_rollout': (cem.pi_rollout, cem.pi_rollout_plain,
                       (agent.prep, x['z0'], noise.pi_eps[:, :n_pi]), _heads(agent),
                       BAND),
        'value_sampled': (value_sampled, value_sampled_plain,
                          (agent.prep, x['z'], x['mean'], x['std'], noise.sample[:, 0],
                           x['pa'], agent.amask, noise.eps[:, 0], noise.qidx[:, 0],
                           x['discs']), _heads(agent), BAND),
        'elite': (cem.elite_moments, cem.elite_moments_plain,
                  (value_estimate_plain(*v_args, **_heads(agent)), x['acts'],
                   agent.amask), kw, ELITE),
    }
    for name, (kern, plain, args, extra, tol) in calls.items():
        got = kern(*args, **extra)
        ref = plain(*args, **extra)
        for g, r in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            assert g.shape[0] == n and torch.isfinite(g).all(), name
            torch.testing.assert_close(g, r, **tol, msg=name)
        singles = [kern(*[a if a is agent.prep or a is agent.amask else a[i:i + 1]
                          for a in args], **extra) for i in range(n)]
        for i, one in enumerate(singles):
            for g, o in zip(got if isinstance(got, tuple) else (got,),
                            one if isinstance(one, tuple) else (one,)):
                torch.testing.assert_close(g[i:i + 1], o, rtol=0, atol=0, msg=name)


def test_plan_vec_on_card_matches_plain(agent):
    cfg, n = agent.cfg, 4
    x = _n_env_inputs(agent, n)
    noise = x['noise']
    HA = cfg.horizon * cfg.action_dim
    args = (agent.prep, x['z0'], noise.pi_eps, noise.sample, noise.eps, noise.qidx,
            x['discs'], torch.zeros(n, HA, device=agent.device),
            torch.full((n, HA), cfg.max_std, device=agent.device), agent.amask)
    kw = dict(iterations=agent.iterations, n_pi=cfg.num_pi_trajs,
              num_elites=cfg.num_elites, temperature=cfg.temperature,
              min_std=cfg.min_std, max_std=cfg.max_std, **_heads(agent))
    mk, sk, vk, ak = cem.cem_plan(*args, **kw)
    mp, sp, vp, ap = cem.cem_plan_plain(*args, **kw)
    torch.testing.assert_close(mk, mp, rtol=0, atol=0.15)
    torch.testing.assert_close(sk, sp, rtol=0, atol=0.15)
    assert vk.shape == (n, cfg.num_samples, 1) and ak.shape == ap.shape
    agent.prev_mean = torch.zeros(n, cfg.horizon, cfg.action_dim, device=agent.device)
    counts = cem.elite_moments.launches
    a = agent.act(np.zeros((n, 10), np.float32), t0=True)
    assert a.shape == (n, cfg.action_dim) and np.isfinite(a).all()
    assert cem.elite_moments.launches == counts + agent.iterations


def test_rollout_kernel_matches_plain(agent):
    cfg, dev = agent.cfg, agent.device
    S, H, A, L = cfg.num_samples, cfg.horizon, cfg.action_dim, cfg.latent_dim
    g = torch.Generator(device=dev).manual_seed(3)
    z0 = simnorm(torch.randn(S, L, device=dev, generator=g), 8)
    acts = (torch.rand(S, H * A, device=dev, generator=g) * 2 - 1).view(
        S, H, A).permute(1, 0, 2)
    prep = rollout.prepare_rollout_params(agent.params['dynamics'],
                                          agent.params['reward'], L,
                                          cfg.vmin, cfg.vmax)
    kw = dict(horizon=H, discount=agent.discount, simnorm_dim=8)
    for z in (z0, z0[:1].expand(S, -1)):
        n0 = rollout.rollout_prepared.launches
        G, zH = rollout.rollout_prepared(prep, z, acts, **kw)
        assert rollout.rollout_prepared.launches == n0 + 1
        Gp, zHp = rollout.rollout_prepared_plain(prep, z, acts, **kw)
        torch.testing.assert_close(G, Gp, **BAND)
        torch.testing.assert_close(zH, zHp, **BAND)


def test_probe_kernel_and_canary(agent):
    assert probe.kernel_engine_alive(agent.device)
    x = torch.randn(probe.SHAPE, device=agent.device)
    n0 = probe.add_one.launches
    torch.testing.assert_close(probe.add_one(x), probe.add_one_plain(x),
                               rtol=0, atol=0)
    assert probe.add_one.launches == n0 + 1


@pytest.mark.parametrize('n', [1, 3, 1027, 'offset 1'])
def test_probe_kernel_any_size_and_offset(card, n):
    """Scalar head and tail around the float4 body: sizes not a multiple
    of 4, and a view with a storage offset of one float (x not 16-byte
    aligned, out aligned)."""
    g = torch.Generator(device=card).manual_seed(7)
    if n == 'offset 1':
        x = torch.randn(1028, device=card, generator=g)[1:]
        assert x.storage_offset() == 1 and x.is_contiguous()
    else:
        x = torch.randn(n, device=card, generator=g)
    n0 = probe.add_one.launches
    torch.testing.assert_close(probe.add_one(x), probe.add_one_plain(x), rtol=0, atol=0)
    assert probe.add_one.launches == n0 + 1


def _episodes(rng, n, rows=31, obs=10, act=3):
    for _ in range(n):
        ep = dict(obs=rng.normal(size=(rows, obs)).astype(np.float32),
                  action=rng.uniform(-1, 1, (rows, act)).astype(np.float32),
                  reward=rng.uniform(size=rows).astype(np.float32),
                  terminated=np.zeros(rows, np.float32))
        ep['action'][0] = ep['reward'][0] = ep['terminated'][0] = np.nan
        yield ep


def test_buffer_in_host_memory_feeds_the_card(agent, monkeypatch):
    """When 2.5x the ring does not fit in the card's free memory, the ring
    stays in host RAM and each batch is copied to the card."""
    cfg = parse_cfg(Config(task='toy', device='cuda', batch_size=8,
                           buffer_size=300, steps=300))
    cfg.episode_length = 30
    on_card, in_host = Buffer(cfg), Buffer(cfg)
    for ep in _episodes(np.random.default_rng(1), 4):
        on_card.add(ep)
    # the ring is placed at the first add
    monkeypatch.setattr(torch.cuda, 'mem_get_info', lambda *a: (1, 1 << 30))
    for ep in _episodes(np.random.default_rng(1), 4):
        in_host.add(ep)
    assert on_card._storage['obs'].is_cuda
    assert in_host._storage['obs'].device.type == 'cpu'
    batch = in_host.sample()
    assert all(x.is_cuda for x in batch)
    ep_idx = torch.tensor([0, 3, 1, 2, 3, 0, 1, 2])
    start = torch.tensor([0, 27, 5, 9, 11, 3, 26, 0])
    for a, b in zip(in_host.gather(ep_idx, start), on_card.gather(ep_idx, start)):
        assert a.is_cuda and b.is_cuda
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_update_on_card_matches_cpu(agent):
    cfg = agent.cfg
    cfg.batch_size, cfg.buffer_size, cfg.steps = 16, 300, 300
    buf = Buffer(cfg)
    for ep in _episodes(np.random.default_rng(0), 3):
        buf.add(ep)
    for _ in range(3):        # past Adam's first steps, which are sign(g)
        agent.update(buf)
    cpu = TDMPC2(cfg, device='cpu')
    cpu.state = agent.state.to('cpu')
    batch = buf.sample()
    noise = agent.draw_update_noise()
    cpu_noise = UpdateNoise(**{k: None if v is None else v.cpu()
                               for k, v in vars(noise).items()})
    info = agent._update(agent.state, *batch, noise)
    ref = cpu._update(cpu.state, *[x.cpu() for x in batch], cpu_noise)
    for k in ref:
        torch.testing.assert_close(info[k].cpu(), ref[k], rtol=1e-4, atol=1e-4)
    got = agent.state.to('cpu')
    for name in ('params', 'target_Qs', 'opt_state', 'pi_opt_state'):
        for a, b in zip(tree.leaves(getattr(got, name)),
                        tree.leaves(getattr(cpu.state, name))):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------- episodic


@pytest.fixture(scope='module')
def episodic_agent(agent):
    """The module's agent on an episodic task, its termination head spread
    (logit std 4 on one-step latents) and centred so that about half of
    the H-step rollouts end flagged."""
    cfg = agent.cfg.replace(episodic=True)
    ag = TDMPC2(cfg)
    g = torch.Generator().manual_seed(1)
    params = tree.map(lambda t: t + 0.05 * torch.randn(t.shape, generator=g),
                      ag.model.init(g))
    ag.load_params(params)
    dev, H, A = ag.device, cfg.horizon, cfg.action_dim
    gd = torch.Generator(device=dev).manual_seed(5)
    z = ag.model.encode(ag.params, torch.randn(1, 256, 10, device=dev, generator=gd))
    acts = torch.rand(1, H, 256, A, device=dev, generator=gd) * 2 - 1
    prep32 = prepare_value_params(ag.params, cfg, torch.float32)
    logits, _ = termination_trace_plain(prep32, z, acts, ag.discs[None])
    last = ag.params['termination'][-1]
    scale = 4.0 / float(logits[:, 0].std())
    last['w'].mul_(scale)
    last['b'].mul_(scale).sub_(float((logits * scale).amax(1).median()))
    ag._prep = None
    return ag


def _episodic_inputs(ag, n, seed):
    cfg, dev = ag.cfg, ag.device
    S, H, A = cfg.num_samples, cfg.horizon, cfg.action_dim
    g = torch.Generator(device=dev).manual_seed(seed)
    z = ag.model.encode(ag.params, torch.randn(n, 1, 10, device=dev, generator=g))
    acts = torch.rand(n, S, H * A, device=dev, generator=g) * 2 - 1
    qidx = torch.stack([torch.randperm(cfg.num_q, device=dev, generator=g)[:2]
                        for _ in range(n)]).to(torch.int32)
    return (ag.prep, z.expand(n, S, -1), acts.view(n, S, H, A).permute(0, 2, 1, 3),
            torch.randn(n, S, A, device=dev, generator=g), qidx,
            ag.discs.expand(n, -1))


@pytest.mark.parametrize('n', [1, 4])
def test_episodic_value_kernel_matches_plain_under_gate_rule(episodic_agent, n):
    ag = episodic_agent
    args = _episodic_inputs(ag, n, 6 + n)
    N, S = n, ag.cfg.num_samples
    k_at = torch.empty(N, S, dtype=torch.int32, device=ag.device)
    p_at = torch.empty_like(k_at)
    got = value_estimate(*args, **_heads(ag), episodic=True, term_at=k_at)
    ref = value_estimate_plain(*args, **_heads(ag), episodic=True, term_at=p_at)
    logits, at = termination_trace_plain(*args[:3], args[5])
    torch.testing.assert_close(at, p_at, rtol=0, atol=0)
    share = float((p_at > 0).float().mean())
    assert 0.05 < share < 0.95, share            # the gate splits the rows
    flips, bad = gate_check(got, ref, k_at, p_at, logits, **BAND)
    assert bad == 0 and flips <= 0.01 * N * S, (flips, bad)
    # the gate changes the value: not the non-episodic launch's
    assert not torch.allclose(got, value_estimate(*args, **_heads(ag)), **BAND)


def test_episodic_n_env_launch_equals_single_env_launches(episodic_agent):
    ag, n = episodic_agent, 4
    args = _episodic_inputs(ag, n, 11)
    S = ag.cfg.num_samples
    k_at = torch.empty(n, S, dtype=torch.int32, device=ag.device)
    got = value_estimate(*args, **_heads(ag), episodic=True, term_at=k_at)
    for i in range(n):
        one_at = torch.empty(1, S, dtype=torch.int32, device=ag.device)
        one = value_estimate(args[0], *[a[i:i + 1] for a in args[1:]], **_heads(ag),
                             episodic=True, term_at=one_at)
        assert torch.equal(got[i:i + 1], one) and torch.equal(k_at[i:i + 1], one_at)


def test_episodic_act_on_card(episodic_agent):
    ag, n = episodic_agent, 4
    launches = value_sampled.launches
    ag.prev_mean = torch.zeros(n, ag.cfg.horizon, ag.cfg.action_dim, device=ag.device)
    a = ag.act(np.zeros((n, 10), np.float32), t0=True)
    assert a.shape == (n, ag.cfg.action_dim) and np.isfinite(a).all()
    assert value_sampled.launches == launches + ag.iterations


@pytest.mark.parametrize('n', [1, 8])
def test_episodic_value_sampled_matches_value_kernel(episodic_agent, n):
    """The termination gate in the sampled mode: flags and values equal
    the given-actions launch's on the same actions, bit for bit."""
    args = _sampled_inputs(episodic_agent, n, 24, 50 + n)
    _, _, k_at = _hold_sampled(episodic_agent, args, True)
    share = float((k_at > 0).float().mean())
    assert 0.05 < share < 0.95, share            # the gate splits the rows


# ------------------------------------------------------------ model widths


def _sized_agent(size, A=3):
    """An episodic agent at the widths of `size` with A actions, S = 77
    (ragged row tiles), its termination head spread and centred as above.
    Weights are perturbed by 0.05 * sqrt(512 / mlp_dim), so that each
    width's logits spread as the default model's do
    (chip_smoke.sweep_scale)."""
    cfg = parse_cfg(Config(task='toy', device='cuda', model_size=size, episodic=True,
                           num_samples=77, num_elites=9, num_pi_trajs=5, iterations=3))
    cfg.obs_shape, cfg.action_dim, cfg.episode_length = {'state': (10,)}, A, 30
    ag = TDMPC2(cfg)
    g = torch.Generator().manual_seed(size)
    scale = 0.05 * (512 / cfg.mlp_dim) ** 0.5
    ag.load_params(tree.map(lambda t: t + scale * torch.randn(t.shape, generator=g),
                            ag.model.init(g)))
    dev, H, A = ag.device, cfg.horizon, cfg.action_dim
    gd = torch.Generator(device=dev).manual_seed(size)
    z = ag.model.encode(ag.params, torch.randn(1, 256, 10, device=dev, generator=gd))
    acts = torch.rand(1, H, 256, A, device=dev, generator=gd) * 2 - 1
    prep32 = prepare_value_params(ag.params, cfg, torch.float32)
    logits, _ = termination_trace_plain(prep32, z, acts, ag.discs[None])
    last = ag.params['termination'][-1]
    scale = 4.0 / float(logits[:, 0].std())
    last['w'].mul_(scale)
    last['b'].mul_(scale).sub_(float((logits * scale).amax(1).median()))
    ag._prep = None
    return ag


@pytest.mark.parametrize('size', [1, 19, 48])
def test_kernels_match_plain_at_model_widths(agent, size):
    """The value kernel (both branches) and the pi rollout at the widths of
    model_size 1, 19 and 48, one env, in the bands above."""
    ag = _sized_agent(size)
    S = ag.cfg.num_samples
    args = _episodic_inputs(ag, 1, 20 + size)
    torch.testing.assert_close(value_estimate(*args, **_heads(ag)),
                               value_estimate_plain(*args, **_heads(ag)), **BAND)
    k_at = torch.empty(1, S, dtype=torch.int32, device=ag.device)
    p_at = torch.empty_like(k_at)
    got = value_estimate(*args, **_heads(ag), episodic=True, term_at=k_at)
    ref = value_estimate_plain(*args, **_heads(ag), episodic=True, term_at=p_at)
    logits, _ = termination_trace_plain(*args[:3], args[5])
    flips, bad = gate_check(got, ref, k_at, p_at, logits, **BAND)
    assert bad == 0 and flips <= 0.01 * S, (flips, bad)
    z0 = ag.model.encode(ag.params, torch.randn(1, 10, device=ag.device))
    pi_args = (ag.prep, z0[None], ag.draw_noise().pi_eps[:, :ag.cfg.num_pi_trajs])
    torch.testing.assert_close(cem.pi_rollout(*pi_args, **_heads(ag)),
                               cem.pi_rollout_plain(*pi_args, **_heads(ag)), **BAND)


def test_width_without_row_tile_raises(agent):
    """mlp_dim 4096 (model_size 317's) fits no row tile: the wrappers take
    the wide engine there (ops/wide.py) and plan. Above the wide engine's
    4096 columns the wrappers raise naming the widths, before any launch,
    and run no plain version."""
    prep = dict(agent.prep)
    L = agent.cfg.latent_dim
    S, A, dev = 8, agent.cfg.action_dim, agent.device
    dims = (L, 4096, A, 101, 3, 8, 3)
    assert wide.engine(_build.library('value'), dims) == 'wide'
    prep['dWz'] = torch.zeros(L, 8192, dtype=torch.bfloat16, device=agent.device)
    n0 = value_estimate.launches
    with pytest.raises(ValueError, match='no engine takes the widths.*M=8192'):
        value_estimate(prep, torch.zeros(1, S, L, device=dev),
                       torch.zeros(1, 3, S, A, device=dev), torch.zeros(1, S, A, device=dev),
                       torch.zeros(1, 2, dtype=torch.int32, device=dev),
                       agent.discs[None], **_heads(agent))
    with pytest.raises(ValueError, match='no engine takes the widths.*M=8192'):
        cem.pi_rollout(prep, torch.zeros(1, 1, L, device=dev),
                       torch.zeros(1, 4, 3 * A, device=dev), **_heads(agent))
    assert value_estimate.launches == n0


# ------------------------------------------ widths above the row tiles: 317


@pytest.fixture(scope='module')
def wide_agent(agent):
    """An episodic agent at model_size 317's widths (L 1376, M 4096, 8 Q
    heads), S = 77: the wide engine, rows ragged against its 128-row tiles."""
    return _sized_agent(317)


@pytest.mark.parametrize('n', [1, 8])
def test_wide_engine_matches_plain_at_317_widths(wide_agent, n):
    """The value step (given actions, and episodic under the gate rule), the
    sampled step (exactly the given-actions launch on its actions), the pi
    rollout (each step on its own inputs) and the rollout on the wide engine
    against their plain versions, in the bands above; each call's device
    launches counted."""
    ag = wide_agent
    cfg, dev = ag.cfg, ag.device
    S, H, A, L = cfg.num_samples, cfg.horizon, cfg.action_dim, cfg.latent_dim
    args = _episodic_inputs(ag, n, 317 + n)
    assert kernel_plan(ag.prep, 8, H)['route'] == 'wide'
    w0 = wide.engine_launches.launches
    torch.testing.assert_close(value_estimate(*args, **_heads(ag)),
                               value_estimate_plain(*args, **_heads(ag)), **BAND)
    assert wide.engine_launches.launches == w0 + wide.value_launches(H, False)
    k_at = torch.empty(n, S, dtype=torch.int32, device=dev)
    p_at = torch.empty_like(k_at)
    got = value_estimate(*args, **_heads(ag), episodic=True, term_at=k_at)
    ref = value_estimate_plain(*args, **_heads(ag), episodic=True, term_at=p_at)
    logits, _ = termination_trace_plain(*args[:3], args[5])
    flips, bad = gate_check(got, ref, k_at, p_at, logits, **BAND)
    if bad:
        # At 4096 columns the termination logits of two plain versions (the
        # CPU's, the card's) differ by up to ~0.2 (logit std 4): a flip is
        # allowed where the plain |logit| is within that measured spread.
        cpu = [{k: x.cpu() for k, x in args[0].items()}] + [x.cpu() for x in args[1:]]
        lc, _ = termination_trace_plain(*cpu[:3], cpu[5])
        spread = float((lc - logits.cpu()).abs().max())
        flips, bad = gate_check(got, ref, k_at, p_at, logits, **BAND,
                                near=max(1e-2, spread))
    assert bad == 0 and flips <= 0.01 * n * S, (flips, bad)
    sargs = _sampled_inputs(ag, n, cfg.num_pi_trajs, 31 + n)
    v, _, _ = _hold_sampled(ag, sargs, False)
    torch.testing.assert_close(v, value_sampled_plain(*sargs, **_heads(ag))[0], **BAND)
    z0 = ag.model.encode(ag.params, torch.randn(n, 10, device=dev))[:, None]
    pi_args = (ag.prep, z0, ag.draw_noise(n).pi_eps[:, :cfg.num_pi_trajs])
    pa = cem.pi_rollout(*pi_args, **_heads(ag))
    # Held at each step on its own inputs: the kernel's latents (the launch
    # unchanged by writing them) against the plain dynamics of its (z_t,
    # a_t), its actions against the plain policy at its latents. Free
    # running, a last-bit difference ahead of a bf16 rounding moves the next
    # latent, and the policy's exp(log_std) amplifies it: at 4096 columns two
    # plain versions (the CPU's, the card's) leave the band on as many values
    # as the kernel does (PERF.md §6).
    zs = torch.empty(H - 1, n, cfg.num_pi_trajs, L, device=dev)
    assert torch.equal(cem.pi_rollout(*pi_args, **_heads(ag), latents=zs), pa)
    z = z0.expand(n, cfg.num_pi_trajs, L)
    for t in range(H):
        sl = slice(t * A, (t + 1) * A)
        mean, ls = pi_head_plain(ag.prep, z, ag.model.log_std_min, ag.model.log_std_dif)
        torch.testing.assert_close(pa[..., sl], pi_action_plain(mean, ls, pi_args[2][..., sl],
                                                                1.0), **BAND)
        if t + 1 < H:
            torch.testing.assert_close(zs[t], dynamics_plain(ag.prep, z, pa[..., sl], 8),
                                       **BAND)
            z = zs[t]
    prep_r = rollout.prepare_rollout_params(ag.params['dynamics'], ag.params['reward'],
                                            L, cfg.vmin, cfg.vmax)
    kw = dict(horizon=H, discount=ag.discount, simnorm_dim=8)
    acts = args[2][0]
    w0 = wide.engine_launches.launches
    G, zH = rollout.rollout_prepared(prep_r, args[1][0], acts, **kw)
    assert wide.engine_launches.launches == w0 + wide.rollout_launches(H)
    Gp, zHp = rollout.rollout_prepared_plain(prep_r, args[1][0], acts, **kw)
    torch.testing.assert_close(G, Gp, **BAND)
    torch.testing.assert_close(zH, zHp, **BAND)


def test_wide_engine_n8_equals_single_env_launches(wide_agent):
    """N = 8 envs on the wide engine equal 8 one-env launches bit for bit:
    the value step (both branches, with the flags), the sampled step and the
    pi rollout."""
    ag, n = wide_agent, 8
    S, dev = ag.cfg.num_samples, ag.device
    args = _episodic_inputs(ag, n, 71)
    for episodic in (False, True):
        at = torch.empty(n, S, dtype=torch.int32, device=dev)
        got = value_estimate(*args, **_heads(ag), episodic=episodic, term_at=at)
        for i in range(n):
            one_at = torch.empty(1, S, dtype=torch.int32, device=dev)
            one = value_estimate(ag.prep, *[a[i:i + 1] for a in args[1:]], **_heads(ag),
                                 episodic=episodic, term_at=one_at)
            assert torch.equal(got[i:i + 1], one) and torch.equal(at[i:i + 1], one_at)
    sargs = _sampled_inputs(ag, n, ag.cfg.num_pi_trajs, 72)
    got = value_sampled(*sargs, **_heads(ag))
    pi_args = (ag.prep, args[1][:, :1], ag.draw_noise(n).pi_eps[:, :ag.cfg.num_pi_trajs])
    pa = cem.pi_rollout(*pi_args, **_heads(ag))
    for i in range(n):
        one = value_sampled(*[a if a is ag.prep or a is sargs[6] else a[i:i + 1]
                              for a in sargs], **_heads(ag))
        assert all(torch.equal(a[i:i + 1], b) for a, b in zip(got, one))
        one_pa = cem.pi_rollout(ag.prep, *[a[i:i + 1] for a in pi_args[1:]], **_heads(ag))
        assert torch.equal(pa[i:i + 1], one_pa)


def test_wide_plan_graph_equals_eager_body(wide_agent):
    """The 317-width agent's plan: one graph replay of the planner's
    1 + 2 x iterations calls, their wide engine's launches counted, equal
    bit for bit to the eager body on the same draws."""
    ag, n = wide_agent, 1
    ag.prev_mean = torch.zeros(n, ag.cfg.horizon, ag.cfg.action_dim, device=ag.device)
    w0 = wide.engine_launches.launches
    _hold_graph_against_eager(ag, n, True, np.array([True]), 317)
    # the capture's eager run, the replay and the eager body
    assert (wide.engine_launches.launches - w0
            == 3 * wide.plan_launches(ag.cfg.horizon, ag.iterations, True))


@pytest.mark.parametrize('size', [1, 5, 19, 48])
def test_rollout_wide_engine_matches_plain_at_model_widths(agent, size):
    """The rollout kernel, on the wide engine at every width, against its
    plain version at the widths of model_size 1, 5, 19 and 48 (S = 77)."""
    ag = _sized_agent(size)
    cfg = ag.cfg
    args = _episodic_inputs(ag, 1, 40 + size)
    prep_r = rollout.prepare_rollout_params(ag.params['dynamics'], ag.params['reward'],
                                            cfg.latent_dim, cfg.vmin, cfg.vmax)
    kw = dict(horizon=cfg.horizon, discount=ag.discount, simnorm_dim=8)
    assert kernel_plan(prep_r, 8, cfg.horizon, 'rollout')['route'] == 'wide'
    G, zH = rollout.rollout_prepared(prep_r, args[1][0], args[2][0], **kw)
    Gp, zHp = rollout.rollout_prepared_plain(prep_r, args[1][0], args[2][0], **kw)
    torch.testing.assert_close(G, Gp, **BAND)
    torch.testing.assert_close(zH, zHp, **BAND)


@pytest.mark.parametrize('size,route,rt', [(1, 'rows', 32), (5, 'rows', 32),
                                           (19, 'rows', 32), (48, 'rows', 16),
                                           (317, 'wide', None)])
def test_engine_mirror_matches_the_built_library(agent, size, route, rt):
    """The built library's engine and plan at each model size's widths
    against what the CPU tests' mirror of its rule gives
    (tests/wide_mirror.py row_tile_plan, gemm_tile): a row tile of 32
    rows (16 at 48) up to model_size 48, the wide engine at 317 with the
    product's 128 x 256 tile (two consumer warpgroups) for 512 rows an env
    and 64 x 128 (one) for the pi rollout's 24; the rollout on the wide engine at every size
    (64 x 128 below 2048 columns); at least one block an SM, launched with
    the registers that setmaxnreg's split assumes."""
    from tdmpc2_tpu_torch.config import MODEL_SIZE
    d = MODEL_SIZE[size]
    dims = (d['latent_dim'], d['mlp_dim'], 6, 101, d.get('num_q', 5), 8, 3)
    prep = {'dWz': torch.zeros(dims[0], dims[1]), 'dWa': torch.zeros(dims[2], dims[1]),
            'rW2': torch.zeros(dims[1], dims[3]), 'qWz': torch.zeros(dims[4], 1, 1)}
    assert wm.mirror_lib().tdm_engine(dims) == ('rows', 'wide').index(route)
    for kernel in ('value', 'pi_rollout'):
        for rows in (512, 24):
            plan = kernel_plan(prep, 8, 3, kernel, rows=rows)
            assert plan['route'] == plan['engine'] == route
            if rt is not None:
                assert plan['rt'] == rt and 2 <= plan['stages'] <= 8
            else:
                tile = wm.gemm_tile(dims, rows)
                assert {k: plan[k] for k in ('bm', 'bn', 'wgs')} == tile
                assert plan['bk'] == 64 and plan['stages'] == 4
                assert plan['blocks_per_sm'] >= 1
                assert plan['regs'] == 65536 // (128 * (tile['wgs'] + 1)
                                                 * (1 if tile['wgs'] == 2 else 2)) // 8 * 8
    ro = kernel_plan(prep, 8, 3, 'rollout')
    assert ro['route'] == 'wide'
    assert {k: ro[k] for k in ('bm', 'bn', 'wgs')} == wm.gemm_tile(dims, 512)


def test_card_prep_holds_its_engines_layouts(agent, wide_agent):
    """A bf16 prep on the card asks the built library which engine the
    value step and the pi rollout take: at the module's widths the row
    tiles' packed copies and, for the rollout, the wide dynamics and reward
    only; at 317's the wide layout of every matrix and no packed copy (the
    module's agent has no termination head, the 317 agent has one)."""
    assert {k for k in PACKED if k[0] != 't'} <= set(agent.prep)
    assert {k for k in WIDE if k in agent.prep} == {k for k in WIDE if k[0] in 'dr'}
    assert set(WIDE) <= set(wide_agent.prep) and not set(PACKED) & set(wide_agent.prep)


def test_rollout_sums_the_partials_of_a_narrow_latent(agent):
    """A 128-column latent under a 1024-wide MLP: the dynamics' last
    product is one column tile deep in K 1024, so it splits K over 2 blocks
    (tests/wide_mirror.py gemm_splits), and the row kernel's LayerNorm +
    SimNorm must sum the partial rows, as the two-hot decode does for the
    reward's. The rollout against its plain version in the band."""
    L, M, A, B, S, H = 128, 1024, 3, 101, 77, 3
    dims = (L, M, A, B, 0, 8, H)
    assert wm.gemm_plan(dims, 1, S, M, L, False)['splits'] == 2
    assert wm.gemm_plan(dims, 1, S, M, B, False)['splits'] == 2
    g = torch.Generator().manual_seed(L + M)
    scale = 0.05 * (512 / M) ** 0.5

    def mlp(i, o, **kw):
        return tree.map(lambda t: (t + scale * torch.randn(t.shape, generator=g)).cuda(),
                        layers.mlp_init(g, i, [M, M], o, **kw))
    dyn, rew = mlp(L + A, L, final_normed=True), mlp(L + A, B)
    prep_r = rollout.prepare_rollout_params(dyn, rew, L, -10.0, 10.0)
    assert kernel_plan(prep_r, 8, H, 'rollout')['route'] == 'wide'
    dev = torch.device('cuda')
    gd = torch.Generator(device=dev).manual_seed(L)
    z0 = simnorm(torch.randn(S, L, device=dev, generator=gd), 8)
    acts = torch.rand(H, S, A, device=dev, generator=gd) * 2 - 1
    kw = dict(horizon=H, discount=0.95, simnorm_dim=8)
    G, zH = rollout.rollout_prepared(prep_r, z0, acts, **kw)
    Gp, zHp = rollout.rollout_prepared_plain(prep_r, z0, acts, **kw)
    torch.testing.assert_close(G, Gp, **BAND)
    torch.testing.assert_close(zH, zHp, **BAND)


# The 317M model's distinct products (K, N, kind): kind 'task' a first
# layer's per-task bias rows, 'q0' the Q heads' first layer, 'q' a later Q
# layer (each env's head), 'pi' the policy head (its log-std bias past A).
_317_PRODUCTS = [(1392, 4096, 'task'), (1376, 4096, 'task'), (4096, 4096, ''),
                 (4096, 1376, ''), (4096, 101, ''), (4096, 12, 'pi'), (4096, 1, ''),
                 (1392, 4096, 'q0'), (4096, 4096, 'q'), (4096, 101, 'q')]
_317_DIMS = (1376, 4096, 6, 101, 8, 8, 3)


def _product_operands(n, S, K, N, kind, seed):
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(seed)
    NQ, T = 8, 80
    x = torch.randn(n * S, K + 16, device=dev, generator=g).to(torch.bfloat16)
    x[:, K:] = float('nan')        # never read: K is the tensor map's width
    heads = NQ if kind in ('q0', 'q') else 1
    w = (torch.randn(heads, N, K, device=dev, generator=g) * K ** -0.5).to(torch.bfloat16)
    env = torch.arange(n, device=dev, dtype=torch.int32)
    task, head = (env * 7) % T, torch.stack([(env * 3) % NQ, env % NQ], 1).to(torch.int32)
    kw = dict(task=None, ntask=1, head=None, hn=2, bt=0, bh=0)
    if kind == 'task':
        b = torch.randn(T, N, device=dev, generator=g)
        kw.update(task=task, ntask=T, bt=N)
    elif kind == 'q0':
        b = torch.randn(T, NQ, N, device=dev, generator=g)
        kw.update(task=task, ntask=T, head=head, bt=NQ * N, bh=N)
    elif kind == 'q':
        b = torch.randn(NQ, N, device=dev, generator=g)
        kw.update(head=head, bh=N)
    elif kind == 'pi':
        b = torch.randn(N // 2, device=dev, generator=g)
        kw.update(b1=torch.randn(N // 2, device=dev, generator=g), split=N // 2)
    else:
        b = torch.randn(N, device=dev, generator=g)
    # each row's weights and bias, for the plain product
    rows_env = torch.arange(n * S, device=dev) // S
    h = kw['head'][rows_env, 0].long() if kw['head'] is not None else torch.zeros_like(rows_env)
    t = kw['task'][rows_env].long() if kw['task'] is not None else torch.zeros_like(rows_env)
    bias = (torch.cat([b, kw['b1']])[None].expand(n * S, N) if kind == 'pi'
            else b[t, h] if kind == 'q0' else b[h] if kind == 'q'
            else b[t] if kind == 'task' else b[None].expand(n * S, N))
    return x, (w if heads > 1 else w[0]), b, kw, h, bias


@pytest.mark.parametrize('n', [1, 8])
@pytest.mark.parametrize('K,N,kind', _317_PRODUCTS)
def test_wide_product_matches_plain_at_317_shapes(agent, K, N, kind, n):
    """The wide engine's product alone (ops/wide.py gemm, the library's
    tdm_wide_gemm) at each distinct product of the 317M model at R = 512
    and 4,096 rows (one env and N = 8 of 512 rows) against the plain
    product x.float() @ W.float() + bias: |y - y_plain| <= 1e-4 (|x| @
    |W|)[r, c] + 1e-6 (f32 sums of bf16 products over K <= 4096: about 256
    accumulator roundings of 2^-23, with margin). x's columns past K are
    NaN: K is the width of its tensor map. The launch's plan is the
    mirror's (tests/wide_mirror.py gemm_plan). At N = 8 each env's rows
    equal a one-env launch on them bit for bit."""
    S = 512
    x, w, b, kw, h, bias = _product_operands(n, S, K, N, kind, K + N + n)
    y, plan = wide.gemm(x, w, b, _317_DIMS, S, **kw)
    want_plan = wm.gemm_plan(_317_DIMS, n, S, K, N, kind in ('task', 'q0', 'q'))
    keys = ('bm', 'bn', 'wgs', 'splits', 'kchunk', 'pstride', 'grid')
    assert {k: plan[k] for k in keys} == {k: want_plan[k] for k in keys}
    got = wide.gemm_sum(y, plan, N)
    ws = w if w.dim() == 3 else w[None]
    want = torch.empty_like(got)
    mag = torch.empty_like(got)
    xf = x[:, :K].float()
    for k in range(ws.shape[0]):
        sel = h == k
        if bool(sel.any()):
            wk = ws[k].float().t()
            want[sel] = xf[sel] @ wk
            mag[sel] = xf[sel].abs() @ wk.abs()
    want += bias
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= 1e-4 * mag + 1e-6).all()), \
        float((got - want).abs().max())
    if n > 1:
        for e in (0, 5):
            sl = slice(e * S, (e + 1) * S)
            one_kw = dict(kw, task=None if kw['task'] is None else kw['task'][e:e + 1],
                          head=None if kw['head'] is None else kw['head'][e:e + 1])
            y1, _ = wide.gemm(x[sl], w, b, _317_DIMS, S, **one_kw)
            assert torch.equal(wide.gemm_sum(y1, plan, N), got[sl])


# ------------------------------------------------ the wide engine's row kernel


@pytest.mark.parametrize('R,S', [(512, 512), (1920, 24), (4096, 512)])
@pytest.mark.parametrize('label,mode,heads', rc.ROW_CASES)
def test_wide_rows_match_plain_at_317_widths(agent, label, mode, heads, R, S):
    """The row kernel alone (ops/wide.py rows, the library's tdm_wide_rows)
    at the 317M model's widths on the rows of one env, the pi rollout's N=80
    x 24 and N=8 (row_cases.row_operands: the narrow outputs as 8 partial
    rows of a split product, the Q heads' LayerNorm with a head per env,
    NaN wherever the kernel must not read or write) against rows_plain on
    the same rows: bf16 outputs within one bf16 step, |d| <= 2^-7 |plain| +
    1e-6 (the f32 order ahead of the rounding), f32 outputs (the latent's
    f32 rows, G, q, the value, the actions) at 1e-4, the gate's flags
    exactly (row_cases.hold_rows); one launch counted; its plan the
    mirror's (tests/wide_mirror.py row_plan), on no more blocks than the
    card holds; at N=8 each env's rows bit for bit its one-env launch's."""
    g = torch.Generator(device='cuda').manual_seed(R + 7 * len(label))
    kw, per_row, per_env = rc.row_operands(mode, R, S, g, _317_DIMS, heads,
                                           fdst=mode == 'latent')
    got = rc.row_clone(kw, per_row, per_env)
    want = rc.row_clone(kw, per_row, per_env)
    n0 = wide.rows.launches
    plan = wide.rows(mode, got.pop('y'), _317_DIMS, S, **got)
    assert wide.rows.launches == n0 + 1
    wide.rows_plain(mode, want.pop('y'), _317_DIMS, S, **want)
    rc.hold_rows(label, rc.row_outputs(mode, got), rc.row_outputs(mode, want),
                 kw.get('dpad', 0))
    mirror = wm.row_plan(mode, wide.row_width(mode, _317_DIMS), kw['nsplit'], kw['pstride'],
                         A=_317_DIMS[2])
    assert {k: plan[k] for k in mirror} == mirror
    assert 1 <= plan['blocks'] <= plan['resident']
    if R // S == 8:
        for e in (0, 5):
            one = rc.row_clone(kw, per_row, per_env, e, S)
            wide.rows(mode, one.pop('y'), _317_DIMS, S, **one)
            for k, x in rc.row_outputs(mode, one).items():
                y = got[k][e * S:(e + 1) * S]
                if x.dtype == torch.bfloat16:
                    x, y = x.view(torch.int16), y.view(torch.int16)
                assert torch.equal(x, y), (e, k)


@pytest.mark.parametrize('mode,dims', [('latent', (128, 1024, 3, 101, 2, 8, 3)),
                                       ('hidden', (64, 128, 3, 101, 2, 8, 3))])
def test_wide_rows_layernorm_sums_8_partial_rows(agent, mode, dims):
    """A LayerNorm row of one column tile whose product splits K into 8
    partial rows (128 columns, 128 apart; 3 envs of 77 rows): the ring
    stages the row with its partial rows in one copy, and the row kernel
    sums them in order as rows_plain does: bf16 within one step, f32 at
    1e-4; its plan the mirror's."""
    dev, S, N = torch.device('cuda'), 77, 3
    R, ncols = N * S, wide.row_width(mode, dims)
    g = torch.Generator(device=dev).manual_seed(ncols)
    y = torch.full((R, 8 * ncols + 16), float('nan'), device=dev)
    for p in range(8):
        y[:, p * ncols:(p + 1) * ncols] = torch.randn(R, ncols, device=dev, generator=g) / 2
    kw = dict(nsplit=8, pstride=ncols, gain=1 + 0.2 * torch.randn(ncols, device=dev, generator=g),
              beta=0.2 * torch.randn(ncols, device=dev, generator=g), dpad=ncols)
    outs = []
    for _ in range(2):
        o = dict(dst=torch.full((R, ncols + 16), float('nan'), device=dev, dtype=torch.bfloat16),
                 fdst=torch.full((R, ncols), float('nan'), device=dev))
        outs.append(o)
    plan = wide.rows(mode, y, dims, S, **kw, **outs[0])
    wide.rows_plain(mode, y, dims, S, **kw, **outs[1])
    rc.hold_rows(f'{mode}, 8 partial rows', outs[0], outs[1], ncols)
    mirror = wm.row_plan(mode, ncols, 8, ncols)
    assert {k: plan[k] for k in mirror} == mirror


@pytest.mark.parametrize('L', [64, 1376])
@pytest.mark.parametrize('group', [2, 4, 16])
def test_wide_rows_simnorm_groups(agent, group, L):
    """LayerNorm + SimNorm at SimNorm's groups other than 8 (the row
    kernel's runtime group: pairs and fours inside a lane's float4, sixteen
    across four lanes), on a 64-column latent and on the 317M model's
    1,376 columns, 2 envs of 512 rows, against rows_plain: bf16 within one
    bf16 step, f32 at 1e-4 (row_cases.hold_rows); its plan the mirror's."""
    dims = (L, 128 if L == 64 else 4096, 3, 101, 2, group, 3)
    g = torch.Generator(device='cuda').manual_seed(L + group)
    kw, per_row, _ = rc.row_operands('latent', 1024, 512, g, dims, fdst=True)
    got, want = rc.row_clone(kw, per_row, []), rc.row_clone(kw, per_row, [])
    plan = wide.rows('latent', got.pop('y'), dims, 512, **got)
    wide.rows_plain('latent', want.pop('y'), dims, 512, **want)
    rc.hold_rows(f'SimNorm of group {group}, {L} columns', rc.row_outputs('latent', got),
                 rc.row_outputs('latent', want), kw['dpad'])
    mirror = wm.row_plan('latent', L, 1, 0)
    assert {k: plan[k] for k in mirror} == mirror


@pytest.mark.parametrize('N,n_pi,mask', [
    pytest.param(1, 24, 'env', id='1-24'), pytest.param(8, 24, 'env', id='8-24'),
    pytest.param(8, 0, 'env', id='8-0'), pytest.param(80, 24, 'env', id='80-24'),
    pytest.param(8, 24, 'shared', id='8-24-shared')])
def test_wide_stage_matches_plain_at_317_widths(agent, N, n_pi, mask):
    """The wide engine's staging alone (ops/wide.py stage, the library's
    tdm_wide_stage) over the H stagings of a sampled value step at the 317M
    model's widths, N envs of 512 rows (512, 4,096 and 40,960 rows; a mask
    row per env, or one for every env; the noise a strided view as the
    planner passes it), with the latent broadcast (zs = 0), a latent per row
    (zs != 0) and folded (step 0's latent into zb, each env's once),
    against stage_plain exactly: the z||a rows bit for bit,
    nothing written past the padded widths (nor, folded, in the latent
    columns), the f32 actions sample_actions_plain's; G, q, term and
    term_at zeroed; H launches counted; at N=8 each env's rows bit for bit
    its one-env launch's."""
    dims, S, dev = _317_DIMS, 512, torch.device('cuda')
    L, A, H = dims[0], dims[2], dims[6]
    HA, Lp, width = H * A, wm.up16(L), wm.up16(L) + wm.up16(A)
    g = torch.Generator(device=dev).manual_seed(N + n_pi + (mask == 'shared'))
    z1 = torch.randn(N, 1, L, device=dev, generator=g)
    z_rows = torch.randn(N, S, L, device=dev, generator=g)
    mean = torch.rand(N, HA, device=dev, generator=g) * 1.6 - 0.8
    std = torch.rand(N, HA, device=dev, generator=g) * 1.9 + 0.1
    noise = torch.randn(N, 2, S, HA, device=dev, generator=g)[:, 0]
    pi_acts = torch.rand(N, n_pi, HA, device=dev, generator=g) * 2 - 1
    amask = (torch.rand(N if mask == 'env' else 1, A, device=dev, generator=g) < 0.8).float()
    if mask == 'shared':
        amask = amask[0]

    def bits(v):
        return v.view(torch.int16) if v.element_size() == 2 else v.view(torch.int32)

    for z_mode in ('broadcast', 'per row', 'folded'):
        z0 = z_rows if z_mode == 'per row' else z1.expand(N, S, L)

        def run(fn, e=None):
            sel = (lambda x: x) if e is None else (lambda x: x[e:e + 1])
            n = 1 if e is not None else N
            o = dict(x=torch.full((n * S, width + 16), float('nan'), device=dev,
                                  dtype=torch.bfloat16),
                     acts=torch.full((n, S, HA), float('nan'), device=dev),
                     G=torch.ones(n * S, device=dev), q=torch.ones(n * S, device=dev),
                     term=torch.ones(n * S, device=dev),
                     term_at=torch.ones(n * S, device=dev, dtype=torch.int32))
            fold = {}
            if z_mode == 'folded':
                fold = dict(zb=torch.full((n, Lp), float('nan'), device=dev,
                                          dtype=torch.bfloat16))
                o.update(fold)
            am = amask if amask.dim() == 1 else sel(amask)
            for t in range(H):
                fn(dims, S, t, sel(z0), sel(mean), sel(std), sel(noise), sel(pi_acts), am,
                   o['x'], o['acts'], load_z=t == 0, G=o['G'], q=o['q'], term=o['term'],
                   term_at=o['term_at'], **(fold if t == 0 else {}))
            return o

        n0 = wide.stage.launches
        got = run(wide.stage)
        assert wide.stage.launches == n0 + H
        want = run(wide.stage_plain)
        for k in got:
            assert torch.equal(bits(got[k]), bits(want[k])), (z_mode, k)
        assert torch.equal(got['acts'], sample_actions_plain(mean, std, noise, pi_acts, amask))
        assert all(bool((got[k] == 0).all()) for k in ('G', 'q', 'term', 'term_at'))
        if z_mode == 'folded':
            assert bool(got['x'][:, :Lp].isnan().all())
        if N == 8:
            for e in (0, 5):
                one = run(wide.stage, e)
                assert torch.equal(bits(one['x']), bits(got['x'][e * S:(e + 1) * S]))
                assert torch.equal(one['acts'], got['acts'][e:e + 1])
                if z_mode == 'folded':
                    assert torch.equal(bits(one['zb']), bits(got['zb'][e:e + 1]))


def _fold_operands(n, S, tasks, seed, dims=_317_DIMS):
    """A folded first layer's operands at dims (the 317M model's: L 1376, M
    4096, 6 actions) on n envs of S rows: the wide layout [M, up16(L) +
    up16(A)] (its pads zero; [4096, 1392] at 317), the envs' latents zb [n,
    up16(L)], the z||a rows (latent columns NaN, the A actions, zeros to
    up16(A)), a bias table of 80 tasks, the envs' task ids (distinct, or 5
    tasks repeated), gain and beta."""
    dev = torch.device('cuda')
    L, M, A = dims[0], dims[1], dims[2]
    Lp, Ap, T = wm.up16(L), wm.up16(A), 80
    g = torch.Generator(device=dev).manual_seed(seed)
    wT = (torch.randn(M, Lp + Ap, device=dev, generator=g) * L ** -0.5).to(torch.bfloat16)
    wT[:, L:Lp] = 0
    wT[:, Lp:] *= 3
    wT[:, Lp + A:] = 0
    zb = torch.randn(n, Lp, device=dev, generator=g).to(torch.bfloat16)
    zb[:, L:] = 0
    x = torch.full((n * S, Lp + Ap), float('nan'), device=dev, dtype=torch.bfloat16)
    x[:, Lp:] = 0
    x[:, Lp:Lp + A] = (torch.rand(n * S, A, device=dev, generator=g) * 2 - 1).to(torch.bfloat16)
    b0 = torch.randn(T, M, device=dev, generator=g) * 0.5
    e = torch.arange(n, device=dev)
    task = ((e * 7 + 3) % (T if tasks == 'distinct' else 5)).to(torch.int32)
    gain = 1 + 0.2 * torch.randn(M, device=dev, generator=g)
    beta = 0.2 * torch.randn(M, device=dev, generator=g)
    return wT, zb, x, b0, task, gain, beta


@pytest.mark.parametrize('n,tasks', [(1, 'distinct'), (8, 'distinct'), (80, 'distinct'),
                                     (8, 'repeated'), (80, 'repeated')])
def test_wide_fold_products_match_plain_at_317_widths(agent, n, tasks):
    """A value step's folded first layer: the u product alone (ops/wide.py
    fold_u, the library's tdm_wide_fold_u) on the n envs' latents (the
    layout's latent block, rows 1392 apart), its partial rows summed in
    order, against fold_plain's u within 1e-4 of |zb| . |Wz|; the launch's
    plan the mirror's (tests/wide_mirror.py fold_u_plan), the splits from
    the widths alone; at N = 8 env 5's partial rows its one-env launch's
    bit for bit. Then the fused layer on one row an env (80 distinct tasks,
    or 5 tasks repeated) against fold_hidden_plain within one bf16 step:
    each row's bias row its own env's task's."""
    dims, S = _317_DIMS, 512
    Lp, M = wm.up16(dims[0]), dims[1]
    wT, zb, x, b0, task, gain, beta = _fold_operands(n, S, tasks, 1392 + n)
    n0 = wide.fold_u.launches
    u, plan = wide.fold_u(zb, wT[:, :Lp], dims)
    assert wide.fold_u.launches == n0 + 1
    mirror = wm.fold_u_plan(dims, n)
    assert {k: plan[k] for k in ('ke', 'splits', 'kchunk', 'pstride', 'grid', 'blocks')} == \
        {k: mirror[k] for k in ('ke', 'splits', 'kchunk', 'pstride', 'grid', 'blocks')}
    got = u[0].clone()
    for p in range(1, plan['splits']):
        got += u[p]
    want_u, _ = wide.fold_plain(zb, x[:, Lp:], wT, b0, task, S)
    assert torch.equal(want_u, wide.fold_u_plain(zb, wT[:, :Lp]))
    mag = zb.float().abs() @ wT[:, :Lp].float().abs().T
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want_u).abs() <= 1e-4 * mag + 1e-6).all()), \
        float((got - want_u).abs().max())
    if n == 8:
        u1, _ = wide.fold_u(zb[5:6], wT[:, :Lp], dims)
        assert torch.equal(u1, u[:, 5:6])
    xa = x[::S, Lp:]
    dst = {k: torch.full((n, M + 16), float('nan'), device=x.device, dtype=torch.bfloat16)
           for k in ('got', 'want')}
    wide.fold_hidden(xa, wT[:, Lp:], u, b0, gain, beta, dims, 1, task=task, dst=dst['got'])
    wide.fold_hidden_plain(xa, wT[:, Lp:], u, b0, gain, beta, dims, 1, dst['want'], task=task)
    rc.hold_rows(f'fused folded layer, {n} envs of one row, {tasks} tasks',
                 {'dst': dst['got']}, {'dst': dst['want']}, M)


@pytest.mark.parametrize('n', [1, 8, 80])
def test_wide_fold_hidden_matches_plain_at_317_widths(agent, n):
    """The fused folded layer alone (ops/wide.py fold_hidden, the library's
    tdm_wide_fold_hidden) on n envs of 512 rows (512, 4,096 and 40,960
    rows): the rows' action columns (rows 1392 wide, the latent columns NaN)
    times the layout's action block, plus the u product's partial rows of
    the env summed in order, LayerNorm + Mish, against fold_hidden_plain on
    the same operands within the row phase's one-bf16-step band
    (row_cases.hold_rows), nothing written past the 4096 columns; one
    launch counted; its plan the mirror's (tests/wide_mirror.py
    fold_hidden_plan), on no more blocks than the card holds; at N = 8 env
    5's rows its one-env launch's bit for bit."""
    dims, S, dev = _317_DIMS, 512, torch.device('cuda')
    Lp, M = wm.up16(dims[0]), dims[1]
    _hold_fold_hidden(dims, n, S, 4096 + n)


def _hold_fold_hidden(dims, n, S, seed):
    """The fused layer at dims on n envs of S rows (distinct tasks) against
    fold_hidden_plain within one bf16 step, nothing written past up16(M);
    one launch counted; its plan the mirror's, on no more blocks than the
    card holds; at N = 8 env 5's rows its one-env launch's bit for bit."""
    dev = torch.device('cuda')
    Lp, M = wm.up16(dims[0]), dims[1]
    wT, zb, x, b0, task, gain, beta = _fold_operands(n, S, 'distinct', seed, dims)
    u, _ = wide.fold_u(zb, wT[:, :Lp], dims)

    def run(fn, sel=slice(None), us=u, tk=task):
        xa = x[sel, Lp:]
        dst = torch.full((xa.shape[0], M + 16), float('nan'), device=dev, dtype=torch.bfloat16)
        plan = fn(xa, wT[:, Lp:], us, b0, gain, beta, dims, S, task=tk, dst=dst)
        return dst, plan

    n0 = wide.fold_hidden.launches
    got, plan = run(wide.fold_hidden)
    assert wide.fold_hidden.launches == n0 + 1
    want, _ = run(lambda *a, task, dst: wide.fold_hidden_plain(*a, dst, task=task))
    rc.hold_rows(f'fused folded layer at {dims[:3]}, {n} envs', {'dst': got}, {'dst': want},
                 wm.up16(M))
    mirror = wm.fold_hidden_plan(dims)
    assert {k: plan[k] for k in mirror} == mirror
    assert 1 <= plan['blocks'] <= plan['resident']
    if n == 8:
        u1, _ = wide.fold_u(zb[5:6], wT[:, :Lp], dims)
        one, _ = run(wide.fold_hidden, slice(5 * S, 6 * S), u1, task[5:6])
        assert torch.equal(one.view(torch.int16), got[5 * S:6 * S].view(torch.int16))


@pytest.mark.parametrize('dims', [
    pytest.param((512, 512, 38, 101, 5, 8, 3), id='512-cols-38-actions'),
    pytest.param((768, 1024, 38, 101, 5, 8, 3), id='1024-cols-38-actions'),
    pytest.param((768, 1792, 38, 101, 5, 8, 3), id='1792-cols-38-actions'),
    pytest.param((1376, 3000, 6, 101, 8, 8, 3), id='3000-cols-6-actions'),
    pytest.param((1376, 4096, 21, 101, 8, 8, 3), id='4096-cols-21-actions')])
def test_wide_fold_hidden_matches_plain_at_each_row_width(agent, dims):
    """The fused layer's other builds: 32, 64 and 128 threads a row (38
    actions, a dog task's, at the widths of model_size 5, 19 and 48: the
    wide engine's because no row tile takes more than 32 actions), 256
    with the ragged edge's guards (3000 columns) and without them at 21
    actions (a humanoid task's at 317: three chunks of 8 actions staged); 8
    envs of 77 rows, as the 317 test above."""
    assert wide.fold_fits(dims)
    _hold_fold_hidden(dims, 8, 77, 38 + dims[1])


@pytest.mark.parametrize('size,A,folds', [(5, 38, True), (317, 21, True), (317, 38, False)])
def test_wide_value_step_with_many_actions_matches_plain(agent, size, A, folds):
    """The value step on the wide engine with a dog task's 38 actions at
    model_size 5 (folded: the fused layer on 32 threads a row) and at 317
    (its action block too large for shared memory: not folded, step 0 a
    product and a row kernel a layer), and a humanoid task's 21 at 317
    (folded), 2 envs with the latent broadcast: against the plain value
    step in the band, its launches, products and folded layers as
    ops/wide.py counts them at these widths."""
    ag = _sized_agent(size, A)
    cfg = ag.cfg
    H = cfg.horizon
    dims = (cfg.latent_dim, cfg.mlp_dim, A, cfg.num_bins, cfg.num_q, cfg.simnorm_dim, H)
    assert wide.fold_fits(dims) == folds
    assert kernel_plan(ag.prep, 8, H)['route'] == 'wide'
    args = _episodic_inputs(ag, 2, 38 + A)
    before = [c.launches for c in wide.COUNTERS]
    got = value_estimate(*args, **_heads(ag))
    n = [c.launches - b for c, b in zip(wide.COUNTERS, before)]
    torch.testing.assert_close(got, value_estimate_plain(*args, **_heads(ag)), **BAND)
    assert n[0] == wide.value_launches(H, False)
    assert n[1] == wide.value_products(H, False, dims)
    assert n[4] == n[5] == wide.value_folds(dims) == (2 if folds else 0)


# ------------------------------------------------------- the plan's graph
# ------------------------------------------------------- the plan's graph


@pytest.fixture(scope='module')
def graph_agent(agent):
    """A fresh agent of the module's widths with num_envs = 4: no graph
    captured yet."""
    cfg = agent.cfg.replace(num_envs=4)
    ag = TDMPC2(cfg)
    g = torch.Generator().manual_seed(3)
    ag.load_params(tree.map(lambda t: t + 0.05 * torch.randn(t.shape, generator=g),
                            ag.model.init(g)))
    return ag


def _hold_graph_against_eager(ag, n, eval_mode, t0, seed, obs=None):
    """One plan through the graph against the eager body on the same draws
    and warm starts: actions, means and every row of prev_mean bit for
    bit. The first plan of (n, eval_mode) captures; the checked one
    replays. `obs` (host) replaces the state vectors drawn from `seed`."""
    if obs is None:
        obs = torch.from_numpy(np.random.default_rng(seed).normal(
            size=(n, 10)).astype(np.float32))
    ag.plan_vec(obs, t0, eval_mode=eval_mode)         # captured by now
    pm = ag.prev_mean.clone()
    pm[0, :, 0] = -0.5            # a negative warm start, reset where t0
    ag.prev_mean = pm
    ag.generator.manual_seed(seed)
    counts = [w.launches for w in PLAN_WRAPPERS]
    replays = Graph.replays.get('plan', 0)
    a, m = (x.clone() for x in ag.plan_vec(obs, t0, eval_mode=eval_mode))
    assert Graph.replays['plan'] == replays + 1
    I = ag.iterations
    assert [w.launches - c for w, c in zip(PLAN_WRAPPERS, counts)] == [1, I, I]
    pm_graph = ag.prev_mean.clone()
    ag.prev_mean = pm
    ag.generator.manual_seed(seed)
    noise = ag.draw_noise(n)
    a_e, m_e = ag._plan_body(ag.prep, obs.to(ag.device),
                             torch.tensor(t0, device=ag.device), noise, eval_mode)
    assert torch.equal(a, a_e) and torch.equal(m, m_e)
    assert torch.equal(pm_graph, ag.prev_mean)
    # a reset row starts from +0.0: the sign bits agree too
    assert torch.equal(torch.signbit(pm_graph), torch.signbit(ag.prev_mean))


@pytest.mark.parametrize('eval_mode', [True, False])
@pytest.mark.parametrize('n', [1, 4])
def test_plan_graph_equals_eager_body(graph_agent, n, eval_mode):
    t0 = np.arange(n) % 2 == 0                        # mixed episode starts
    _hold_graph_against_eager(graph_agent, n, eval_mode, t0, 60 + n)


def test_draws_into_the_graph_inputs_are_the_draws(graph_agent):
    ag, n = graph_agent, 4
    ag.generator.manual_seed(7)
    ref = ag.draw_noise(n)
    ag.generator.manual_seed(7)
    out = ag._draw(n)
    ag.generator.manual_seed(7)
    ag._draw(n, out=out)
    got = ag._noise_from(out)
    for k, v in vars(ref).items():      # shift: None on a state model
        assert (getattr(got, k) is None if v is None
                else torch.equal(getattr(got, k), v)), k


def test_plan_graph_after_update_and_load_params(graph_agent):
    """After an update the prep graph refreshes the weights in place and
    the plan graph is replayed, not captured; after load_params every
    graph is captured anew. Both still equal the eager body."""
    ag = graph_agent
    cfg = ag.cfg
    cfg.batch_size, cfg.buffer_size, cfg.steps = 16, 300, 300
    buf = Buffer(cfg)
    for ep in _episodes(np.random.default_rng(2), 3):
        buf.add(ep)
    t0 = np.array([False, True, False, False])
    _hold_graph_against_eager(ag, 4, False, t0, 70)
    prep = ag.prep
    packed = prep['dP0'].clone()
    captures = dict(Graph.captures)
    ag.update(buf)
    _hold_graph_against_eager(ag, 4, False, t0, 71)
    assert ag.prep is prep and not torch.equal(prep['dP0'], packed)
    # the update captured its own graph; the plan's and the prep's stand
    assert {k: v for k, v in Graph.captures.items() if k != 'update'} == {
        k: v for k, v in captures.items() if k != 'update'}
    torch.testing.assert_close(
        prep['dP0'], prepare_value_params(ag.params, cfg)['dP0'], rtol=0, atol=0)
    g = torch.Generator().manual_seed(9)
    ag.load_params(tree.map(lambda t: t + 0.05 * torch.randn(t.shape, generator=g),
                            ag.model.init(g)))
    _hold_graph_against_eager(ag, 4, False, t0, 72)
    assert Graph.captures['plan'] == captures['plan'] + 1
    assert Graph.captures['prep'] == captures['prep'] + 1


# ----------------------------------------------------------------- task axis

MT_ADIMS = [3, 1, 2, 3, 2]       # the toy multi-task model's action dims (A = 3)


def _mt_agent(episodic):
    cfg = parse_cfg(Config(task='toy', device='cuda', enc_dim=48, mlp_dim=64,
                           latent_dim=64, num_q=3, num_samples=77,
                           num_elites=9, num_pi_trajs=5, iterations=3,
                           episodic=episodic))
    cfg.obs_shape, cfg.action_dim, cfg.episode_length = {'state': (10,)}, 3, 30
    cfg.multitask, cfg.task_dim = True, 8
    cfg.tasks = [f'toy-{i}' for i in range(len(MT_ADIMS))]
    cfg.action_dims, cfg.episode_lengths = list(MT_ADIMS), [30, 60, 100, 500, 30]
    ag = TDMPC2(cfg)
    g = torch.Generator().manual_seed(11)
    ag.load_params(tree.map(lambda t: t + 0.05 * torch.randn(t.shape, generator=g),
                            ag.model.init(g)))
    return ag


@pytest.fixture(scope='module')
def mt_agent(agent):
    return _mt_agent(False)


def _task_inputs(ag, task, n_pi, seed):
    """The planner steps' operands for one env per task id in `task`."""
    cfg, dev = ag.cfg, ag.device
    H, A, S = cfg.horizon, cfg.action_dim, cfg.num_samples
    n = len(task)
    tt = torch.tensor(task, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    z0 = ag.model.encode(ag.params, torch.randn(n, 10, device=dev, generator=g),
                         tt.long())[:, None]
    noise = torch.randn(n, 2, S, H * A, device=dev, generator=g)[:, 1]
    pi_eps = torch.randn(n, n_pi, H * A, device=dev, generator=g)
    qidx = torch.stack([torch.randperm(cfg.num_q, device=dev, generator=g)[:2]
                        for _ in range(n)]).to(torch.int32)
    amask = ag.amask[tt.long()].contiguous()
    return tt, z0, pi_eps, (
        ag.prep, z0.expand(n, S, -1),
        torch.rand(n, H * A, device=dev, generator=g) * 1.6 - 0.8,
        torch.rand(n, H * A, device=dev, generator=g) * 1.9 + 0.1, noise, None,
        amask, torch.randn(n, S, A, device=dev, generator=g), qidx,
        ag.discs[tt.long()])


def test_task_axis_kernels_match_plain_and_single_task_launches(mt_agent):
    """N = 6 envs on 5 tasks (one task twice), each with its bias rows, mask
    and discounts: the pi rollout against its plain version (band), the
    sampled value step exactly against sample_actions_plain and the
    given-actions launch (band against the plain step), the elite step
    (1e-4); masked action columns are 0; and the N-task launch of each
    equals N one-task launches bit for bit."""
    ag = mt_agent
    task = [3, 1, 0, 4, 2, 1]
    n, E = len(task), ag.cfg.num_elites
    tt, z0, pi_eps, args = _task_inputs(ag, task, 5, 90)
    heads = _heads(ag)
    pa = cem.pi_rollout(ag.prep, z0, pi_eps, **heads, task=tt, amask=args[6])
    torch.testing.assert_close(pa, cem.pi_rollout_plain(
        ag.prep, z0, pi_eps, **heads, task=tt, amask=args[6]), **BAND)
    args = args[:5] + (pa,) + args[6:]
    v, acts, _ = _hold_sampled(ag, args, False, task=tt)
    v_p, acts_p = value_sampled_plain(*args, **heads, task=tt)
    torch.testing.assert_close(acts, acts_p, rtol=0, atol=0)
    torch.testing.assert_close(v, v_p, **BAND)
    kw = dict(num_elites=E, temperature=0.5, min_std=0.05, max_std=2.0)
    got = cem.elite_moments(v, acts, args[6], **kw)
    for a, b in zip(got, cem.elite_moments_plain(v, acts, args[6], **kw)):
        torch.testing.assert_close(a, b, **ELITE)
    H = ag.cfg.horizon
    for i, t in enumerate(task):
        for x in (pa[i], acts[i], got[0][i], got[1][i]):
            assert torch.all(x.view(-1, H, 3)[..., MT_ADIMS[t]:] == 0)
    for i in range(n):
        sl = slice(i, i + 1)
        one_pa = cem.pi_rollout(ag.prep, z0[sl], pi_eps[sl], **heads, task=tt[sl],
                                amask=args[6][sl])
        one = value_sampled(*[a if a is args[0] else a[sl] for a in args], **heads,
                            task=tt[sl])
        one_e = cem.elite_moments(v[sl], acts[sl], args[6][sl], **kw)
        assert torch.equal(pa[sl], one_pa)
        assert torch.equal(v[sl], one[0]) and torch.equal(acts[sl], one[1])
        assert all(torch.equal(a[sl], b) for a, b in zip(got, one_e))


def test_single_task_is_task_zero_of_a_one_row_table(agent):
    """A single-task prep's bias tables have one row: task ids of 0 and a
    mask of ones given to the kernels change no bit."""
    ag = agent
    assert ag.prep['db0'].shape[0] == 1 and ag.prep['qb0'].dim() == 3
    args = _sampled_inputs(ag, 4, 5, 44)
    args = args[:6] + (torch.ones(4, ag.cfg.action_dim, device=ag.device),) + args[7:]
    zero = torch.zeros(4, dtype=torch.int32, device=ag.device)
    v, acts = value_sampled(*args, **_heads(ag))
    v0, acts0 = value_sampled(*args, **_heads(ag), task=zero)
    assert torch.equal(v, v0) and torch.equal(acts, acts0)


def test_act_tasks_graph_equals_eager_body(mt_agent):
    """act_tasks over the 5 tasks: one graph replay of 1 + 2 x iterations
    launches a lockstep step, equal bit for bit to the eager body on the
    same draws and warm starts."""
    ag = mt_agent
    n, H, A = 5, ag.cfg.horizon, ag.cfg.action_dim
    obs = np.random.default_rng(4).normal(size=(n, 10)).astype(np.float32)
    tasks = np.arange(n)
    a, pm = ag.act_tasks(obs, np.zeros((n, H, A), np.float32), True, tasks)
    counts = [w.launches for w in PLAN_WRAPPERS]
    replays = Graph.replays.get('plan', 0)
    pm0 = pm.clone()
    ag.generator.manual_seed(8)
    a, pm = ag.act_tasks(obs, pm, False, tasks)
    I = ag.iterations
    assert Graph.replays['plan'] == replays + 1
    assert [w.launches - c for w, c in zip(PLAN_WRAPPERS, counts)] == [1, I, I]
    pm_graph = pm.clone()
    pm.copy_(pm0)
    ag.generator.manual_seed(8)
    noise = ag.draw_noise(n)
    tt = torch.tensor(tasks, dtype=torch.int32, device=ag.device)
    a_e, _ = ag._plan_body(ag.prep, torch.from_numpy(obs).to(ag.device),
                           torch.zeros(n, dtype=torch.bool, device=ag.device), noise,
                           True, tt, pm)
    assert np.array_equal(a, a_e.cpu().numpy()) and torch.equal(pm_graph, pm)
    for i, t in enumerate(tasks):
        assert np.all(a[i, MT_ADIMS[t]:] == 0)


def test_episodic_task_axis_value_under_gate_rule(agent):
    """An episodic multi-task model: the termination head's first-layer bias
    folded per task; the value kernel at N = 5 tasks against its plain
    version under the gate rule."""
    ag = _mt_agent(True)
    task = [0, 1, 2, 3, 4]
    tt, _, _, args = _task_inputs(ag, task, 5, 91)
    n, S, H, A = 5, ag.cfg.num_samples, ag.cfg.horizon, ag.cfg.action_dim
    acts = (torch.rand(n, H, S, A, device=ag.device) * 2 - 1) * args[6][:, None, None]
    vargs = (ag.prep, args[1], acts, args[7], args[8], args[9])
    k_at = torch.empty(n, S, dtype=torch.int32, device=ag.device)
    p_at = torch.empty_like(k_at)
    got = value_estimate(*vargs, **_heads(ag), episodic=True, term_at=k_at, task=tt,
                         amask=args[6])
    ref = value_estimate_plain(*vargs, **_heads(ag), episodic=True, term_at=p_at,
                               task=tt, amask=args[6])
    logits, _ = termination_trace_plain(*vargs[:3], vargs[5], task=tt)
    flips, bad = gate_check(got, ref, k_at, p_at, logits, **BAND)
    assert bad == 0 and flips <= 0.01 * n * S


# ------------------------------------------ trained weights: the checkpoints

ROOT = Path(__file__).resolve().parent.parent
CHECKPOINTS = {'acrobot-swingup': ('results/checkpoints/acrobot-swingup-s1.pkl.gz', 6, 1),
               'hopper-hop': ('results/checkpoints/full/hopper-hop-s1-r5.pkl.gz', 15, 4)}


@pytest.fixture(scope='module')
def trained(agent):
    """The committed checkpoints' agents of the default 5M model, loaded on
    the card (jax, optax and ml_dtypes not needed), with the observations
    recorded from each trained agent (tests/data/observations.npz)."""
    out = {}
    with np.load(ROOT / 'tests/data/observations.npz') as d:
        recorded = {k: d[k] for k in d.files}
    for task, (fp, obs_dim, act_dim) in CHECKPOINTS.items():
        cfg = parse_cfg(Config(task=task, device='cuda'))
        cfg.obs_shape, cfg.action_dim, cfg.episode_length = {'state': (obs_dim,)}, act_dim, 1000
        ag = TDMPC2(cfg)
        ag.load(ROOT / fp)
        out[task] = (ag, {k.split('/')[1]: v for k, v in recorded.items()
                          if k.startswith(task + '/')})
    return out


@pytest.mark.parametrize('task', list(CHECKPOINTS))
def test_trained_weights_kernels_match_plain(trained, task):
    """One env on a recorded observation: the pi rollout and the sampled
    value step in the value band, the sampled step exact against the
    given-actions launch, the elite step at 1e-4; the plan's graph against
    its eager body."""
    ag, rec = trained[task]
    cfg, dev = ag.cfg, ag.device
    H, S, HA = cfg.horizon, cfg.num_samples, cfg.horizon * cfg.action_dim
    g = torch.Generator(device=dev).manual_seed(7)
    z = ag.model.encode(ag.params, torch.from_numpy(rec['obs'][100:101]).to(dev))[:, None]
    noise = ag.draw_noise(1)
    pi_args = (ag.prep, z, noise.pi_eps[:, :cfg.num_pi_trajs])
    pa = cem.pi_rollout(*pi_args, **_heads(ag))
    torch.testing.assert_close(pa, cem.pi_rollout_plain(*pi_args, **_heads(ag)), **BAND)
    args = (ag.prep, z.expand(1, S, -1),
            torch.rand(1, HA, device=dev, generator=g) * 0.4 - 0.2,
            torch.rand(1, HA, device=dev, generator=g) * 1.9 + 0.1, noise.sample[:, 0],
            pa, ag.amask, noise.eps[:, 0], noise.qidx[:, 0], ag.discs[None])
    v, acts, _ = _hold_sampled(ag, args, False)
    torch.testing.assert_close(v, value_sampled_plain(*args, **_heads(ag))[0], **BAND)
    assert float(v.std()) > 0
    kw = dict(num_elites=cfg.num_elites, temperature=cfg.temperature,
              min_std=cfg.min_std, max_std=cfg.max_std)
    for got, ref in zip(cem.elite_moments(v, acts, ag.amask, **kw),
                        cem.elite_moments_plain(v, acts, ag.amask, **kw)):
        torch.testing.assert_close(got, ref, **ELITE)
    t0 = np.array([False])
    obs = rec['obs'][101:102]
    ag.plan_vec(torch.from_numpy(obs), t0)          # captures
    ag.generator.manual_seed(8)
    pm = ag.prev_mean.clone()
    a, m = (x.clone() for x in ag.plan_vec(torch.from_numpy(obs), t0))
    ag.prev_mean = pm
    ag.generator.manual_seed(8)
    a_e, m_e = ag._plan_body(ag.prep, torch.from_numpy(obs).to(dev),
                             torch.tensor(t0, device=dev), ag.draw_noise(1), False)
    assert torch.equal(a, a_e) and torch.equal(m, m_e)


def test_full_train_state_update_on_card_matches_cpu(trained):
    """One update from the hopper-hop train state (Adam count 1,440,484,
    scale 15.45, both carried over) on a batch of recorded slices, the
    card's against the CPU's (f32, TF32 off), at 1e-4."""
    ag, rec = trained['hopper-hop']
    assert int(ag.state.opt_state['enc']['count']) == 1440484
    assert abs(float(ag.state.scale) - 15.452264) < 1e-5
    T, B = ag.cfg.horizon, 64
    ag.cfg.batch_size = B
    starts = np.random.default_rng(9).integers(0, len(rec['action']) - T, B)
    rows = starts[None] + np.arange(T + 1)[:, None]
    batch = [torch.from_numpy(np.ascontiguousarray(x)).to(ag.device) for x in (
        rec['obs'][rows], rec['action'][rows[:-1]], rec['reward'][rows[:-1]][..., None],
        np.zeros((T, B, 1), np.float32))]
    cpu = TDMPC2(ag.cfg, device='cpu')
    cpu.state = ag.state.to('cpu')
    noise = ag.draw_update_noise()
    cpu_noise = UpdateNoise(**{k: None if v is None else v.cpu()
                               for k, v in vars(noise).items()})
    info = ag._update(ag.state, *batch, noise)
    ref = cpu._update(cpu.state, *[x.cpu() for x in batch], cpu_noise)
    for k in ref:
        torch.testing.assert_close(info[k].cpu(), ref[k], rtol=1e-4, atol=1e-4)
    assert float(ref['pi_scale']) > 10.0
    got = ag.state.to('cpu')
    for name in ('params', 'target_Qs', 'opt_state', 'pi_opt_state'):
        for a, b in zip(tree.leaves(getattr(got, name)),
                        tree.leaves(getattr(cpu.state, name))):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ pixels


@pytest.fixture(scope='module')
def pixel_agent(agent):
    """A pixel agent of the module's MLP widths (64 x 64 x 9 frames, 4
    channels: latent 64) with num_envs = 4, and the walker frames recorded
    from the trained pixel agent (tests/data/pixel_observations.npz)."""
    cfg = agent.cfg.replace(obs='rgb', num_channels=4, num_envs=4)
    cfg.obs_shape = {'rgb': (9, 64, 64)}
    ag = TDMPC2(cfg)
    g = torch.Generator().manual_seed(5)
    ag.load_params(tree.map(lambda t: t + 0.05 * torch.randn(t.shape, generator=g),
                            ag.model.init(g)))
    with np.load(ROOT / 'tests/data/pixel_observations.npz') as d:
        frames = d['walker-walk/obs']
    return ag, frames


def test_pixel_encoder_and_shift_aug_match_cpu(pixel_agent):
    """ShiftAug bit for bit and the conv encoder at 1e-4, card against CPU,
    on the small model and on the trained walker conv weights."""
    from tdmpc2_tpu_torch.interop import load_blob, params_from_jax
    ag, frames = pixel_agent
    x = torch.from_numpy(frames).cuda()
    g = torch.Generator(device='cuda').manual_seed(2)
    sh = torch.randint(0, 7, (len(frames), 2), device='cuda', generator=g)
    aug = layers.shift_aug(x, sh)
    assert aug.dtype == torch.uint8
    assert torch.equal(aug.cpu(), layers.shift_aug(x.cpu(), sh.cpu()))
    walker = params_from_jax(load_blob(
        ROOT / 'results/checkpoints/walker-walk-rgb-s1.pkl.gz')['model']['encoder']['rgb'])
    for conv, width in ((ag.params['encoder']['rgb'], 64), (walker, 512)):
        for s_ in (None, sh):
            got = layers.conv_encoder_apply(tree.map(lambda t: t.cuda(), conv), x, 8, s_)
            ref = layers.conv_encoder_apply(tree.map(lambda t: t.cpu(), conv), x.cpu(), 8,
                                            None if s_ is None else s_.cpu())
            assert got.shape == (len(frames), width)
            torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('eval_mode', [True, False])
@pytest.mark.parametrize('n', [1, 4])
def test_pixel_plan_graph_equals_eager_body(pixel_agent, n, eval_mode):
    """The pixel plan's graph (uint8 frames in, the encoder and its shift
    draw in the graph) against its eager body, bit for bit."""
    ag, frames = pixel_agent
    obs = torch.from_numpy(frames[10:10 + n])
    _hold_graph_against_eager(ag, n, eval_mode, np.arange(n) % 2 == 0, 80 + n, obs)
    assert ag._graphs[(n, eval_mode, None, False, True)][1]['obs'].dtype == torch.uint8


# ------------------------------------------------------- the update's graph

UPDATE_KINDS = ['state', 'episodic', 'pixels', 'multitask']


def _update_agent(kind, bf16=False):
    """A fresh agent of the module's widths of `kind`, num_envs = 4, and a
    buffer of three random episodes on the card (pixels: 64 x 64 x 9 uint8
    frame stacks, 4 channels; multi-task: one task an episode; episodic: a
    fifth of the steps terminated); `bf16` sets bf16_update."""
    cfg = parse_cfg(Config(task='toy', device='cuda', enc_dim=48, mlp_dim=64,
                           latent_dim=64, num_q=3, num_samples=77, num_elites=9,
                           num_pi_trajs=5, iterations=3, batch_size=16, num_envs=4,
                           buffer_size=300, steps=300, episodic=kind == 'episodic',
                           bf16_update=bf16))
    cfg.obs_shape, cfg.action_dim, cfg.episode_length = {'state': (10,)}, 3, 30
    if kind == 'pixels':
        cfg.obs, cfg.num_channels, cfg.obs_shape = 'rgb', 4, {'rgb': (9, 64, 64)}
    if kind == 'multitask':
        cfg.multitask, cfg.task_dim = True, 8
        cfg.tasks = [f'toy-{i}' for i in range(len(MT_ADIMS))]
        cfg.action_dims, cfg.episode_lengths = list(MT_ADIMS), [30, 60, 100, 500, 30]
    ag = TDMPC2(cfg)
    g = torch.Generator().manual_seed(13)
    ag.load_params(tree.map(lambda t: t + 0.05 * torch.randn(t.shape, generator=g),
                            ag.model.init(g)))
    buf = Buffer(cfg)
    rng = np.random.default_rng(4)
    for i, ep in enumerate(_episodes(rng, 3)):
        if kind == 'pixels':
            ep['obs'] = rng.integers(0, 256, (31, 9, 64, 64), dtype=np.uint8)
        if kind == 'episodic':
            ep['terminated'][1:] = rng.uniform(size=30) < 0.2
        if kind == 'multitask':
            ep['task'] = i
        buf.add(ep)
    assert buf.on_device
    return ag, buf


def _state_copy(ag):
    return [x.clone() for x in tree.leaves([
        ag.state.params, ag.state.target_Qs, ag.state.opt_state,
        ag.state.pi_opt_state, ag.state.scale])]


@pytest.mark.parametrize('kind', UPDATE_KINDS)
def test_update_graph_equals_eager_body(agent, kind):
    """The first update of a train state runs the eager body and captures
    the graph; a replay then equals the eager `_update` from the same state
    on the same batch and draws, bit for bit: every info value, the
    parameters, target heads, both Adam states and the scale."""
    _hold_update_graph(*_update_agent(kind))


@pytest.mark.parametrize('kind', UPDATE_KINDS)
def test_bf16_update_graph_equals_eager_body(agent, kind):
    """The same with bf16_update=true: cuBLAS's bf16 products with f32
    sums (`_Bf16Product`), and on pixels cuDNN's bf16 convolutions with
    the deterministic weight gradient, in the graph as in the eager body."""
    ag, buf = _update_agent(kind, bf16=True)
    assert ag.model_upd.dtype == torch.bfloat16
    _hold_update_graph(ag, buf)


def _hold_update_graph(ag, buf):
    captures, replays = (dict(getattr(Graph, k)) for k in ('captures', 'replays'))
    ag.update(buf)
    assert Graph.captures['update'] == captures.get('update', 0) + 1
    batch = buf.sample()
    noise = ag.draw_update_noise()
    start = _state_copy(ag)
    info = {k: v.clone() for k, v in ag._step(batch, noise).items()}
    assert Graph.replays['update'] == replays.get('update', 0) + 1
    after = _state_copy(ag)
    for x, y in zip(tree.leaves([ag.state.params, ag.state.target_Qs, ag.state.opt_state,
                                 ag.state.pi_opt_state, ag.state.scale]), start):
        x.copy_(y)
    ref = ag._update(ag.state, *batch[:4], noise, *batch[4:])
    assert set(info) == set(ref)
    for k in ref:
        assert torch.equal(info[k], ref[k]), k
    for x, y in zip(after, _state_copy(ag)):
        assert torch.equal(x, y)
    assert Graph.captures['update'] == captures.get('update', 0) + 1


def test_update_many_graph_equals_eager_steps(agent):
    """update_many(4): one sample_many(4) draw and four replays, equal to
    four eager steps on that draw, bit for bit; a new parameter tree
    captures anew."""
    ag, buf = _update_agent('state')
    ag.update(buf)
    start = _state_copy(ag)
    gens = ag.generator.get_state(), buf.generator.get_state()
    replays = Graph.replays['update']
    info = {k: v.clone() for k, v in ag.update_many(buf, 4).items()}
    assert Graph.replays['update'] == replays + 4
    after = _state_copy(ag)
    for x, y in zip(tree.leaves([ag.state.params, ag.state.target_Qs, ag.state.opt_state,
                                 ag.state.pi_opt_state, ag.state.scale]), start):
        x.copy_(y)
    ag.generator.set_state(gens[0])
    buf.generator.set_state(gens[1])
    batch = buf.sample_many(4)
    for i in range(4):
        ref = ag._update(ag.state, *[x[i] for x in batch], ag.draw_update_noise())
    for k in ref:
        assert torch.equal(info[k], ref[k]), k
    for x, y in zip(after, _state_copy(ag)):
        assert torch.equal(x, y)
    captures = Graph.captures['update']
    ag.load_params(tree.map(torch.clone, ag.params))
    ag.update(buf)
    assert Graph.captures['update'] == captures + 1


@pytest.mark.parametrize('k', [4, 0], ids=['vec_step', 'no-updates'])
def test_fused_schedules_equal_act_then_update_many(agent, k):
    """vec_step against act + update_many from the same state and
    generators at N = 4, with k updates: actions, info, the train state and
    the warm starts bit for bit."""
    ag, buf = _update_agent('state')
    ag.update(buf)
    obs = np.random.default_rng(6).normal(size=(4, 10)).astype(np.float32)
    t0 = np.array([True, False, False, True])
    start = _state_copy(ag) + [ag.prev_mean.clone()]
    gens = ag.generator.get_state(), buf.generator.get_state()
    runs = []
    for fused in (False, True):
        for x, y in zip(tree.leaves([ag.state.params, ag.state.target_Qs,
                                     ag.state.opt_state, ag.state.pi_opt_state,
                                     ag.state.scale, ag.state.prev_mean]), start):
            x.copy_(y)
        ag._prep = None
        ag.generator.set_state(gens[0])
        buf.generator.set_state(gens[1])
        if fused:
            a, info = ag.vec_step(buf, obs, t0, k)
        else:
            a, info = ag.act(obs, t0=t0), (ag.update_many(buf, k) if k else None)
        runs.append((a, {name: v.clone() for name, v in (info or {}).items()},
                     _state_copy(ag) + [ag.prev_mean.clone()]))
    (a0, i0, s0), (a1, i1, s1) = runs
    np.testing.assert_array_equal(a0, a1)
    assert set(i0) == set(i1) and bool(i0) == bool(k)
    for name in i0:
        assert torch.equal(i0[name], i1[name]), name
    for x, y in zip(s0, s1):
        assert torch.equal(x, y)


# ---------------------------------------------------------- the bf16 update


@pytest.mark.parametrize('shapes', [((5, 7, 40), (40, 24)), ((3, 16, 40), (3, 40, 24))],
                         ids=['rows', 'members'])
def test_bf16_product_matches_plain_on_card(agent, shapes):
    """`_Bf16Product` (cuBLAS, bf16 operands, f32 sums) against the plain
    version on the card's tensors (the bf16 operands multiplied in f32,
    TF32 off): the output within f32 summation order; the cotangents, each
    a bf16 value, within one bf16 step of the plain ones on the output's
    cotangent rounded to bf16, as the card's backward takes it."""
    xs, ws = shapes
    g = torch.Generator(device='cuda').manual_seed(3)
    x = torch.randn(xs, device='cuda', generator=g)
    w = 0.1 * torch.randn(ws, device='cuda', generator=g)
    gy = torch.randn(xs[:-1] + ws[-1:], device='cuda', generator=g)
    outs = []
    for fn in (layers._Bf16Product.apply,
               lambda a, c: torch.matmul(a.to(torch.bfloat16).float(),
                                         c.to(torch.bfloat16).float())):
        a, c = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fn(a, c)
        (y * gy.to(torch.bfloat16).float()).sum().backward()
        outs.append((y.detach(), a.grad, c.grad))
    (y, gx, gw), (y_p, gx_p, gw_p) = outs
    torch.testing.assert_close(y, y_p, rtol=1e-5, atol=1e-5)
    for got, ref in ((gx, gx_p), (gw, gw_p)):
        assert torch.equal(got, got.to(torch.bfloat16).float())
        torch.testing.assert_close(got, ref, rtol=2 ** -8, atol=1e-5)


@pytest.mark.parametrize('kind', ['state', 'pixels'])
def test_bf16_update_close_to_f32_on_card(agent, kind):
    """JAX's contract (tests/test_bf16_update.py:52-71) on the card: one
    bf16 update against one f32 update from the same state, batch and
    draws: each loss within 5% of max(|f32|, 1), the f32 master weights
    within 2e-3."""
    ag, buf = _update_agent(kind)
    bf, _ = _update_agent(kind, bf16=True)
    bf.state = ag.state.to('cuda')
    batch, noise = buf.sample(), ag.draw_update_noise()
    info_f = ag._update(ag.state, *batch[:4], noise, *batch[4:])
    info_b = bf._update(bf.state, *batch[:4], noise, *batch[4:])
    for k in ('total_loss', 'consistency_loss', 'reward_loss', 'value_loss', 'pi_loss',
              'grad_norm'):
        a, b = float(info_f[k]), float(info_b[k])
        assert np.isfinite(b) and abs(a - b) <= 0.05 * max(abs(a), 1.0), (k, a, b)
    for pf, pb in zip(tree.leaves(ag.state.params), tree.leaves(bf.state.params)):
        assert pb.dtype == torch.float32
        torch.testing.assert_close(pb, pf, rtol=0, atol=2e-3)


def test_bf16_agent_plans_as_the_f32_agent_on_card(agent):
    """Acting with bf16_update=true: the f32 agent's plan bit for bit."""
    ag, _ = _update_agent('state')
    bf, _ = _update_agent('state', bf16=True)
    bf.state = ag.state.to('cuda')
    obs = torch.randn(4, 10, device='cuda')
    noise = ag.draw_noise(4)
    t0 = np.array([True, False, True, False])
    for a, b in zip(ag.plan_vec(obs, t0, noise=noise), bf.plan_vec(obs, t0, noise=noise)):
        assert torch.equal(a, b)


# -------------------------------------------------------------- the fleet


def test_fleet_seed_equals_the_single_agent_on_card(agent):
    """A fleet of two seeds at the module's widths, 2 envs a seed: seed k's
    initial state, its plans on the single agent's draws (its kernels'
    graph replays) and its updates on the same batch and draws (its update
    graph: a capture, then a replay) equal the single agent of seed k bit
    for bit."""
    from tdmpc2_tpu_torch.fleet import FleetAgent
    cfg = agent.cfg.replace(num_envs=2, batch_size=16)
    seeds = (3, 7)
    fleet = FleetAgent(cfg, seeds)
    singles = [TDMPC2(cfg.replace(seed=s)) for s in seeds]
    for k, s in enumerate(singles):
        for x, y in zip(_state_copy(fleet.agents[k]), _state_copy(s)):
            assert torch.equal(x, y)
        g = torch.Generator().manual_seed(seeds[k])
        p = tree.map(lambda t: t + 0.05 * torch.randn(t.shape, generator=g),
                     s.model.init(g))
        fleet.agents[k].load_params(p)
        s.load_params(p)
    obs = np.random.default_rng(5).normal(size=(2, 2, 10)).astype(np.float32)
    for t0 in (True, False):
        noise = [s.draw_noise(2) for s in singles]
        a = fleet.act(obs, t0=t0, noise=noise)
        for k, s in enumerate(singles):
            a_s, _ = s.plan_vec(torch.from_numpy(obs[k]), np.full(2, t0), noise=noise[k])
            np.testing.assert_array_equal(a[k], a_s.cpu().numpy())
            assert torch.equal(fleet.agents[k].prev_mean, s.prev_mean)
    gen = torch.Generator(device='cuda').manual_seed(9)
    T = cfg.horizon
    batch = (torch.randn(2, 1, T + 1, 16, 10, device='cuda', generator=gen),
             torch.rand(2, 1, T, 16, 3, device='cuda', generator=gen) * 2 - 1,
             torch.rand(2, 1, T, 16, 1, device='cuda', generator=gen),
             torch.zeros(2, 1, T, 16, 1, device='cuda'))
    for _ in range(2):
        noise = [[s.draw_update_noise()] for s in singles]
        fleet._update_batches(batch, 1, noise)
        for k, s in enumerate(singles):
            s._step(tuple(x[k, 0] for x in batch), noise[k][0])
            for x, y in zip(_state_copy(fleet.agents[k]), _state_copy(s)):
                assert torch.equal(x, y)


# ------------------------------------------------------ worker-process envs


def test_subproc_trainer_first_planned_step_equals_inproc_on_card(agent, tmp_path):
    """`VecOnlineTrainer` on toy-reach at the module's widths, 2 env copies
    in worker processes (vec_mode=subproc) and in this process (inproc),
    the same seed: the burst at step 100 (the first episodes' end), then
    the first planned vector step, one `vec_step` on the card; its actions,
    the replay buffer and the train state bit for bit, and the workers
    closed at the end."""
    from tdmpc2_tpu_torch.envs import make_env
    from tdmpc2_tpu_torch.envs.subproc import SubprocVecEnv
    from tdmpc2_tpu_torch.trainer.vec_online import VecOnlineTrainer
    from tdmpc2_tpu_torch.utils.logger import Logger
    c = agent.cfg
    runs = {}
    for mode in ('subproc', 'inproc'):
        cfg = parse_cfg(Config(
            task='toy-reach', device='cuda', num_envs=2, vec_mode=mode, seed=4,
            enc_dim=c.enc_dim, mlp_dim=c.mlp_dim, latent_dim=c.latent_dim, num_q=c.num_q,
            num_samples=c.num_samples, num_elites=c.num_elites,
            num_pi_trajs=c.num_pi_trajs, iterations=c.iterations, batch_size=16,
            steps=102, eval_freq=1000, eval_episodes=1, save_agent=False, save_csv=False))
        cfg.work_dir = str(tmp_path / mode)
        env = make_env(cfg)
        cfg.seed_steps = 100
        ag = TDMPC2(cfg)
        steps = []
        vec_step = ag.vec_step

        def recording(*args, _vec_step=vec_step, _steps=steps):
            actions, info = _vec_step(*args)
            _steps.append(np.array(actions))
            return actions, info
        ag.vec_step = recording
        tr = VecOnlineTrainer(cfg=cfg, env=env, agent=ag, buffer=Buffer(cfg),
                              logger=Logger(cfg))
        tr.train()
        assert len(steps) == 1 and isinstance(env, SubprocVecEnv) == (mode == 'subproc')
        runs[mode] = (tr, steps[0], _state_copy(ag))
    (sub, a, sa), (inp, b, sb) = runs['subproc'], runs['inproc']
    assert all(p.poll() is not None for p in sub.env.procs)
    np.testing.assert_array_equal(a, b)
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)
    assert sub.buffer.num_eps == inp.buffer.num_eps == 2
    for k in sub.buffer._storage:
        np.testing.assert_array_equal(sub.buffer._storage[k].cpu().numpy(),
                                      inp.buffer._storage[k].cpu().numpy())
