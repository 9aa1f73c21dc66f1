"""Widths above the row tiles: model_size 317 and the mt80 geometry (CPU).

The tensor-core kernels take one of two engines, chosen from the widths
alone (`ops.wide.engine`, the built library's `tdm_engine`): the row tiles
of csrc/mlp_rows.cuh up to 2048 columns, the layer-per-launch engine of
csrc/mlp_wide.cuh above (the 317M model: mlp_dim 4096, latent 1376, 8 Q
heads, task_dim 96). No kernel runs here; these tests hold what surrounds
the kernels:

- the engine each model size takes (a mirror of the C rule, whose answers
  tests/test_torch_cuda.py holds the built library to on the card), and
  the error for widths that neither engine takes;
- the packed weights and per-task bias tables at 317's dims read back
  through the wide engine's own index map (its product block's B loads,
  column tile by column tile, and its head and task offsets);
- the port's plain value step and pi rollout at mlp_dim 2560 (above 2048:
  the widths the wide engine serves) against the JAX package's, the Pallas
  value kernel run interpreted with f32 dots, on the same noise;
- the wide engine's launches a call and a plan;
- mt80 at model_size 317: the Meta-World dims of chip_smoke's literals
  against the JAX adapter's, and the offline buffer that the port's
  trainer loads from chunks of that geometry against the JAX trainer's, at
  tiny depth (no agent is built: the loader reads only the config).
"""

import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdmpc2_tpu.config import Config as JConfig, parse_cfg as jparse
from tdmpc2_tpu.data.buffer import draw_slice_indices as jdraw
from tdmpc2_tpu.envs import make_env as jmake_env
from tdmpc2_tpu.models import layers as jl
from tdmpc2_tpu.ops import math as jmath
from tdmpc2_tpu.ops.pallas_rollout import (prepare_value_params as jprepare,
                                           value_prepared)
from tdmpc2_tpu.tdmpc2 import TDMPC2 as JTDMPC2
from tdmpc2_tpu.trainer.offline import OfflineTrainer as JOfflineTrainer
from tdmpc2_tpu_torch.config import MODEL_SIZE, Config, parse_cfg
from tdmpc2_tpu_torch.interop import params_from_jax
from tdmpc2_tpu_torch.ops import _build, cem, wide
from tdmpc2_tpu_torch.ops import value as tv
from tdmpc2_tpu_torch.tdmpc2 import TDMPC2
from tdmpc2_tpu_torch.trainer.offline import OfflineTrainer

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

VTOL = dict(rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ engine

# A mirror of the engine rule: csrc/mlp_rows.cuh kShapes (rows a block,
# column pairs a warp), kWarps, kSmemMax, kMaxStages, kNarrowPairs and
# pick_plan; csrc/mlp_wide.cuh wide_fits (the row kernel's 256 threads x 16
# values) and wide_tile.
ROW_SHAPES = ((32, 2), (32, 4), (32, 8), (16, 16))
WARPS, SMEM_MAX, MAX_STAGES, NARROW_PAIRS = 8, 232448, 8, 4
GROUPS = (2, 4, 8, 16)
WIDE_MAX_COLS = 4096


def _up16(n):
    return -(-n // 16) * 16


def row_tile_plan(dims):
    """pick_plan at dims (L, M, A, B, NQ, G, H): the first row-tile shape
    whose accumulators and shared memory fit, as {rt, stages, smem_bytes},
    or None when none fits."""
    L, M, A, B, _, G, H = dims
    Lp, Ap, Mp, Bp = _up16(L), _up16(A), _up16(M), _up16(B)
    widest, hp = max(Mp, Lp, Bp), _up16(2 * A)
    if G not in GROUPS or L % G:
        return None
    for rt, np_ in ROW_SHAPES:
        if widest > 8 * 16 * np_ or hp > 16 * NARROW_PAIRS:
            continue
        ldz, ldh, nmat = Lp + Ap + 8, Mp + 8, 9 * H + 9
        ks = WARPS // (rt // 16)
        fixed = (2 * rt * (ldz + ldh) + 4 * 3 * WARPS * rt + 4 * ks * rt * hp
                 + 4 * 4 * rt + 16 * nmat + 16 * MAX_STAGES)
        fixed = (fixed + 127) & ~127
        tile = 32 * widest
        slot = 2 * tile if (SMEM_MAX - fixed) // (2 * tile) >= 4 else tile
        stages = min((SMEM_MAX - fixed) // slot, MAX_STAGES)
        if stages >= 2:
            return dict(rt=rt, stages=stages, smem_bytes=fixed + stages * slot)
    return None


def wide_fits(dims):
    L, M, A, B, _, G, _ = dims
    return (G in GROUPS and L % G == 0 and A >= 1
            and max(L, M, B, 2 * A) <= WIDE_MAX_COLS)


def wide_tile(dims):
    L, M, _, B = dims[:4]
    return 128 if max(_up16(L), _up16(M), _up16(B)) > 2048 else 64


def mirror_lib():
    """A stand-in for a built library whose tdm_engine is the mirror: 0 the
    row tiles, 1 the wide engine, NO_PLAN neither."""
    def tdm_engine(dims):
        dims = tuple(dims)
        if row_tile_plan(dims) is not None:
            return 0
        return 1 if wide_fits(dims) else _build.NO_PLAN
    return types.SimpleNamespace(tdm_engine=tdm_engine)


def _dims(size, A=6, B=101):
    d = MODEL_SIZE[size]
    return (d['latent_dim'], d['mlp_dim'], A, B, d.get('num_q', 5), 8, 3)


@pytest.mark.parametrize('size,route,rt', [(1, 'rows', 32), (5, 'rows', 32),
                                           (19, 'rows', 32), (48, 'rows', 16),
                                           (317, 'wide', None)])
def test_engine_choice_from_the_widths(size, route, rt):
    """Model sizes 1-48 fit a row tile (32 rows, 16 at 48: the plans the
    card reports); 317's 4096 columns fit none and take the wide engine. The
    action width and the horizon move no model size across."""
    for A, H in ((1, 3), (6, 3), (4, 5)):
        dims = _dims(size, A)[:6] + (H,)
        assert wide.engine(mirror_lib(), dims) == route
        plan = row_tile_plan(dims)
        assert (plan is None) == (rt is None)
        if plan is not None:
            assert plan['rt'] == rt and 2 <= plan['stages'] <= 8
            assert plan['smem_bytes'] <= SMEM_MAX
        # the wide engine's product block (the rollout's at every size)
        assert wide_tile(dims) == (128 if size == 317 else 64)
    if size == 317:
        assert wide_fits(_dims(size))


@pytest.mark.parametrize('dims', [(1376, 8192, 6, 101, 8, 8, 3),
                                  (1376, 4096, 6, 101, 8, 3, 3)])
def test_widths_no_engine_takes_raise_naming_them(dims):
    """Above the wide engine's 4096 columns, or SimNorm groups it does not
    take: `engine` (which the wrappers call before any launch) raises
    ValueError naming the widths."""
    assert row_tile_plan(dims) is None and not wide_fits(dims)
    with pytest.raises(ValueError, match=f'no engine takes the widths \\(L=1376, '
                                         f'M={dims[1]}, A=6, B=101, num_q=8'):
        wide.engine(mirror_lib(), dims)


def test_wide_launch_counts():
    """13 launches a step (the staging, reward and dynamics: a product and a
    row kernel a layer), 6 more with the termination gate, 18 for the
    policy and the two Q heads; the pi rollout stages once and skips the
    last step's dynamics; a plan of 6 iterations at H=3."""
    assert wide.value_launches(3, False) == 57
    assert wide.value_launches(3, True) == 75
    assert wide.pi_rollout_launches(3) == 31
    assert wide.rollout_launches(3) == 39
    assert wide.plan_launches(3, 6, False) == 31 + 6 * 57


# ---------------------------------------------- the layout the engine reads

def _wide_read(packed, kt, np_, k_tiles, q_head=0):
    """The [K, N] elements (int16 bits, -1 where unread) that gemm_kernel's
    B loads take from one packed matrix at k-tiles `k_tiles`: column tile
    bx, pair j < min(8, np - 8 bx), lane l, uint4 at ((kt * np + 8 bx + j) *
    32 + l) after the head's offset kt * np * 32 (in uint4s); element 4t +
    2r + h of lane 4g + q is W[16 kt + 8 r + 2 q + h, 16 p + 8 t + g]."""
    u4 = packed.reshape(-1).view(torch.int16).numpy().reshape(-1, 8)
    head0 = q_head * kt * np_ * 32
    W = -np.ones((16 * kt, 16 * np_), np.int32)
    for k in k_tiles:
        for bx in range(-(-np_ // 8)):
            for j in range(min(8, np_ - 8 * bx)):
                p = 8 * bx + j
                lanes = u4[head0 + (k * np_ + p) * 32 + np.arange(32)]
                for lane in range(32):
                    g, q = lane // 4, lane % 4
                    for e in range(8):
                        t, r, h = e // 4, (e // 2) % 2, e % 2
                        W[16 * k + 8 * r + 2 * q + h, 16 * p + 8 * t + g] = lanes[lane, e]
    return W


def _bits(x):
    return x.contiguous().view(torch.int16).numpy().astype(np.int32)


@pytest.mark.parametrize('case', ['z||a', 'hidden', 'latent out', 'bins', 'pi head',
                                  'Q heads'])
def test_wide_layout_read_back_at_317_dims(case):
    """Each packed matrix of the 317M model's value step, read back through
    the wide engine's index map at its first, a middle and its last k-tile,
    equals its [in, out] blocks, zeros in the padding (the z||a first
    layers: latent rows padded to 1376, action rows to 16; the bins and the
    pi head's 2A columns padded to 16 columns); the Q heads at each head's
    offset."""
    L, M, A, B, NQ = 1376, 4096, 6, 101, 8
    g = torch.Generator().manual_seed(317)

    def w(*shape):
        return torch.randn(*shape, generator=g).to(torch.bfloat16)
    if case == 'z||a':
        blocks, along_n, heads = [w(L, M), w(A, M)], False, None
    elif case == 'hidden':
        blocks, along_n, heads = [w(M, M)], False, None
    elif case == 'latent out':
        blocks, along_n, heads = [w(M, L)], False, None
    elif case == 'bins':
        blocks, along_n, heads = [w(M, B)], False, None
    elif case == 'pi head':
        blocks, along_n, heads = [w(M, A), w(M, A)], True, None
    else:
        blocks, along_n, heads = [w(NQ, L, 64), w(NQ, A, 64)], False, NQ
    packed = tv.pack_matrix(*blocks, cat_dim=-1 if along_n else -2)
    for h in range(heads or 1):
        bl = [b[h] for b in blocks] if heads else blocks
        if along_n:
            want = torch.cat(bl, dim=-1)
            want = torch.nn.functional.pad(want, (0, _up16(want.shape[1]) - want.shape[1]))
        else:
            want = torch.cat([torch.nn.functional.pad(
                b, (0, _up16(b.shape[1]) - b.shape[1], 0, _up16(b.shape[0]) - b.shape[0]))
                for b in bl], dim=0)
        want = _bits(want)
        kt, np_ = want.shape[0] // 16, want.shape[1] // 16
        k_tiles = sorted({0, kt // 2, kt - 1})
        got = _wide_read(packed[h] if heads else packed, kt, np_, k_tiles)
        for k in k_tiles:
            rows = slice(16 * k, 16 * k + 16)
            np.testing.assert_array_equal(got[rows], want[rows], err_msg=f'{case} {h} {k}')


def test_wide_bias_tables_at_80_tasks_and_task_dim_96():
    """The per-task first-layer bias tables the wide engine reads through
    the env's task id (row task * bt + head * bh): the dynamics' [80, 4096]
    and the Q heads' [80, 8, 4096], each row b + emb[task] @ W[L:L+96] (the
    folded embedding)."""
    L, M, dt, NQ, T = 1376, 4096, 96, 8, 80
    g = torch.Generator().manual_seed(96)
    emb = torch.randn(T, dt, generator=g)
    Wd, bd = torch.randn(L + dt + 6, M, generator=g), torch.randn(M, generator=g)
    Wq = torch.randn(NQ, L + dt + 6, 8, generator=g)
    bq = torch.randn(NQ, 8, generator=g)
    tab = tv._fold(Wd, bd, L, emb).contiguous()
    qtab = tv._fold(Wq, bq, L, emb).contiguous()
    assert tab.shape == (T, M) and qtab.shape == (T, NQ, 8)
    flat, qflat = tab.reshape(-1), qtab.reshape(-1)
    for task in (0, 29, 30, 79):
        torch.testing.assert_close(flat[task * M:(task + 1) * M],
                                   bd + emb[task] @ Wd[L:L + dt], **VTOL)
        for head in (0, 7):
            off = task * (NQ * 8) + head * 8       # bt = NQ * M, bh = M
            torch.testing.assert_close(qflat[off:off + 8],
                                       bq[head] + emb[task] @ Wq[head, L:L + dt], **VTOL)


# ------------------------------------- plain versions above 2048 vs the JAX package


def _wide_small(cfg):
    cfg.obs_shape = {'state': (10,)}
    cfg.action_dim = 3
    cfg.episode_length = 20
    cfg.enc_dim, cfg.mlp_dim, cfg.latent_dim = 32, 2560, 128
    cfg.num_samples, cfg.num_elites, cfg.num_pi_trajs = 16, 4, 4
    cfg.iterations, cfg.num_q = 1, 2
    return cfg


@pytest.fixture(scope='module')
def wide_agents():
    jagent = JTDMPC2(_wide_small(jparse(JConfig(task='toy'))))
    leaves, treedef = jax.tree.flatten(jagent.state.params)
    keys = jax.random.split(jax.random.PRNGKey(2560), len(leaves))
    scale = 0.05 * (512 / 2560) ** 0.5
    jp = jax.tree.unflatten(treedef, [x + scale * jax.random.normal(k, x.shape, x.dtype)
                                      for x, k in zip(leaves, keys)])
    tagent = TDMPC2(_wide_small(parse_cfg(Config(task='toy', device='cpu'))))
    tagent.load_params(params_from_jax(jax.tree.map(np.asarray, jp)))
    return jagent, jp, tagent


def _heads(agent):
    return dict(log_std_min=agent.model.log_std_min, log_std_dif=agent.model.log_std_dif)


def test_plain_value_step_above_2048_matches_jax(wide_agents):
    """N = 2 envs, S = 16, mlp_dim 2560: the port's value step (its plain
    version, what the wide engine is held to on the card) against JAX
    `value_prepared` per env, the same latents, actions, eps and Q heads."""
    jagent, jp, tagent = wide_agents
    cfg = jagent.cfg
    N, S, H, A, L = 2, 16, cfg.horizon, cfg.action_dim, cfg.latent_dim
    prep = tv.prepare_value_params(tagent.params, tagent.cfg, torch.float32)
    assert wide.engine(mirror_lib(), tv.prep_dims(prep, 8, H)) == 'wide'
    rng = np.random.default_rng(2560)
    z0 = np.stack([np.asarray(jl.simnorm(rng.normal(size=(S, L)).astype(np.float32), 8))
                   for _ in range(N)])
    actions = rng.uniform(-1, 1, (N, H, S, A)).astype(np.float32)
    eps = rng.normal(size=(N, S, A)).astype(np.float32)
    qidx = np.array([[0, 1], [1, 0]], np.int32)
    discs = np.stack([(0.95 ** np.arange(H + 1)).astype(np.float32)] * N)
    got = tv.value_estimate(prep, *(torch.from_numpy(x) for x in (z0, actions, eps, qidx,
                                                                   discs)),
                            **_heads(tagent))
    jprep = jprepare(jp, cfg, dot_dtype=jnp.float32)
    for e in range(N):
        ref = value_prepared(jprep, z0[e], actions[e], eps[e], qidx[e], discs[e],
                             horizon=H, episodic=False, dot_dtype=jnp.float32,
                             interpret=True, **_heads(jagent))
        np.testing.assert_allclose(got[e].numpy(), np.asarray(ref), **VTOL)


def test_plain_pi_rollout_above_2048_matches_jax(wide_agents):
    """N = 2 envs, 4 policy rows each, mlp_dim 2560: the port's pi rollout
    against the JAX model's pi/next steps on the same eps, at 1e-4."""
    jagent, jp, tagent = wide_agents
    cfg = jagent.cfg
    N, n_pi, H, A, L = 2, 4, cfg.horizon, cfg.action_dim, cfg.latent_dim
    rng = np.random.default_rng(2561)
    z = np.asarray(jagent.model.encode(jp, rng.normal(size=(N, 10)).astype(np.float32)))
    pi_eps = rng.normal(size=(N, n_pi, H * A)).astype(np.float32)
    prep = tv.prepare_value_params(tagent.params, tagent.cfg, torch.float32)
    zs = torch.empty(H - 1, N, n_pi, L)
    got = cem.pi_rollout(prep, torch.from_numpy(z)[:, None], torch.from_numpy(pi_eps),
                         **_heads(tagent), latents=zs)
    m = jagent.model
    for e in range(N):
        zc, steps = jnp.broadcast_to(jnp.asarray(z[e]), (n_pi, L)), []
        for t in range(H):
            mean, lstd = jnp.split(jl.mlp_apply(jp['pi'], zc), 2, -1)
            lstd = jmath.log_std(lstd, m.log_std_min, m.log_std_dif)
            a = jnp.tanh(mean + pi_eps[e, :, t * A:(t + 1) * A] * jnp.exp(lstd))
            steps.append(a)
            zc = m.next(jp, zc, a)
            if t + 1 < H:   # the latents the rollout advanced to
                np.testing.assert_allclose(zs[t, e].numpy(), np.asarray(zc), **VTOL)
        np.testing.assert_allclose(got[e].numpy(), np.asarray(jnp.concatenate(steps, -1)),
                                   **VTOL)


# --------------------------------------------------- mt80 at model_size 317


def test_mt80_literals_match_the_metaworld_adapter(monkeypatch):
    """chip_smoke's mt80 literals: mt30's 30 tasks, then 50 Meta-World tasks
    with the dims the JAX adapter gives a Meta-World v2 env (its contract
    test's env: obs 39, action 4, a 100-step time limit)."""
    from tests.test_env_adapters_mocked import _MockMWEnv
    envs_mod = types.ModuleType('metaworld.envs')
    envs_mod.ALL_V2_ENVIRONMENTS_GOAL_OBSERVABLE = {
        'assembly-v2-goal-observable': lambda seed=None: _MockMWEnv(seed=seed)}
    pkg = types.ModuleType('metaworld')
    pkg.envs = envs_mod
    monkeypatch.setitem(sys.modules, 'metaworld', pkg)
    monkeypatch.setitem(sys.modules, 'metaworld.envs', envs_mod)
    cfg = jparse(JConfig(task='mw-assembly'))
    jmake_env(cfg)
    assert (cfg.obs_shape['state'][0], cfg.action_dim, cfg.episode_length) == (
        chip_smoke.MW_OBS_DIM, chip_smoke.MW_ACTION_DIM, chip_smoke.MW_EPISODE_LENGTH)
    cs = chip_smoke
    assert len(cs.MT80_ACTION_DIMS) == len(cs.MT80_OBS_DIMS) == 80
    assert cs.MT80_ACTION_DIMS[:30] == cs.MT30_ACTION_DIMS
    assert cs.MT80_OBS_DIMS[:30] == cs.MT30_OBS_DIMS
    assert set(cs.MT80_ACTION_DIMS[30:]) == {4} and set(cs.MT80_OBS_DIMS[30:]) == {39}


def test_mt80_offline_buffer_geometry_matches_jax(tmp_path):
    """mt80 at model_size 317 (task_dim 96): two chunks of 40 episodes of
    the mt80 dataset's geometry (101 rows, obs 39, actions 6), loaded by the
    port's OfflineTrainer and by the JAX trainer: the same capacity, episode
    count, task ids and, for the same draws, the same slices."""
    chip_smoke.write_mt30_chunks(tmp_path, 2, 40, 0, task='mt80')
    cfgs = []
    for make, conf in ((jparse, JConfig), (parse_cfg, Config)):
        kw = {} if conf is JConfig else dict(device='cpu')
        cfg = make(conf(task='mt80', model_size=317, data_dir=str(tmp_path), **kw))
        cfg.obs_shape = {'state': (max(chip_smoke.MT80_OBS_DIMS),)}
        cfg.action_dim = max(chip_smoke.MT80_ACTION_DIMS)
        cfg.batch_size = 8
        cfgs.append(cfg)
    jcfg, tcfg = cfgs
    assert (tcfg.task_dim, tcfg.mlp_dim, tcfg.latent_dim, tcfg.num_q, len(tcfg.tasks)) == (
        jcfg.task_dim, jcfg.mlp_dim, jcfg.latent_dim, jcfg.num_q, len(jcfg.tasks)) == (
        96, 4096, 1376, 8, 80)
    jcfg.buffer_device = 'device'     # no 2 GiB trial allocation on the CPU
    jtr = JOfflineTrainer.__new__(JOfflineTrainer)
    jtr.cfg = jcfg
    ttr = OfflineTrainer.__new__(OfflineTrainer)
    ttr.cfg, ttr.agent = tcfg, types.SimpleNamespace(device=torch.device('cpu'))
    jtr._load_dataset()
    ttr._load_dataset()
    jbuf, tbuf = jtr.buffer, ttr.buffer
    assert tbuf.num_eps == jbuf.num_eps == 80
    assert tbuf.capacity == jbuf.capacity == 80 * chip_smoke.MT80_DATA_EPISODE
    np.testing.assert_array_equal(tbuf._task_store.numpy(), np.asarray(jbuf._task_store))
    assert set(tbuf._task_store.tolist()) == set(range(80))
    jbatch = jbuf.sample_many(2)
    key = jax.random.fold_in(jbuf._key, jbuf._draws)
    ep, start = jdraw(key, jbuf._ep_rows, 80, 2 * 8, jcfg.horizon, 80)
    got = tbuf.gather(torch.from_numpy(np.array(ep)), torch.from_numpy(np.array(start)), 2)
    for a, b in zip(got, jbatch):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
