"""Widths above the row tiles: model_size 317 and the mt80 geometry (CPU).

The tensor-core kernels take one of two engines, chosen from the widths
alone (`ops.wide.engine`, the built library's `tdm_engine`): the row tiles
of csrc/mlp_rows.cuh up to 2048 columns, the layer-per-launch engine of
csrc/mlp_wide.cuh above (the 317M model: mlp_dim 4096, latent 1376, 8 Q
heads, task_dim 96). No kernel runs here; these tests hold what surrounds
the kernels:

- the engine each model size takes (tests/wide_mirror.py, a mirror of the
  C rule, whose answers tests/test_torch_cuda.py holds the built library
  to on the card), and the error for widths that neither engine takes;
- the packed weights and per-task bias tables at 317's dims read back
  through the wide engine's own index map (its product block's B loads,
  column tile by column tile, and its head and task offsets);
- the port's plain value step and pi rollout at mlp_dim 2560 (above 2048:
  the widths the wide engine serves) against the JAX package's, the Pallas
  value kernel run interpreted with f32 dots, on the same noise;
- the wide engine's launches a call and a plan, folded and not, and the
  fold's two launches' plans (tests/wide_mirror.py `fold_plans`: the u
  product's blocks covering each element of u once a split, its splits
  from the widths alone), and which widths fold (ops/wide.py `fold_fits`,
  against the fused layer's shared bytes; an episodic step never folds);
- the row kernel's plain version (ops/wide.py `rows_plain`, what the
  kernel is held to on the card) in each mode against the JAX package's
  row functions (`_ln`, `_mish`, `layers.simnorm`, `math.two_hot_inv`,
  `math.log_std`) with a split product's partial rows summed in order, and
  composed into the port's plain value step's reward, dynamics and policy
  heads at the 317M model's widths; the row kernel's layout
  (tests/wide_mirror.py `row_plan`, `row_owners`): each column of a row
  owned once, its owner following from the width alone;
- the staging's plain version (ops/wide.py `stage_plain`) against the TPU
  kernel's sampling in JAX, folded too (each env's latent into zb), a
  value step's folded first layer (ops/wide.py `fold_plain`: the latent's
  share plus the task's bias row, then the actions' share plus it) against
  the port's plain first layer and JAX's z Wz + a Wa + b0 at 317's widths,
  the fused layer's plain version (`fold_hidden_plain`: u's partial rows
  summed, the env's task bias row, the actions' share, LayerNorm + Mish) against JAX's _mish(_ln(z Wz + a Wa + b0)) at 317's
  widths and at 38 and 21 actions, and each library entry's ctypes argument types
  (ops/_build.py `SIGNATURES`) against its declaration in csrc/;
- mt80 at model_size 317: the Meta-World dims of chip_smoke's literals
  against the JAX adapter's, and the offline buffer that the port's
  trainer loads from chunks of that geometry against the JAX trainer's, at
  tiny depth (no agent is built: the loader reads only the config).
"""

import ctypes
import re
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
from tdmpc2_tpu.ops.pallas_rollout import (_ln, _mish, prepare_value_params as jprepare,
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
import wide_mirror as wm  # noqa: E402  (tests/, on pytest's path)
from wide_mirror import mirror_lib, row_tile_plan, wide_fits  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401

VTOL = dict(rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ engine

# The engine rule and the product's tile plan: tests/wide_mirror.py (the
# mirror of csrc/mlp_rows.cuh pick_plan, mlp_wide.cuh wide_fits,
# wide_large and Wide::launch_gemm); tests/test_torch_cuda.py holds the
# built library's answers to it on the card.
_up16 = wm.up16


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
            assert plan['smem_bytes'] <= wm.SMEM_MAX
        # the wide engine's product tile (the rollout's at every size): 128
        # x 256 above 2048 columns where an env has more than 64 rows
        assert wm.gemm_tile(dims, 512) == (wm.LARGE if size == 317 else wm.SMALL)
        assert wm.gemm_tile(dims, 24) == wm.SMALL
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


_D317, _D5 = (1376, 4096, 6, 101, 8, 8, 3), (512, 512, 6, 101, 5, 8, 3)


def test_wide_launch_counts():
    """13 launches a step (the staging, reward and dynamics: a product and a
    row kernel a layer), 6 more with the termination gate, 18 for the
    policy and the two Q heads; folded (the latent broadcast over an env's
    rows, as the planner passes it), step 0's two z||a first layers are a u
    product and a fused layer each (action product + LayerNorm + Mish) in
    place of a product and a row kernel: as many launches, 2 fewer products
    and row kernels (an episodic step does not fold); the pi rollout stages
    once and skips the last step's dynamics; a plan of 6 iterations at H=3
    (folded value steps)."""
    assert wide.value_launches(3, False) == 57
    assert wide.value_launches(3, True) == 75
    assert wide.pi_rollout_launches(3) == 31
    assert wide.rollout_launches(3) == 39
    assert wide.plan_launches(3, 6, False) == 31 + 6 * 57 == 373
    # the products among them: a product per layer but the folded two; an
    # episodic step does not fold (its gate's flags follow a logit's sign)
    assert (wide.value_products(3, False), wide.value_products(3, True)) == (27 - 2, 36)
    assert wide.value_folds(episodic=True) == wide.value_folds(_D317, True) == 0
    assert (wide.pi_rollout_products(3), wide.rollout_products(3)) == (15, 18)
    assert wide.plan_products(3, 6, False) == 15 + 6 * 25 == 165
    # the fold's u products and fused layers: 2 a value step
    assert wide.value_folds() == 2 and wide.plan_folds(6) == 12
    # a staging a step and the pi rollout's one; a row kernel after every
    # product
    assert wide.plan_stagings(3, 6) == 19
    rows = (wide.plan_launches(3, 6, False) - wide.plan_products(3, 6, False)
            - wide.plan_stagings(3, 6) - 2 * wide.plan_folds(6))
    assert rows == wide.plan_products(3, 6, False) == 165
    # the fold's two launches as the mirror plans them: u on the 80 envs'
    # latents packed into one block row (two env tiles of 64), K split in 4
    # (6 stages of 64 a split) over 32 column tiles of 128: 128 blocks; the
    # fused layer on 256 threads a row, the 6 action rows staged
    u, fused = wm.fold_plans(_D317, 80)
    assert (u['ke'], u['grid'], u['nk'], u['kchunk'], u['blocks']) == (
        2, (32, 1, 4), 22, 6, 128)
    assert fused == dict(threads_a_row=256, row_groups=1, action_chunks=1,
                         smem_bytes=6 * 4096 * 2 + 128 * 16 + 4096 * 4)
    # widths whose fused layer's action block does not fit shared memory (38
    # actions at 4096 columns) do not fold: step 0 a product and a row
    # kernel a layer, as many launches
    dog317 = _D317[:2] + (38,) + _D317[3:]
    assert wide.value_folds(_D317) == 2 and wide.value_folds(dog317) == 0
    assert (wide.value_products(3, False, dog317), wide.value_products(3, True, dog317)) == (
        27, 36)
    assert wide.value_products(3, False, _D317) == wide.value_products(3, False) == 25


@pytest.mark.parametrize('dims,folds', [
    (_D5[:2] + (38,) + _D5[3:], True), ((768, 1024, 38, 101, 5, 8, 3), True),
    ((768, 1792, 38, 101, 5, 8, 3), True), (_D317, True),
    (_D317[:2] + (21,) + _D317[3:], True), (_D317[:2] + (25,) + _D317[3:], True),
    (_D317[:2] + (26,) + _D317[3:], False), (_D317[:2] + (38,) + _D317[3:], False),
    ((1376, 3000, 6, 101, 8, 8, 3), True)])
def test_fold_fits_follows_the_fused_layers_shared_memory(dims, folds):
    """ops/wide.py fold_fits (csrc/mlp_wide.cuh fold_fits: whether a value
    step folds) against the fused layer's shared bytes as the mirror plans
    them (tests/wide_mirror.py fold_hidden_plan) and the 227 KB a block may
    opt into, 256 bytes of them its statistics slots: 38 actions fold at
    the widths of model_size 5, 19 and 48, at most 25 at 4096 columns."""
    plan = wm.fold_hidden_plan(dims)
    assert wide.fold_fits(dims) == folds == (plan['smem_bytes'] + 256 <= 232448)
    assert plan['action_chunks'] == -(-dims[2] // 8)


# ---------------------------------------------- the layout the engine reads

def _box(wT, k0, n0, head, rows):
    """The B box that gemm_kernel's producer copies from a wide-layout
    matrix (3-D tensor map {K, N, heads}) at coordinates (k0, n0, head):
    [rows, 64] bf16 bits, zeros past N and past K, as TMA fills them."""
    w = wT if wT.dim() == 3 else wT[None]
    K, N = w.shape[2], w.shape[1]
    box = torch.zeros(rows, wm.STAGE_K, dtype=torch.int16)
    blk = w[head, n0:min(n0 + rows, N), k0:min(k0 + wm.STAGE_K, K)]
    box[:blk.shape[0], :blk.shape[1]] = blk.contiguous().view(torch.int16)
    return box


def _bits(x):
    return x.contiguous().view(torch.int16).numpy().astype(np.int32)


def _padded_blocks(blocks, along_n):
    """[K, N] of a matrix's blocks as the activation rows see it: each K
    block zero-padded to 16 (the latent rows, then the action rows), or,
    stacked along N, K padded to 16."""
    if along_n:
        W = torch.cat(blocks, dim=-1)
        return torch.nn.functional.pad(W, (0, 0, 0, _up16(W.shape[0]) - W.shape[0]))
    return torch.cat([torch.nn.functional.pad(b, (0, 0, 0, _up16(b.shape[0]) - b.shape[0]))
                      for b in blocks], dim=0)


def _317_blocks(case, g):
    L, M, A, B, NQ = 1376, 4096, 6, 101, 8

    def w(*shape):
        return torch.randn(*shape, generator=g).to(torch.bfloat16)
    return {'z||a': ([w(L, M), w(A, M)], False, None),
            'hidden': ([w(M, M)], False, None),
            'latent out': ([w(M, L)], False, None),
            'bins': ([w(M, B)], False, None),
            'pi head': ([w(M, A), w(M, A)], True, None),
            'termination': ([w(M, 1)], False, None),
            'Q heads': ([w(NQ, L, 64), w(NQ, A, 64)], False, NQ)}[case]


@pytest.mark.parametrize('case', ['z||a', 'hidden', 'latent out', 'bins', 'pi head',
                                  'termination', 'Q heads'])
def test_wide_layout_read_back_at_317_dims(case):
    """Each matrix of the 317M model's value step in the wide layout
    (`wide_matrix`), read back through the product's index map (the TMA
    boxes of 64 K x the tile's columns, zeros past N and K) at its first, a
    middle and its last K stage and every column tile, equals its [in, out]
    blocks with zeros in the K padding (the z||a first layers: latent rows
    padded to 1376, action rows to 16) and past the ragged N (the bins'
    101, the pi head's 2A = 12, the termination's 1 column); the Q heads at
    each head's coordinate."""
    g = torch.Generator().manual_seed(317)
    blocks, along_n, heads = _317_blocks(case, g)
    wT = tv.wide_matrix(*blocks, cat_dim=-1 if along_n else -2)
    bn = wm.LARGE['bn']
    for h in range(heads or 1):
        want = _padded_blocks([b[h] for b in blocks] if heads else blocks, along_n)
        K, N = want.shape
        assert wT.shape[-2:] == (N, K) and wT.dtype == torch.bfloat16 and wT.is_contiguous()
        want = np.pad(_bits(want), ((0, wm.STAGE_K), (0, bn)))
        nk = -(-K // wm.STAGE_K)
        for ks in sorted({0, nk // 2, nk - 1}):
            k0 = ks * wm.STAGE_K
            for n0 in range(0, N, bn):
                got = _box(wT, k0, n0, h, bn).numpy().astype(np.int32).T   # [64 K, bn N]
                np.testing.assert_array_equal(
                    got, want[k0:k0 + wm.STAGE_K, n0:n0 + bn], err_msg=f'{case} {h} {ks}')


@pytest.mark.parametrize('case', ['z||a', 'bins', 'pi head', 'termination'])
def test_product_through_wide_layout(case):
    """Integer-valued weights, inputs and bias, so that every product and
    sum is exact in f32: the product taken through the wide layout as the
    kernel takes it (x's rows with their K blocks padded, the boxes of each
    K stage in order, every stage's partial sum added to f32 accumulators,
    the bias last) equals x.float() @ W.float() + b with no tolerance, at
    ragged widths (L 40, A 3, M 200: four stages, the last one partly past
    K)."""
    rng = np.random.default_rng(0)
    R, L, A, M, B = 24, 40, 3, 200, 101

    def ints(*shape):
        return torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float32))
    blocks, x_parts = {
        'z||a': ([ints(L, M), ints(A, M)], [ints(R, L), ints(R, A)]),
        'bins': ([ints(M, B)], [ints(R, M)]),
        'pi head': ([ints(M, A), ints(M, A)], [ints(R, M)]),
        'termination': ([ints(M, 1)], [ints(R, M)])}[case]
    along_n = case == 'pi head'
    W = torch.cat(blocks, dim=-1 if along_n else 0)
    b = ints(W.shape[1])
    wT = tv.wide_matrix(*[x.to(torch.bfloat16) for x in blocks],
                        cat_dim=-1 if along_n else -2)
    X = torch.cat([torch.nn.functional.pad(x, (0, _up16(x.shape[1]) - x.shape[1]))
                   for x in x_parts], dim=1).to(torch.bfloat16)
    N, K = wT.shape
    bn = wm.SMALL['bn']
    acc = torch.zeros(R, -(-N // bn) * bn)
    for k0 in range(0, K, wm.STAGE_K):
        xs = torch.zeros(R, wm.STAGE_K)
        xs[:, :min(wm.STAGE_K, K - k0)] = X[:, k0:k0 + wm.STAGE_K].float()
        for n0 in range(0, N, bn):
            box = _box(wT, k0, n0, 0, bn).view(torch.bfloat16).float()
            acc[:, n0:n0 + bn] += xs @ box.T
    got = acc[:, :N] + b
    want = torch.cat(x_parts, dim=1) @ W + b
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize('dims,n_envs,S,K,N,per_env', [
    (_D317, 1, 512, 1392, 4096, True), (_D317, 8, 512, 4096, 4096, False),
    (_D317, 3, 512, 4096, 101, True), (_D317, 2, 512, 4096, 12, False),
    (_D317, 2, 512, 4096, 1, False), (_D317, 5, 24, 1376, 4096, True),
    (_D317, 5, 24, 4096, 4096, False), (_D317, 5, 24, 4096, 12, False),
    (_D317, 2, 77, 4096, 1376, True), (_D5, 1, 512, 528, 512, False),
    (_D5, 1, 77, 512, 101, False), (_D5, 3, 77, 528, 512, True),
    (_D317, 80, 1, 1376, 4096, True), (_D317, 1, 1, 1376, 4096, False),
    (_D317, 80, 512, 16, 4096, True), (_D317, 1, 512, 16, 4096, False),
    (_D317, 1, 1, 1376, 4096, 'fold u'), (_D317, 8, 1, 1376, 4096, 'fold u'),
    (_D317, 80, 1, 1376, 4096, 'fold u'), (_D317, 128, 1, 1376, 4096, 'fold u')])
def test_gemm_plan_covers_each_output_once(dims, n_envs, S, K, N, per_env):
    """The product's tile plan (ops/wide.py gemm_plan, the mirror of
    Wide::launch_gemm): every output row and column in exactly one tile of
    each K split, the splits' K ranges tiling K in order, a per-env layer's
    tiles inside one env, the tile from S and the widths, and the partial
    rows of a split inside a row of y. 'fold u': the u product's plan
    (tests/wide_mirror.py fold_u_plan, the mirror of Wide::fold_u) at 1, 8,
    80 and 128 envs, held by _hold_fold_u_plan."""
    if per_env == 'fold u':
        _hold_fold_u_plan(dims, n_envs, K, N)
        return
    plan = wm.gemm_plan(dims, n_envs, S, K, N, per_env)
    assert {k: plan[k] for k in ('bm', 'bn', 'wgs')} == wm.gemm_tile(dims, S)
    assert plan['bm'] == (128 if dims == _D317 and S > 64 else 64)
    R = n_envs * S
    cover = np.zeros((plan['splits'], R, N), np.int32)
    k_ranges = set()
    for (r0, r1), (c0, c1), (k0, k1), off in wm.gemm_blocks(plan, n_envs, S, K, N):
        split = off // plan['pstride']
        cover[split, r0:r1, c0:c1] += 1
        k_ranges.add((split, k0, k1))
        if per_env:
            assert r0 // S == (r1 - 1) // S, 'a tile straddles two envs'
        assert off + min(N, c1) <= wide.y_width(dims)
    assert (cover == 1).all()
    ks = sorted(k_ranges)
    assert [k[0] for k in ks] == list(range(plan['splits']))
    assert ks[0][1] == 0 and ks[-1][2] == K
    assert all(a[2] == b[1] for a, b in zip(ks, ks[1:]))
    # narrow outputs split K (4096 deep: 8 blocks of 8 stages) where y has room
    narrow = N <= plan['bn']
    assert plan['splits'] == (min(8, K // 512, wide.y_width(dims) // _up16(N))
                              if narrow and K >= 512 else 1)


def _hold_fold_u_plan(dims, n_envs, K, N):
    """The u product's plan on n_envs latents: every element of u in
    exactly one block of each K split, the splits' K ranges tiling K in
    order, the split the one-env plan's (from the widths alone, never from
    N), each block's envs one or two env tiles of 64, and the partial rows
    inside the scratch's FOLD_SPLITS. (Each env's task bias row is the
    fused layer's, held by test_fold_hidden_plain_matches_jax.)"""
    plan = wm.fold_u_plan(dims, n_envs)
    one = wm.fold_u_plan(dims, 1)
    assert {k: plan[k] for k in ('nk', 'splits', 'kchunk')} == \
        {k: one[k] for k in ('nk', 'splits', 'kchunk')}
    assert plan['nk'] == -(-K // wm.STAGE_K)
    assert plan['ke'] == (2 if n_envs > wm.FOLD_ENVS else 1)
    cover = np.zeros((plan['splits'], n_envs, N), np.int32)
    k_ranges = set()
    blocks = 0
    for (c0, c1), (e0, e1), (k0, k1), z in wm.fold_u_blocks(plan, dims, n_envs):
        blocks += 1
        cover[z, e0:e1, c0:c1] += 1
        k_ranges.add((z, k0, k1))
        assert 0 < e1 - e0 <= plan['ke'] * wm.FOLD_ENVS and c1 - c0 <= wm.FOLD_COLS
    assert blocks == plan['blocks']
    assert (cover == 1).all()
    ks = sorted(k_ranges)
    assert [k[0] for k in ks] == list(range(plan['splits']))
    assert ks[0][1] == 0 and ks[-1][2] == K
    assert all(a[2] == b[1] for a, b in zip(ks, ks[1:]))
    assert plan['pstride'] == n_envs * _up16(N)
    assert plan['splits'] <= wide.FOLD_SPLITS
    # at 317: 32 column tiles of 128 x 4 splits, about one block an SM
    assert (plan['grid'][0], plan['splits'], plan['kchunk']) == (32, 4, 6)


def _engine_of(params, cfg):
    """The engine the mirror gives a model's widths: the built library's
    answer, which a bf16 prep on the card asks for itself."""
    dims = tv.prep_dims(tv.prepare_value_params(params, cfg, torch.float32),
                        getattr(cfg, 'simnorm_dim', 8), getattr(cfg, 'horizon', 3))
    return wide.engine(mirror_lib(), dims)


def test_prep_holds_each_engine_layout():
    """The weight prep holds the layouts its engines read: at 317's widths
    no row tile fits and the value step and pi rollout take the wide engine
    (every matrix in the wide layout, no packed copy); at the 5M model the
    row tiles take them (packed copies) and the rollout, on the wide engine
    at every width, reads the dynamics and reward in the wide layout."""
    assert wide.engine(mirror_lib(), _D317) == 'wide'
    assert wide.engine(mirror_lib(), _D5) == 'rows'
    from tests.test_torch_pack import _params
    params, cfg = _params(5)
    prep = tv.prepare_value_params(params, cfg, torch.bfloat16, _engine_of(params, cfg))
    assert set(tv.PACKED) <= set(prep)
    assert {k for k in tv.WIDE if k in prep} == {k for k in tv.WIDE if k[0] in 'dr'}
    for k, parts in tv.WIDE.items():
        if k in prep:
            cat = -1 if k == 'pT2' else -2
            assert torch.equal(prep[k], tv.wide_matrix(*[prep[p] for p in parts],
                                                       cat_dim=cat))
    tv.check_prep(prep, torch.device('cpu'), 8, tv.ROLLOUT_KERNEL_NAMES)
    with pytest.raises(ValueError, match='prepared weight pT0: missing'):
        tv.check_prep(prep, torch.device('cpu'), 8, tv.kernel_names('wide'))
    rollout_prep = tv.prepare_rollout_params(params['dynamics'], params['reward'],
                                             cfg.latent_dim, cfg.vmin, cfg.vmax)
    assert not set(tv.PACKED) & set(rollout_prep)
    tv.check_prep(rollout_prep, torch.device('cpu'), 8, tv.ROLLOUT_KERNEL_NAMES)


def test_cpu_prep_without_an_engine_holds_both_layouts():
    """A bf16 prep on the CPU that is not told the engine (no library is
    built there, and no kernel runs) holds every matrix in both layouts,
    each equal to its own layout of the same blocks."""
    from tests.test_torch_pack import _params
    params, cfg = _params(5)
    prep = tv.prepare_value_params(params, cfg, torch.bfloat16)
    assert set(tv.PACKED) <= set(prep) and set(tv.WIDE) <= set(prep)
    for table, make in ((tv.PACKED, tv.pack_matrix), (tv.WIDE, tv.wide_matrix)):
        for k, parts in table.items():
            cat = -1 if k[0] == 'p' and k[2] == '2' else -2
            assert torch.equal(prep[k], make(*[prep[p] for p in parts], cat_dim=cat)), k
    for route in ('rows', 'wide'):
        tv.check_prep(prep, torch.device('cpu'), 8, tv.kernel_names(route))


def test_prep_above_2048_holds_the_wide_layout_only(wide_agents):
    """mlp_dim 2560 (above 2048: the widths the wide engine serves): the
    agent's bf16 prep holds every matrix in the wide layout and no packed
    copy, so the prep does not double."""
    _, _, tagent = wide_agents
    engine = _engine_of(tagent.params, tagent.cfg)
    assert engine == 'wide'
    prep = tv.prepare_value_params(tagent.params, tagent.cfg, torch.bfloat16, engine)
    assert not set(tv.PACKED) & set(prep)
    assert set(tv.WIDE) - {k for k in tv.WIDE if k[0] == 't'} <= set(prep)
    tv.check_prep(prep, torch.device('cpu'), 8, tv.kernel_names('wide'))
    matrices = sum(prep[k].numel() for k in tv.PREP_NAMES if k in prep and k[1] == 'W')
    wide_copies = sum(prep[k].numel() for k in tv.WIDE if k in prep)
    assert wide_copies < 1.01 * matrices


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


# ------------------------------------------------------------ the row kernel

# small widths (L, M, A, B, num_q, simnorm_dim, H), and the 317M model's
# latent of 1376 columns
_ROW_SMALL = (24, 40, 3, 11, 4, 8, 3)
_ROW_1376 = (1376, 64, 6, 101, 8, 8, 3)


def _row_inputs(mode, dims, seed, nsplit):
    """numpy-seeded operands of one row launch on N = 2 envs of S = 3 rows:
    y with `nsplit` partial rows (up16 columns apart) and NaN where the row
    kernel reads nothing, and the mode's inputs and outputs."""
    L, M, A, B, NQ, G, H = dims
    N, S = 2, 3
    R, ncols = N * S, wide.row_width(mode, dims)
    ps = _up16(ncols)
    rng = np.random.default_rng(seed)
    y = np.full((R, nsplit * ps + 16), np.nan, np.float32)
    for p in range(nsplit):
        y[:, p * ps:p * ps + ncols] = rng.normal(size=(R, ncols)) * 1.5 / nsplit
    kw = dict(nsplit=nsplit, pstride=ps if nsplit > 1 else 0)
    if mode in ('hidden', 'latent'):
        kw.update(gain=1 + 0.2 * rng.normal(size=(NQ, ncols)), beta=0.2 * rng.normal(
            size=(NQ, ncols)), head=np.array([3, 1], np.int32), dpad=_up16(ncols))
    elif mode == 'pi':
        kw.update(eps=rng.normal(size=(N, S, A)), amask=np.array([[1] * A, [1] * (A - 1) + [0]]),
                  dpad=_up16(A), log_std_min=-10.0, log_std_dif=12.0)
    elif mode == 'term':
        kw.update(term=(rng.random(R) < 0.3) * 1.0, t=1)
    else:
        kw.update(G=rng.normal(size=R), q=rng.normal(size=R), term=(rng.random(R) < 0.3) * 1.0,
                  discs=rng.random((N, H + 1)), t=1 if mode == 'reward' else H)
    cast = {k: (v.astype(np.int32) if k in ('head', 'term_at') else v.astype(np.float32))
            if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    return y, cast, N, S


@pytest.mark.parametrize('mode,dims', [(m, _ROW_SMALL) for m in wide.ROW_MODES]
                         + [('latent', _ROW_1376)])
def test_rows_plain_matches_jax_row_functions(mode, dims):
    """ops/wide.py rows_plain, the function the row kernel is held to on the
    card, on numpy-seeded rows (the narrow outputs' as 3 partial rows of a
    split product, the small LayerNorm rows as 2, each env its own head of
    the gain and beta), against the JAX package's own row functions on the
    partial rows summed in order, at 1e-4: LayerNorm then Mish (`_ln`,
    `_mish`, pallas_rollout.py:36-48) or SimNorm (`layers.simnorm`), the
    two-hot decode (`math.two_hot_inv`) into G, q or the value, the policy's
    action (`math.log_std`) and the termination gate. bf16 rows are the f32
    rows rounded, zeros to dpad; `rows` takes the same function on the
    CPU."""
    L, M, A, B, NQ, G, H = dims
    narrow = mode not in ('hidden', 'latent')
    y, kw, N, S = _row_inputs(mode, dims, wide.ROW_MODES.index(mode) + dims[0],
                              3 if narrow else (2 if dims is _ROW_SMALL else 1))
    R, ncols = N * S, wide.row_width(mode, dims)
    ps = kw['pstride']
    ys = y[:, :ncols].copy()
    for p in range(1, kw['nsplit']):
        ys += y[:, p * ps:p * ps + ncols]
    env = np.arange(R) // S
    vmin, vmax = -10.0, 10.0
    bins = np.array(jnp.linspace(vmin, vmax, B, dtype=jnp.float32))
    t = {k: torch.from_numpy(v.copy()) if isinstance(v, np.ndarray) else v
         for k, v in kw.items()}
    if mode in ('hidden', 'latent', 'pi'):
        width = _up16(ncols) if mode != 'pi' else _up16(A)
        t['dst'] = torch.full((R, width + 16), float('nan'), dtype=torch.bfloat16)
        t['fdst'] = torch.full((R, ncols if mode != 'pi' else A), float('nan'))
    elif mode == 'term':
        t['term_at'] = torch.zeros(R, dtype=torch.int32)
    else:
        t['bins'], t['out'] = torch.from_numpy(bins), torch.full((R,), float('nan'))
    state = {k: v.clone() for k, v in t.items() if k in ('G', 'q', 'term')}
    assert wide.rows(mode, torch.from_numpy(y), dims, S, **t) is None   # rows_plain on the CPU
    if mode in ('hidden', 'latent'):
        g, b = kw['gain'][kw['head'][env]], kw['beta'][kw['head'][env]]
        u = _ln(jnp.asarray(ys), g, b)
        ref = _mish(u) if mode == 'hidden' else jl.simnorm(u, G)
        got = t['fdst']
    elif mode == 'pi':
        m = kw['amask'][env]
        ls = jmath.log_std(jnp.asarray(ys[:, A:]), kw['log_std_min'], kw['log_std_dif'])
        ref = jnp.tanh(ys[:, :A] * m + (kw['eps'][env, np.arange(R) % S] * m) * jnp.exp(ls))
        got = t['fdst']
    elif mode == 'term':
        hit, term0 = (ys[:, 0] > 0) * 1.0, state['term'].numpy()
        np.testing.assert_array_equal(t['term'].numpy(), np.minimum(term0 + hit, 1.0))
        np.testing.assert_array_equal(t['term_at'].numpy(),
                                      np.where((term0 == 0) & (hit > 0), 2, 0))
        return
    else:
        r = np.asarray(jmath.two_hot_inv(jnp.asarray(ys), B, vmin, vmax))[:, 0]
        d, keep = kw['discs'][env, kw['t']], 1.0 - state['term'].numpy()
        G0, q0 = state['G'].numpy(), state['q'].numpy()
        ref, got = {'reward': (G0 + d * keep * r, t['G']), 'q0': (r, t['q']),
                    'q1': (G0 + d * keep * (q0 + r) / 2, t['out'])}[mode]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **VTOL)
    if 'dst' in t:
        n = got.shape[1]
        assert torch.equal(t['dst'][:, :n].float(), got.to(torch.bfloat16).float())
        assert (t['dst'][:, n:kw['dpad']] == 0).all()
        assert t['dst'][:, kw['dpad']:].isnan().all()


def test_rows_plain_composes_the_plain_value_step_at_317_widths():
    """At the 317M model's widths (latent 1376, mlp 4096, 101 bins, A = 6;
    one first layer and one hidden matrix shared by the heads, to keep the
    test small), the wide engine's layers as its row kernel sees them (the
    product's f32 rows, the narrow outputs' split over K into 8 partial rows
    as gemm_splits gives them) through rows_plain, against the port's plain
    value step's heads (ops/value.py: dynamics_plain, the reward's two-hot
    decode, pi_head_plain and pi_action_plain; the plain step at these
    widths is held to JAX by test_plain_value_step_above_2048_matches_jax),
    at 1e-4."""
    L, M, A, B = 1376, 4096, 6, 101
    dims, N, S = (L, M, A, B, 8, 8, 3), 2, 3
    R = N * S
    rng = np.random.default_rng(317)

    def t(*shape, scale=1.0, base=0.0):
        return torch.from_numpy((base + scale * rng.standard_normal(shape)).astype(np.float32))
    W0, W1 = t(L + A, M, scale=(L + A) ** -0.5), t(M, M, scale=M ** -0.5)
    p = {'bins': torch.linspace(-10, 10, B)}
    for h in 'drp':
        p.update({h + 'W1': W1, h + 'b0': t(1, M, scale=0.1), h + 'b1': t(M, scale=0.1)})
        for k in ('g0', 'g1'):
            p[h + k] = t(M, scale=0.1, base=1.0)
        for k in ('e0', 'e1'):
            p[h + k] = t(M, scale=0.1)
    p.update(dWz=W0[:L], dWa=W0[L:], rWz=W0[:L], rWa=W0[L:], pW0=W0[:L],
             dW2=t(M, L, scale=M ** -0.5), db2=t(L, scale=0.1), dg2=t(L, scale=0.1, base=1.0),
             de2=t(L, scale=0.1), rW2=t(M, B, scale=M ** -0.5), rb2=t(B, scale=0.1),
             pWm=t(M, A, scale=M ** -0.5), pbm=t(A, scale=0.1), pWl=t(M, A, scale=M ** -0.5),
             pbl=t(A, scale=0.1))
    z = torch.from_numpy(np.asarray(jl.simnorm(
        rng.normal(size=(R, L)).astype(np.float32), 8))).reshape(N, S, L)
    a = t(N, S, A, scale=0.6).clamp(-1, 1)
    eps = t(N, S, A)

    def hidden(x0, h):
        """The head's two NormedLinear + Mish layers, each a product's f32
        rows through rows_plain ('hidden'), f32 out."""
        u = x0
        for i in '01':
            f = torch.empty(R, M)
            wide.rows_plain('hidden', u, dims, S, gain=p[f'{h}g{i}'], beta=p[f'{h}e{i}'],
                            dst=torch.empty(R, M, dtype=torch.bfloat16), dpad=M, fdst=f)
            u = f @ p[f'{h}W1'] + p[f'{h}b1'] if i == '0' else f
        return u

    def split8(u, W, b):
        """u @ W + b as 8 partial rows over K (the bias in the first),
        up16 columns apart, as the engine's split product writes them."""
        n, ps, kc = W.shape[1], _up16(W.shape[1]), M // 8
        y = torch.zeros(R, wide.y_width(dims))
        for q in range(8):
            y[:, q * ps:q * ps + n] = u[:, q * kc:(q + 1) * kc] @ W[q * kc:(q + 1) * kc] + (
                b if q == 0 else 0.0)
        return y, ps

    zr, ar = z.reshape(R, L), a.reshape(R, A)
    za = torch.cat([zr, ar], 1)
    # the dynamics: LayerNorm + SimNorm of the last product (one column tile)
    zf = torch.empty(R, L)
    wide.rows_plain('latent', hidden(za @ W0 + p['db0'][0], 'd') @ p['dW2'] + p['db2'], dims,
                    S, gain=p['dg2'], beta=p['de2'],
                    dst=torch.empty(R, _up16(L), dtype=torch.bfloat16), dpad=_up16(L), fdst=zf)
    torch.testing.assert_close(zf.reshape(N, S, L), tv.dynamics_plain(p, z, a, 8), **VTOL)
    # the reward: the two-hot decode of 8 partial rows into G
    y, ps = split8(hidden(za @ W0 + p['rb0'][0], 'r'), p['rW2'], p['rb2'])
    G = torch.zeros(R)
    wide.rows_plain('reward', y, dims, S, nsplit=8, pstride=ps, bins=p['bins'], G=G,
                    discs=torch.ones(N, 4), t=0)
    u = tv._hidden2(tv._dot(z, p['rWz']) + tv._dot(a, p['rWa']), p, 'r', p['rb0'][0])
    r = tv._two_hot_dec(tv._dot(u, p['rW2']) + p['rb2'], p['bins'])
    torch.testing.assert_close(G.reshape(N, S, 1), r, **VTOL)
    # the policy: mean and raw log-std as 8 partial rows of 2A columns
    amask = torch.tensor([[1.0] * A, [1.0] * 4 + [0.0] * 2])
    y, ps = split8(hidden(zr @ p['pW0'] + p['pb0'][0], 'p'), torch.cat([p['pWm'], p['pWl']], 1),
                   torch.cat([p['pbm'], p['pbl']]))
    act = torch.empty(R, A)
    wide.rows_plain('pi', y, dims, S, nsplit=8, pstride=ps, eps=eps, amask=amask,
                    dst=torch.empty(R, 16, dtype=torch.bfloat16), dpad=16, fdst=act,
                    log_std_min=-10.0, log_std_dif=12.0)
    mean, ls = tv.pi_head_plain(p, z, -10.0, 12.0)
    torch.testing.assert_close(act.reshape(N, S, A),
                               tv.pi_action_plain(mean, ls, eps, tv.mask_rows(amask, A)),
                               **VTOL)


_LAYOUT_WIDTHS = (12, 64, 101, 384, 512, 1024, 1376, 1792, 4096)


@pytest.mark.parametrize('mode,ncols', [(m, n) for m in ('hidden', 'latent', 'reward')
                                        for n in _LAYOUT_WIDTHS]
                         + [('pi', 2 * a) for a in (1, 6, 38)] + [('term', 1)])
def test_row_layout_owns_each_column_once(mode, ncols):
    """The row kernel's layout (tests/wide_mirror.py, the mirror of
    Wide::rows, whose plans tests/test_torch_cuda.py holds the built
    library to): every column of a row, dst's zero columns to dpad included,
    has exactly one owner, and the owners and the plan follow from the width
    alone (the same for any row count, env count or block); a LayerNorm
    thread holds at most 4 float4 chunks and its ring fits shared memory."""
    A, width = (ncols // 2 if mode == 'pi' else 6), ncols
    dpad = _up16(A) if mode == 'pi' else (_up16(width) if mode in ('hidden', 'latent') else 0)
    plan = wm.row_plan(mode, width, A=A)
    owners = wm.row_owners(mode, width, dpad, A=A)
    need = range(max(dpad, width) if mode != 'pi' else dpad)
    assert sorted(owners) == list(need)
    assert all(len(v) == 1 for v in owners.values())
    assert all(t < plan['threads_a_row'] for v in owners.values() for t, _ in v)
    assert owners == wm.row_owners(mode, width, dpad, A=A)
    if mode in ('hidden', 'latent'):
        assert all(i < wm.ROW_CHUNKS for v in owners.values() for _, i in v)
        assert 2 <= plan['stages'] <= wm.ROW_STAGES and plan['smem_bytes'] <= wm.SMEM_MAX
        if width <= wm.LARGE['bn']:
            # K split over 8 blocks (an output of one column tile): the same
            # owners, a ring of the 8 partial rows that still fits
            split = wm.row_plan(mode, width, 8, _up16(width))
            assert split['threads_a_row'] == plan['threads_a_row']
            assert 1 <= split['stages'] and split['smem_bytes'] <= wm.SMEM_MAX


@pytest.mark.parametrize('n_pi,mask_per_env,fold', [
    pytest.param(0, False, False, id='0-False'), pytest.param(3, False, False, id='3-False'),
    pytest.param(3, True, False, id='3-True'), pytest.param(3, True, True, id='3-True-folded'),
    pytest.param(0, False, True, id='0-False-folded')])
def test_stage_plain_matches_jax_sampling(n_pi, mask_per_env, fold):
    """ops/wide.py stage_plain, the function the wide engine's staging
    (stage_kernel) is held to on the card, over the H stagings of a value
    step on numpy-seeded inputs (2 envs of 7 rows, 3 of them policy-prior
    rows where given; the action mask one row for every env or one per env)
    against the TPU kernel's sampling (pallas_cem.py:136-147: clip(mean +
    std * noise), the policy-prior rows, the mask) in JAX within 1e-6 (XLA
    may fuse the multiply-add): the f32 actions, their bf16 copies in the
    action columns, zeros to the padded widths, G, q, term and term_at
    zeroed; at t = 0 the latent's bf16 copy in every row's latent columns,
    or, folded, each env's in its row of zb (zeros to the padded width) and
    the latent columns untouched; `stage` takes the
    same function on the CPU."""
    dims = (20, 32, 3, 11, 2, 4, 3)
    L, A, H = dims[0], dims[2], dims[6]
    N, S, HA, Lp, Ap = 2, 7, H * A, _up16(L), _up16(A)
    rng = np.random.default_rng(31 + n_pi + mask_per_env + 2 * fold)
    x = dict(z=rng.normal(size=(N, 1, L)), mean=rng.uniform(-0.8, 0.8, (N, HA)),
             std=rng.uniform(0.1, 2.0, (N, HA)), noise=rng.normal(size=(N, S, HA)),
             pi_acts=rng.uniform(-1, 1, (N, n_pi, HA)),
             amask=(rng.random((N, A) if mask_per_env else (A,)) < 0.7))
    x = {k: v.astype(np.float32) for k, v in x.items()}
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    xs = torch.full((N * S, Lp + Ap + 16), float('nan'), dtype=torch.bfloat16)
    acts = torch.full((N, S, HA), float('nan'))
    G, q, term = (torch.ones(N * S) for _ in range(3))
    term_at = torch.ones(N * S, dtype=torch.int32)
    fold_kw = dict(zb=torch.full((N, Lp), float('nan'), dtype=torch.bfloat16)) if fold else {}
    for step in range(H):
        wide.stage(dims, S, step, t['z'].expand(N, S, L), t['mean'], t['std'], t['noise'],
                   t['pi_acts'], t['amask'], xs, acts, load_z=step == 0, G=G, q=q,
                   term=term, term_at=term_at, **(fold_kw if step == 0 else {}))
    m = np.broadcast_to(x['amask'], (N, A))
    ref = jnp.clip(x['mean'][:, None] + x['std'][:, None] * x['noise'], -1.0, 1.0)
    ref = jnp.concatenate([x['pi_acts'], ref[:, n_pi:]], axis=1)
    ref = np.asarray(ref * jnp.tile(m, (1, H))[:, None])
    np.testing.assert_allclose(acts.numpy(), ref, rtol=0, atol=1e-6)
    assert torch.equal(acts, tv.sample_actions_plain(t['mean'], t['std'], t['noise'],
                                                     t['pi_acts'], t['amask']))
    assert torch.equal(xs[:, Lp:Lp + A].view(torch.int16),
                       acts[..., (H - 1) * A:].reshape(N * S, A).to(torch.bfloat16)
                       .view(torch.int16))
    zbits = t['z'][:, 0].to(torch.bfloat16).view(torch.int16)
    if fold:
        assert xs[:, :Lp].isnan().all()
        assert torch.equal(fold_kw['zb'][:, :L].view(torch.int16), zbits)
        assert (fold_kw['zb'][:, L:] == 0).all()
    else:
        assert torch.equal(xs[:, :L].view(torch.int16),
                           zbits[:, None].expand(N, S, L).reshape(N * S, L))
        assert (xs[:, L:Lp] == 0).all()
    assert (xs[:, Lp + A:Lp + Ap] == 0).all()
    assert xs[:, Lp + Ap:].isnan().all()
    assert all((v == 0).all() for v in (G, q, term, term_at))


def test_folded_first_layer_matches_plain_and_jax():
    """A value step's folded z||a first layer (ops/wide.py fold_plain, the
    function of csrc/mlp_wide.cuh's two kernels at t = 0): the product of
    each env's latent with the wide layout's latent block (u), then the
    rows' action columns with the layout's action block plus u's row of the
    env with the env's task row of the bias table added, at the 317M model's
    widths (latent 1376, mlp 4096, 6 actions; 2 envs of 3 rows, tasks 5
    and 61 of 80), against the port's plain first layer (ops/value.py:
    _dot(z, Wz) + _dot(a, Wa) + b0[task]) and JAX's z @ Wz + a @ Wa + b0 on
    the same bf16-rounded operands, within 1e-4."""
    L, M, A, T, N, S = 1376, 4096, 6, 80, 2, 3
    Lp, Ap = _up16(L), _up16(A)
    rng = np.random.default_rng(1392)

    def bf(v):
        return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
    z, a = bf(rng.normal(size=(N, L))), bf(rng.uniform(-1, 1, (N, S, A)))
    Wz, Wa = bf(rng.normal(size=(L, M)) * L ** -0.5), bf(rng.normal(size=(A, M)) * 0.4)
    b0 = torch.from_numpy(rng.normal(size=(T, M)).astype(np.float32) * 0.1)
    task = torch.tensor([5, 61], dtype=torch.int32)
    wT = tv.wide_matrix(Wz, Wa)
    assert tuple(wT.shape) == (M, Lp + Ap)
    zb = torch.nn.functional.pad(z, (0, Lp - L))
    xa = torch.nn.functional.pad(a.reshape(N * S, A), (0, Ap - A))
    u, y = wide.fold_plain(zb, xa, wT, b0, task, S)
    assert tuple(u.shape) == (N, M) and tuple(y.shape) == (N * S, M)
    zr = z.float()[:, None].expand(N, S, L)
    want = (tv._dot(zr, Wz) + tv._dot(a.float(), Wa)
            + tv.bias0({'db0': b0}, 'db0', task))
    torch.testing.assert_close(y.reshape(N, S, M), want, **VTOL)
    ref = (jnp.asarray(zr.numpy()) @ jnp.asarray(Wz.float().numpy())
           + jnp.asarray(a.float().numpy()) @ jnp.asarray(Wa.float().numpy())
           + jnp.asarray(b0.numpy())[np.array([5, 61])][:, None])
    np.testing.assert_allclose(y.reshape(N, S, M).numpy(), np.asarray(ref), **VTOL)


def _fold_hidden_case(dims, T, seed):
    """bf16 operands of a folded first layer at dims, 2 envs of 3 rows of
    tasks 5 and 61 of T, from a numpy seed; u as the u product's partial
    rows (the latent's share over its splits' K ranges) and JAX's
    _mish(_ln(z @ Wz + a @ Wa + b0[task], g0, e0)) on the same values."""
    L, M, A, N, S = dims[0], dims[1], dims[2], 2, 3
    Lp, Ap = _up16(L), _up16(A)
    rng = np.random.default_rng(seed)

    def bf(v):
        return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
    z, a = bf(rng.normal(size=(N, L))), bf(rng.uniform(-1, 1, (N, S, A)))
    Wz, Wa = bf(rng.normal(size=(L, M)) * L ** -0.5), bf(rng.normal(size=(A, M)) * 0.4)
    b0 = torch.from_numpy(rng.normal(size=(T, M)).astype(np.float32) * 0.1)
    g0 = torch.from_numpy(1 + 0.2 * rng.normal(size=M).astype(np.float32))
    e0 = torch.from_numpy(0.2 * rng.normal(size=M).astype(np.float32))
    task = torch.tensor([5, 61], dtype=torch.int32)
    wT = tv.wide_matrix(Wz, Wa)
    zb = torch.nn.functional.pad(z, (0, Lp - L))
    xa = torch.nn.functional.pad(a.reshape(N * S, A), (0, Ap - A))
    step = wm.fold_u_plan(dims, N)['kchunk'] * wm.STAGE_K
    cuts = list(range(0, Lp, step)) + [Lp]
    u = torch.stack([zb[:, k0:k1].float() @ wT[:, k0:k1].float().T
                     for k0, k1 in zip(cuts, cuts[1:])])
    zr = np.broadcast_to(z.float().numpy()[:, None], (N, S, L))
    pre = (jnp.asarray(zr) @ jnp.asarray(Wz.float().numpy())
           + jnp.asarray(a.float().numpy()) @ jnp.asarray(Wa.float().numpy())
           + jnp.asarray(b0.numpy())[np.array([5, 61])][:, None])
    ref = np.asarray(_mish(_ln(pre, jnp.asarray(g0.numpy()), jnp.asarray(e0.numpy()))))
    return dict(zb=zb, xa=xa, wT=wT, u=u, b0=b0, g0=g0, e0=e0, task=task, ref=ref, N=N, S=S,
                Lp=Lp)


def _hold_fold_hidden_plain(dims, c):
    """fold_hidden_plain on case c against JAX within 1e-4, its bf16 row
    the f32 row rounded, dst's columns past M untouched. Returns dst."""
    M, N, S, Lp = dims[1], c['N'], c['S'], c['Lp']
    dst = torch.full((N * S, M + 16), float('nan'), dtype=torch.bfloat16)
    fdst = torch.full((N * S, M), float('nan'))
    wide.fold_hidden_plain(c['xa'], c['wT'][:, Lp:], c['u'], c['b0'], c['g0'], c['e0'], dims,
                           S, dst, fdst, task=c['task'])
    np.testing.assert_allclose(fdst.reshape(N, S, M).numpy(), c['ref'], **VTOL)
    assert torch.equal(dst[:, :M].view(torch.int16), fdst.to(torch.bfloat16).view(torch.int16))
    assert dst[:, M:].isnan().all()
    return dst


def test_fold_hidden_plain_matches_jax():
    """The fused folded layer's plain version (ops/wide.py
    fold_hidden_plain, what fold_hidden_kernel is held to on the card): u
    as 4 partial rows (the latent's share over 4 K ranges) summed in order,
    then each env's own task bias row, the rows' action columns times the
    layout's action block added, then LayerNorm + Mish, against the JAX
    package's _mish(_ln(z @ Wz + a @ Wa + b0[task], g0, e0))
    (tdmpc2_tpu/ops/pallas_rollout.py:484-485) on the same bf16 operands at
    the 317M model's widths (2 envs of 3 rows, tasks 5 and 61 of 80) within
    1e-4; its bf16 row the f32 row rounded; and the wrappers on CPU tensors
    (fold_u, fold_hidden) the plain versions' bit for bit."""
    dims = _D317
    M = dims[1]
    c = _fold_hidden_case(dims, 80, 4096)
    dst = _hold_fold_hidden_plain(dims, c)
    zb, wT, Lp, u, S = c['zb'], c['wT'], c['Lp'], c['u'], c['S']
    # the wrappers take their plain versions on CPU tensors
    got_u, plan = wide.fold_u(zb, wT[:, :Lp], dims)
    assert plan is None and tuple(got_u.shape) == (1, c['N'], M)
    assert torch.equal(got_u[0], wide.fold_u_plain(zb, wT[:, :Lp]))
    torch.testing.assert_close(got_u[0], u.sum(0), **VTOL)
    got = torch.full_like(dst, float('nan'))
    assert wide.fold_hidden(c['xa'], wT[:, Lp:], u, c['b0'], c['g0'], c['e0'], dims, S,
                            task=c['task'], dst=got) is None
    assert torch.equal(got.view(torch.int16)[:, :M], dst.view(torch.int16)[:, :M])


@pytest.mark.parametrize('dims', [
    pytest.param(_D5[:2] + (38,) + _D5[3:], id='5M-38-actions'),
    pytest.param(_D317[:2] + (21,) + _D317[3:], id='317-21-actions')])
def test_fold_hidden_plain_matches_jax_at_more_actions(dims):
    """fold_hidden_plain as above at the widths of a dog task (38 actions)
    at model_size 5 and a humanoid task (21 actions) at 317: the widths
    where the fused layer stages its action block in several chunks of 8
    (2 envs of 3 rows, tasks 5 and 61 of 80, against JAX within 1e-4)."""
    assert wide.fold_fits(dims)
    _hold_fold_hidden_plain(dims, _fold_hidden_case(dims, 80, 38 + dims[2]))


_SIG_TYPES = {'int': ctypes.c_int, 'long': ctypes.c_long, 'float': ctypes.c_float}


@pytest.mark.parametrize('lib,fn', sorted(_build.SIGNATURES))
def test_library_signatures_match_the_sources(lib, fn):
    """ops/_build.py SIGNATURES, the ctypes argument types the wrappers call
    each library entry with, against the entry's `extern "C"` declaration in
    csrc/<lib>.cu: as many arguments, a pointer type where the source has a
    pointer and int, long or float where it has that (ctypes passes its
    arguments by position, so a missing or moved one would go unnoticed)."""
    src = (Path(_build.__file__).resolve().parent.parent / 'csrc' / f'{lib}.cu').read_text()
    head = re.search(rf'extern "C" int {fn}\(([^)]*)\)', src)
    assert head is not None, f'{fn} not declared in csrc/{lib}.cu'
    params = [' '.join(p.split()) for p in head.group(1).split(',')]
    argtypes = _build.SIGNATURES[(lib, fn)]
    assert len(params) == len(argtypes), (fn, params)
    for p, a in zip(params, argtypes):
        if '*' in p:
            assert a is ctypes.c_void_p or issubclass(a, ctypes._Pointer), (fn, p, a)
        else:
            assert a is _SIG_TYPES[p.rsplit(' ', 1)[0].replace('const ', '')], (fn, p, a)


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
