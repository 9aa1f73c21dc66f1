"""A Python mirror of the engines' rules, for the CPU tests.

The port takes these decisions in the built library alone: which engine
the value step and the pi rollout take (csrc/mlp_wide.cuh `tdm_engine`,
from mlp_rows.cuh `pick_plan` and `wide_fits`) and how the wide engine's
product is launched (`Wide::launch_gemm`: its tile, K splits and grid).
The CPU has no library, so the CPU tests use this copy of the rules, and
tests/test_torch_cuda.py holds the built library's answers to it on the
card. It imports neither jax nor the JAX package.
"""

import types

from tdmpc2_tpu_torch.ops import _build
from tdmpc2_tpu_torch.ops.wide import y_width

# csrc/mlp_rows.cuh kShapes (rows a block, column pairs a warp), kWarps,
# kSmemMax, kMaxStages, kNarrowPairs; the SimNorm groups both engines take.
ROW_SHAPES = ((32, 2), (32, 4), (32, 8), (16, 16))
WARPS, SMEM_MAX, MAX_STAGES, NARROW_PAIRS = 8, 232448, 8, 4
GROUPS = (2, 4, 8, 16)
WIDE_MAX_COLS = 4096      # mlp_wide.cuh: the row kernel's 256 threads x 16 values

# The product's tiles (mlp_wide.cuh WTile): rows and columns of a block and
# its consumer warpgroups; K 64 deep a stage (kWK), kWStages stages.
LARGE = dict(bm=128, bn=256, wgs=2)
SMALL = dict(bm=64, bn=128, wgs=1)
STAGE_K, STAGES, WIDE_COLS, MAX_SPLITS = 64, 4, 2048, 8


def up16(n: int) -> int:
    return -(-n // 16) * 16


def row_tile_plan(dims):
    """mlp_rows.cuh pick_plan at dims (L, M, A, B, NQ, G, H): the first
    row-tile shape whose accumulators and shared memory fit, as {rt,
    stages, smem_bytes}, or None when none fits."""
    L, M, A, B, _, G, H = dims
    Lp, Ap, Mp, Bp = up16(L), up16(A), up16(M), up16(B)
    widest, hp = max(Mp, Lp, Bp), up16(2 * A)
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


def wide_fits(dims) -> bool:
    """mlp_wide.cuh wide_fits: SimNorm groups it takes, every layer at most
    4096 columns."""
    L, M, A, B, _, G, _ = dims
    return G in GROUPS and L % G == 0 and A >= 1 and max(L, M, B, 2 * A) <= WIDE_MAX_COLS


def mirror_lib():
    """A stand-in for a built library whose tdm_engine is the mirror: 0 the
    row tiles, 1 the wide engine, NO_PLAN neither."""
    def tdm_engine(dims):
        dims = tuple(dims)
        if row_tile_plan(dims) is not None:
            return 0
        return 1 if wide_fits(dims) else _build.NO_PLAN
    return types.SimpleNamespace(tdm_engine=tdm_engine)


def gemm_tile(dims, S: int) -> dict:
    """mlp_wide.cuh wide_large: LARGE where the widest layer is above 2048
    columns and an env has more than 64 rows, else SMALL."""
    L, M, _, B = dims[:4]
    return LARGE if max(up16(L), up16(M), up16(B)) > WIDE_COLS and S > 64 else SMALL


def gemm_splits(ncols: int, bn: int, nk: int, ldy: int) -> int:
    """mlp_wide.cuh gemm_splits: 1 unless one column tile holds the output;
    then splits of at least 8 stages, at most MAX_SPLITS, and no more
    partial rows of up16(ncols) columns than a row of y holds."""
    if ncols > bn:
        return 1
    return max(1, min(nk // 8, MAX_SPLITS, ldy // up16(ncols)))


def gemm_plan(dims, n_envs: int, S: int, K: int, ncols: int, per_env: bool) -> dict:
    """The launch plan of one product (Wide::launch_gemm): K input columns,
    ncols outputs, on n_envs envs of S rows; `per_env` where the layer's
    bias or weights depend on the env (a multi-task first layer, the Q
    heads). Returns the tile (bm, bn, wgs), nk stages, the splits and their
    stages (kchunk), pstride, bpe (row tiles an env; 0: over all rows) and
    the grid of tiles (column tiles, row tiles, splits), which the card's
    persistent blocks walk."""
    t = gemm_tile(dims, S)
    nk = -(-K // STAGE_K)
    s = gemm_splits(ncols, t['bn'], nk, y_width(dims))
    kchunk = -(-nk // s)
    s = -(-nk // kchunk)
    bpe = -(-S // t['bm']) if per_env else 0
    gy = n_envs * bpe if per_env else -(-n_envs * S // t['bm'])
    return dict(t, nk=nk, splits=s, kchunk=kchunk, pstride=up16(ncols), bpe=bpe,
                grid=(-(-ncols // t['bn']), gy, s))


def gemm_blocks(plan, n_envs: int, S: int, K: int, ncols: int):
    """Each tile of a plan as (rows, columns, K range, output column
    offset): the rows [row0, row0 + nrows) it stores, the columns [c0, c1),
    the K columns [k0, k1) it sums and the partial row's offset in y
    (gemm_kernel's gemm_tile, in the order its blocks walk them)."""
    bm, bn, R = plan['bm'], plan['bn'], n_envs * S
    gx, gy, gz = plan['grid']
    for bz in range(gz):
        ks0 = bz * plan['kchunk']
        k0, k1 = ks0 * STAGE_K, min(plan['nk'], ks0 + plan['kchunk']) * STAGE_K
        for by in range(gy):
            if plan['bpe']:
                env, r0 = divmod(by, plan['bpe'])
                row0, nrows = env * S + r0 * bm, min(bm, S - r0 * bm)
            else:
                row0 = by * bm
                nrows = min(bm, R - row0)
            for bx in range(gx):
                c0 = bx * bn
                yield ((row0, row0 + nrows), (c0, min(c0 + bn, ncols)),
                       (k0, min(k1, K)), bz * plan['pstride'])
