"""A Python mirror of the engines' rules, for the CPU tests.

The port takes these decisions in the built library alone: which engine
the value step and the pi rollout take (csrc/mlp_wide.cuh `tdm_engine`,
from mlp_rows.cuh `pick_plan` and `wide_fits`), how the wide engine's
product is launched (`Wide::launch_gemm`: its tile, K splits and grid) and
how its row kernel is (`Wide::rows`: the threads a row, from the width
alone, the columns each owns, the ring of row buffers), and the two
kernels of a value step's folded first layers (`Wide::fold_u`, the u
product on the envs' packed rows, and `Wide::fold_hidden`, the fused
action product + LayerNorm + Mish).
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
# mlp_wide.cuh's row kernel: a block's threads, float4 chunks a LayerNorm
# thread holds, a LayerNorm block's ring of rows (bytes) and its stages at
# most.
ROW_THREADS, ROW_CHUNKS, ROW_RING, ROW_STAGES = 256, 4, 64 * 1024, 8
ROW_KEEP = 2              # chunks of a two-hot row a lane keeps in registers

# The product's tiles (mlp_wide.cuh WTile): rows and columns of a block and
# its consumer warpgroups; K 64 deep a stage (kWK), kWStages stages.
LARGE = dict(bm=128, bn=256, wgs=2)
SMALL = dict(bm=64, bn=128, wgs=1)
STAGE_K, STAGES, WIDE_COLS, MAX_SPLITS = 64, 4, 2048, 8
# The u product (mlp_wide.cuh kFoldCols, kFoldEnvs, kFoldTiles): u's
# columns a block, envs an env tile, the blocks its K split aims at.
FOLD_COLS, FOLD_ENVS, FOLD_TILES = 128, 64, 128
FOLD_ACT_ROWS = 128       # mlp_wide.cuh kFoldActRows: a group's rows of staged actions


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


def fold_splits(ncols: int, nk: int) -> int:
    """mlp_wide.cuh fold_splits: FOLD_TILES blocks over the column tiles, at
    most MAX_SPLITS, at least 2 stages a split; from the widths alone."""
    return max(1, min(FOLD_TILES // -(-ncols // FOLD_COLS), MAX_SPLITS, nk // 2))


def fold_u_plan(dims, n_envs: int) -> dict:
    """The u product's plan (Wide::fold_u): u = zb . W[:, :Lp] on n_envs
    latents of K = up16(L) columns into M columns. Blocks of
    FOLD_COLS columns and ke env tiles of FOLD_ENVS (2 above 64 envs), the K
    split from the widths alone, one block a tile; pstride the floats from
    one split's partial rows to the next (n_envs rows of up16(M))."""
    M, K = dims[1], up16(dims[0])
    nk = -(-K // STAGE_K)
    s = fold_splits(M, nk)
    kchunk = -(-nk // s)
    s = -(-nk // kchunk)
    ke = 2 if n_envs > FOLD_ENVS else 1
    grid = (-(-M // FOLD_COLS), -(-n_envs // (ke * FOLD_ENVS)), s)
    return dict(ke=ke, nk=nk, splits=s, kchunk=kchunk, pstride=n_envs * up16(M), grid=grid,
                blocks=grid[0] * grid[1] * grid[2])


def fold_u_blocks(plan, dims, n_envs: int):
    """Each block of a u plan as (columns, envs, K range, split): the
    columns [c0, c1) and envs [e0, e1) it stores, the K columns [k0, k1) it
    sums and its split; fold_u_kernel's order, column tiles fastest."""
    M, K = dims[1], up16(dims[0])
    gx, gy, gz = plan['grid']
    span = plan['ke'] * FOLD_ENVS
    for t in range(gx * gy * gz):
        bx, by, z = t % gx, t // gx % gy, t // (gx * gy)
        c0, e0 = bx * FOLD_COLS, by * span
        ks0 = z * plan['kchunk']
        k0, k1 = ks0 * STAGE_K, min(plan['nk'], ks0 + plan['kchunk']) * STAGE_K
        e1 = min(e0 + span, n_envs)
        yield (c0, min(c0 + FOLD_COLS, M)), (e0, e1), (k0, min(k1, K)), z


def fold_hidden_plan(dims) -> dict:
    """Wide::fold_hidden: row groups of threads_a_row threads (row_kernel's,
    from M alone), row_groups of them a block, action_chunks of 8 action
    columns (up8(A) / 8), the shared bytes (mlp_wide.cuh fold_hidden_smem):
    the staged action block (A rows of M columns, up to a multiple of 4,
    bf16; on 16 bytes), then each group's FOLD_ACT_ROWS rows of actions (16
    bytes a chunk), then its u row (f32)."""
    M, A = dims[1], dims[2]
    tpr = row_plan('hidden', M)['threads_a_row']
    rg, ak = ROW_THREADS // tpr, -(-A // 8)
    width = -(-M // 4) * 4
    block = -(-(A * width * 2) // 16) * 16
    return dict(threads_a_row=tpr, row_groups=rg, action_chunks=ak,
                smem_bytes=block + rg * FOLD_ACT_ROWS * ak * 16 + rg * width * 4)


def fold_plans(dims, n_envs: int):
    """The two launches of a folded z||a first layer (Wide::hidden2 at a
    value step's t = 0 with the latent broadcast): the u product on the
    n_envs envs' latents, then the fused action product + LayerNorm + Mish
    on every row."""
    return fold_u_plan(dims, n_envs), fold_hidden_plan(dims)


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


def row_plan(mode: str, ncols: int, nsplit: int = 1, pstride: int = 0, A: int = 0) -> dict:
    """Wide::rows: the LayerNorm modes ('hidden', 'latent') on row groups of
    threads_a_row threads (32 to 256: the fewest that hold the row at
    ROW_CHUNKS float4 chunks a thread), row_groups of them a block, each
    with a ring of `stages` row buffers (the row and its partial rows, 4
    columns at a time; None where they do not fit shared memory: the
    launch refuses); the narrow modes on threads_a_row lanes a row (the
    policy: A lanes; the two-hot decode: ROW_KEEP chunks a lane; the gate:
    one), no ring."""
    if mode in ('hidden', 'latent'):
        tpr = 32
        while tpr < ROW_THREADS and ncols > tpr * ROW_CHUNKS * 4:
            tpr *= 2
        rg = ROW_THREADS // tpr
        floats = (nsplit - 1) * pstride + -(-ncols // 4) * 4
        stages = min(max(ROW_RING // (rg * floats * 4), 1), ROW_STAGES)
        smem = rg * stages * (floats * 4 + 8)
        return None if smem > SMEM_MAX else dict(
            threads_a_row=tpr, row_groups=rg, stages=stages, smem_bytes=smem)
    lpr = 1
    if mode == 'pi':
        while lpr < 32 and lpr < A:
            lpr *= 2
    elif mode != 'term':
        while lpr < 32 and ROW_KEEP * lpr < -(-ncols // 4):
            lpr *= 2
    return dict(threads_a_row=lpr, row_groups=ROW_THREADS // lpr, stages=0, smem_bytes=0)


def row_owners(mode: str, ncols: int, dpad: int = 0, A: int = 0) -> dict:
    """{column: (thread of the row's group, its slot)} of the row kernel:
    LayerNorm thread t holds the float4 chunks t + i * threads_a_row (i <
    ROW_CHUNKS), to dpad (dst's zeros included); a two-hot lane l the chunks
    l, l + threads_a_row, ... (the first ROW_KEEP kept); a policy lane l
    the columns l, l + threads_a_row, ... below dpad; the gate's lane its
    row's one column. Every owner follows from the width alone."""
    n = row_plan(mode, ncols, A=A)['threads_a_row']
    owners = {}
    if mode in ('hidden', 'latent', 'reward', 'q0', 'q1'):
        slots = ROW_CHUNKS if mode in ('hidden', 'latent') else None
        width = max(ncols, dpad)
        for t in range(n):
            i = 0
            while (slots is None or i < slots) and 4 * (t + i * n) < width:
                for c in range(4 * (t + i * n), 4 * (t + i * n) + 4):
                    if c < width:
                        owners.setdefault(c, []).append((t, i))
                i += 1
    else:
        width = max(dpad, 1)
        for t in range(n):
            for i, c in enumerate(range(t, width, n)):
                owners.setdefault(c, []).append((t, i))
    return owners
