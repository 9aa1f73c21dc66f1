"""Which engine the tensor-core kernels take, and the host side of the
layer-per-launch engine (csrc/mlp_wide.cuh).

The value kernel and the pi rollout have two engines. The row-tile engine
(csrc/mlp_rows.cuh) keeps a block's rows in shared memory for the whole
rollout and needs a layer's whole output row in one block's accumulators:
it takes widths up to 2048 columns (model_size 1 to 48). Above that
(model_size 317: mlp_dim 4096, latent 1376) the wide engine runs one
launch a layer: a product over (column tile x row tile x K split) tiles,
walked by persistent blocks, then a row kernel for what needs the whole
row. The engine follows from the
widths alone (`engine`: the built library's own rule, `tdm_engine`, which
the wrappers and the weight prep ask); nothing tries one engine and falls
back to the other, and a width that neither takes raises. The rollout
kernel runs on the wide engine at every width.

The product (csrc/mlp_wide.cuh gemm_kernel) runs wgmma on operands that
TMA stages into a 4-deep ring of 64-deep K stages, the sum kept in the
wgmma accumulators over the whole K. Its tensor maps are encoded at each
launch on the host from that launch's pointers, with the driver's
cuTensorMapEncodeTiled reached through cudaGetDriverEntryPoint: the
libraries link to the CUDA runtime alone (ops/_build.py), never to
libcuda. Its tile plan: the block's tile from S and the widths (128 x 256
above 2048 columns where an env has more than 64 rows, else 64 x 128), row
tiles inside one env where the layer's bias or weights depend on the env
and over all rows elsewhere, and K split over up to 8 blocks for an output
of one column tile, whose partial rows the row kernel sums in order
(tests/wide_mirror.py mirrors the rules for the CPU tests, and the card
tests hold the built library to the mirror).

A wide call's intermediates live in scratch buffers that the wrapper
allocates per call (`Scratch`): the bf16 z||a rows, the bf16 hidden rows,
the f32 product and three per-row scalars; for a value step also each env's
latent (bf16) and the latent's share of a first layer (f32, up to 8
partial rows an env). Inside the plan's CUDA graph they come from the
graph's pool, at fixed addresses, so the tensor maps captured with the
launches stay valid.

The staging (csrc/mlp_wide.cuh stage_kernel) writes each step's actions
into the z||a rows, a thread a row, and at step 0 the latent, a warp a row.
Where a value step's latent broadcasts over an env's rows (the planner's:
z0 of row stride 0) it folds: step 0's staging writes each env's latent
once, into the env's row of zb, and the reward's and the dynamics' first
layers at step 0 take x W = z Wz + a Wa apart, as the TPU kernel does, in
two kernels of their own (csrc/mlp_wide.cuh fold_u_kernel,
fold_hidden_kernel): the N latents times the latent block into u (the env
rows packed into shared tiles, K split into partial rows), then for each
row its action columns times the action block plus u's row of the env
with the env's task bias row added, LayerNorm and Mish in one launch, the
bf16 hidden row out (the f32 pre-activation never in device memory). It
folds where the fused layer's staged action block fits a block's shared
memory (`fold_fits`: at 4096 columns up to 25 actions) and the task is not
episodic (the gate's flags keep step 0's one product over z||a);
elsewhere step 0 runs as the other steps do, a product and a row kernel a
layer. A value
step is then 13 launches a horizon step (19 with the termination gate) +
18, of them a staging a step, 6 (9) products a step + 9 less the 2 folded
first layers, a u product and a fused layer for each of those, and a row
kernel after every other product; a pi rollout 12 H - 5, 6 H - 3 products
and as many row kernels, one staging; a rollout 13 H, 6 H products and row
kernels, H stagings (neither folds).

`engine_launches.launches` counts the wide engine's device launches and
`gemm_launches`, `row_launches`, `stage_launches`, `fold_u_launches` and
`fold_hidden_launches` the products, row kernels, stagings, u products and
fused folded layers among them, each counted by the library where it
launches that kernel (the wrappers count their calls, one a kernel).
`gemm` launches one product on given operands (the library's
`tdm_wide_gemm`), `rows` one row kernel (`tdm_wide_rows`; its plain
version `rows_plain`), `stage` one staging (`tdm_wide_stage`;
`stage_plain`), `fold_u` one u product (`tdm_wide_fold_u`; `fold_u_plain`)
and `fold_hidden` one fused layer (`tdm_wide_fold_hidden`;
`fold_hidden_plain`), for checks and timings; no path calls them.

The row kernel (csrc/mlp_wide.cuh row_kernel, row_narrow_kernel): the
LayerNorm modes stream a row group's rows by bulk copies into a ring of
row buffers in shared memory, persistent blocks walking the rows; the
narrow modes pack several rows a warp. Each row's arithmetic follows from
the width alone (tests/wide_mirror.py row_plan, row_owners).
"""

from __future__ import annotations

import ctypes

import torch

from tdmpc2_tpu_torch.ops import _build

_engines: dict = {}


def engine(lib, dims) -> str:
    """The engine the built library `lib` gives the widths `dims` (L, M, A,
    B, num_q, simnorm_dim, H): csrc/mlp_wide.cuh `tdm_engine`, 'rows' where
    mlp_rows.cuh `pick_plan` finds a row tile, else 'wide' where the wide
    engine takes them; ValueError naming the widths otherwise. Cached per
    dims (the rule reads the widths only)."""
    key = tuple(dims)
    found = _engines.get(key)
    if found is None:
        rc = lib.tdm_engine((ctypes.c_int * 7)(*key))
        if rc not in (0, 1):
            _build.check(lib, rc, 'engine', key)
        found = _engines[key] = ('rows', 'wide')[rc]
    return found


# ------------------------------------------------------------ the widths

def _up16(n: int) -> int:
    return -(-n // 16) * 16


def y_width(dims) -> int:
    """Columns of a row of the f32 product (Scratch.y): the widest layer."""
    L, M, A, B = dims[:4]
    return max(_up16(M), _up16(L), _up16(B), _up16(2 * A))


# ---------------------------------------------------------------- launches

class LaunchCount:
    """A launch counter in the wrappers' form (`.launches`), which
    utils/cuda_graph.Graph counts through a capture and adds at each
    replay."""

    def __init__(self):
        self.launches = 0


engine_launches = LaunchCount()
gemm_launches = LaunchCount()
row_launches = LaunchCount()
stage_launches = LaunchCount()
fold_u_launches = LaunchCount()
fold_hidden_launches = LaunchCount()
COUNTERS = (engine_launches, gemm_launches, row_launches, stage_launches, fold_u_launches,
            fold_hidden_launches)


def counts():
    """The array a wide call's library entry fills (`launched` [6]: its
    launches, then the products, row kernels, stagings, u products and
    fused folded layers among them)."""
    return (ctypes.c_int * len(COUNTERS))()


def count(n) -> None:
    """Add a wide call's counts (`counts`) to the counters."""
    for c, k in zip(COUNTERS, n):
        c.launches += k


# The fused layer's shared memory (csrc/mlp_wide.cuh fold_hidden_smem,
# fold_fits): rows of actions a row group stages, statistics slots, the
# most a block may opt into.
_FOLD_ACT_ROWS, _FOLD_RED_BYTES, _SMEM_MAX = 128, 256, 232448


def fold_fits(dims) -> bool:
    """Whether a value step at dims may fold (csrc/mlp_wide.cuh
    fold_fits): the fused layer's staged action block (A rows of M columns,
    bf16), each row group's rows of actions and its u row (f32) fit a
    block's shared memory."""
    M, A = dims[1], dims[2]
    tpr = 32
    while tpr < 256 and M > tpr * 16:
        tpr *= 2
    width, rg, ak = -(-M // 4) * 4, 256 // tpr, -(-A // 8)
    smem = -(-(A * width * 2) // 16) * 16 + rg * _FOLD_ACT_ROWS * ak * 16 + rg * width * 4
    return smem + _FOLD_RED_BYTES <= _SMEM_MAX


def value_launches(horizon: int, episodic: bool) -> int:
    """Device launches of one wide value step: per horizon step the staging
    and a product and a row kernel for each of the reward's and the
    dynamics' three layers (and the termination head's), then the policy's
    three layers and the two Q heads' six. Folded (the latent broadcast
    over each env's rows, the planner's, on a task that is not episodic),
    step 0's two z||a first layers are a u product and a fused layer each
    in place of a product and a row kernel: as many launches."""
    return horizon * (19 if episodic else 13) + 18


def value_products(horizon: int, episodic: bool, dims=None) -> int:
    """The products (gemm_kernel) of a value step with a broadcast latent
    at dims (None: widths that fold): a layer's each but the folded first
    layers'."""
    return horizon * (9 if episodic else 6) + 9 - value_folds(dims, episodic)


def value_folds(dims=None, episodic: bool = False) -> int:
    """The u products of a value step with a broadcast latent at dims
    (None: widths that fold), and as many fused layers: step 0's reward and
    dynamics first layers where `fold_fits` and the task is not episodic,
    else none."""
    return 0 if episodic or (dims is not None and not fold_fits(dims)) else 2


def pi_rollout_launches(horizon: int) -> int:
    return 12 * horizon - 5


def pi_rollout_products(horizon: int) -> int:
    return 6 * horizon - 3


def rollout_launches(horizon: int) -> int:
    return 13 * horizon


def rollout_products(horizon: int) -> int:
    return 6 * horizon


def plan_launches(horizon: int, iterations: int, episodic: bool) -> int:
    """The wide engine's device launches of one plan: the pi rollout and
    `iterations` value steps (the elite kernel's launches apart)."""
    return (pi_rollout_launches(horizon)
            + iterations * value_launches(horizon, episodic))


def plan_products(horizon: int, iterations: int, episodic: bool) -> int:
    return (pi_rollout_products(horizon)
            + iterations * value_products(horizon, episodic))


def plan_stagings(horizon: int, iterations: int) -> int:
    """A plan's stagings: the pi rollout's one, a value step's one a step.
    Its row kernels are the rest of its launches past its products,
    stagings, u products and fused layers."""
    return 1 + iterations * horizon


def plan_folds(iterations: int) -> int:
    """A plan's u products, and as many fused layers: each value step's
    (on a task that is not episodic, at widths that fold)."""
    return iterations * value_folds()


# The u product's K splits at most (csrc/mlp_wide.cuh kWMaxSplits): the
# partial rows of u a Scratch holds.
FOLD_SPLITS = 8


class Scratch:
    """One wide call's device buffers for R rows at dims: x (bf16 z||a
    rows), h (bf16 hidden rows), y (f32 product rows, as wide as the widest
    layer), and the per-row G, q, term (f32); with `envs` (a value step's
    N, 0 on an episodic task) at widths that fold (`fold_fits`) also zb
    (bf16 [N, up16(L)]) and u
    (f32 [FOLD_SPLITS, N, up16(M)]: the u product's partial rows) for its
    folded first layers; `ptrs` and `lds` are the kernels' arguments."""

    def __init__(self, R: int, dims, device, envs: int = 0):
        L, M, A, B = dims[:4]
        Lp, Ap, Mp = _up16(L), _up16(A), _up16(M)
        ldy = y_width(dims)
        self.x = torch.empty(R, Lp + Ap, dtype=torch.bfloat16, device=device)
        self.h = torch.empty(R, Mp, dtype=torch.bfloat16, device=device)
        self.y = torch.empty(R, ldy, dtype=torch.float32, device=device)
        self.s = torch.empty(3, R, dtype=torch.float32, device=device)
        fold = ()
        if envs and fold_fits(dims):
            self.zb = torch.empty(envs, Lp, dtype=torch.bfloat16, device=device)
            self.u = torch.empty(FOLD_SPLITS, envs, Mp, dtype=torch.float32, device=device)
            fold = (self.zb.data_ptr(), self.u.data_ptr())
        self.ptrs = (ctypes.c_void_p * 8)(
            self.x.data_ptr(), self.h.data_ptr(), self.y.data_ptr(),
            *(self.s[i].data_ptr() for i in range(3)), *(fold or (None, None)))
        self.lds = (ctypes.c_long * 3)(Lp + Ap, Mp, ldy)


def gemm(x, w, bias, dims, S: int, *, b1=None, split: int = -1, task=None,
         ntask: int = 1, head=None, hn: int = 1, bt: int = 0, bh: int = 0,
         out=None):
    """One product of the wide engine on given CUDA operands (the library's
    `tdm_wide_gemm`; no path calls it): y = x[:, :K] @ W + bias for the
    model dims `dims` (its tile) and N envs of S rows. x [N*S, >= K] bf16
    with unit inner stride; w the wide layout [ncols, K] (rows of any
    stride: a block of a wider matrix's layout, such as a first layer's
    latent or action columns) or [heads, ncols, K] bf16 (contiguous; heads
    with `head`, int32, env e's head at head[e * hn]); x's and w's rows on
    16 bytes; bias f32, column c of env e at bias[task * bt + head * bh +
    c] (from column `split` on, b1[c - split]); task int32 [N] or None, of
    `ntask` tasks; K split as the engine's rule gives it. `out`, a
    contiguous f32 [N*S, ldy] tensor, receives y (None: a new one, NaN
    where the kernel writes nothing). Returns (y as the kernel wrote it, the
    plan: tile, splits, pstride, grid); `gemm_sum` adds the partial rows."""
    if x.device.type != 'cuda':
        raise ValueError(f'wide.gemm: unsupported device {x.device}')
    K, ncols = w.shape[-1], w.shape[-2]
    ldw = w.stride(-2)
    R = x.shape[0]
    if (x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or x.stride(1) != 1
            or w.stride(-1) != 1 or (w.dim() == 3 and w.stride(0) != ncols * ldw)
            or x.shape[1] < K or K % 16 or R % S or bias.dtype != torch.float32
            or x.data_ptr() % 16 or x.stride(0) % 8 or w.data_ptr() % 16 or ldw % 8):
        raise ValueError(f'wide.gemm: x {tuple(x.shape)} {x.dtype}, w {tuple(w.shape)} '
                         f'{w.dtype} do not fit (K={K}, S={S})')
    y = out if out is not None else torch.full(
        (R, y_width(dims)), float('nan'), dtype=torch.float32, device=x.device)
    if tuple(y.shape) != (R, y_width(dims)) or y.dtype != torch.float32 \
            or not y.is_contiguous():
        raise ValueError(f'wide.gemm: out must be a contiguous f32 '
                         f'{(R, y_width(dims))} tensor')
    plan = (ctypes.c_int * 10)()
    n = counts()
    lib = _build.library('rollout')
    rc = lib.tdm_wide_gemm(
        (ctypes.c_int * 7)(*dims), R // S, S, x.data_ptr(), x.stride(0), K // 16,
        w.data_ptr(), ldw, ncols, bias.data_ptr(), bt, bh,
        None if b1 is None else b1.data_ptr(), split,
        None if task is None else task.data_ptr(), ntask,
        None if head is None else head.data_ptr(), hn, y.data_ptr(), y.shape[1],
        plan, n, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, 'wide product', dims)
    gemm.launches += n[1]
    keys = ('bm', 'bn', 'wgs', 'splits', 'kchunk', 'pstride')
    return y, dict(zip(keys, plan[:6]), grid=tuple(plan[6:9]), blocks=plan[9])


gemm.launches = 0


def _task_rows(task, n: int, ntask: int, device):
    """Each env's row of a bias table: task (int [n]) clamped to the
    table's ntask rows, as the kernels clamp it; None: row 0."""
    if task is None:
        return torch.zeros(n, dtype=torch.long, device=device)
    return task.long().clamp(0, ntask - 1)


def fold_plain(zb, xa, wT, b0, task, S: int):
    """The plain version of a folded z||a first layer (csrc/mlp_wide.cuh
    Wide::hidden2 at a value step's t = 0, the latent broadcast over each
    env's S rows): u = zb . W[:, :Lp] on the N envs' latents (zb [N, Lp]),
    then y = xa . W[:, Lp:] + (u + b0[task])[env] on the N*S rows' action
    columns (xa [N*S, Ap]); wT the layer's wide layout [M, Lp + Ap]
    (ops/value.py wide_matrix), b0 its bias table [tasks, M], task int [N]
    or None (task 0). Returns (u, y), f32 sums of the operands' values; y
    is the pre-activation that the fused layer keeps in registers."""
    Lp = zb.shape[1]
    W = wT.float()
    t = _task_rows(task, zb.shape[0], b0.shape[0], zb.device)
    u = zb.float() @ W[:, :Lp].T
    env = torch.arange(xa.shape[0], device=xa.device) // S
    return u, xa.float() @ W[:, Lp:].T + (u + b0[t])[env]


def fold_u_plain(zb, w):
    """The plain version of the u product: zb[:, :K] . w.T in f32 on the N
    envs' latents (zb [N, >= K] bf16, w [ncols, K] bf16: the latent block
    of a first layer's wide layout). Returns u [N, ncols]."""
    return zb[:, :w.shape[1]].float() @ w.float().T


def fold_u(zb, w, dims, *, out=None):
    """The u product of a folded first layer alone (the library's
    `tdm_wide_fold_u`, as Wide::hidden2 launches it; no path calls it), for
    checks and timings: `fold_u_plain`'s function for the model dims `dims`
    (the u product's plan from M and K alone, its env tiles from N). On the
    card zb [N, >= K] bf16 (unit inner stride, rows on 16 bytes), w [ncols,
    K] bf16 of any row stride (a multiple of 8; K a multiple of 16); `out`
    a contiguous f32 [FOLD_SPLITS, N, up16(ncols)] tensor (None: a new one,
    NaN where the kernel writes nothing). Returns (u's partial rows [splits,
    N, ncols], summed in order by the fused layer; the plan: env tiles a
    block, splits, stages a split, pstride, grid, blocks). On the CPU:
    (fold_u_plain's u as one partial row, None)."""
    if zb.device.type == 'cpu':
        return fold_u_plain(zb, w)[None], None
    K, ncols = w.shape[1], w.shape[0]
    N = zb.shape[0]
    shape = (FOLD_SPLITS, N, _up16(ncols))
    u = out if out is not None else torch.full(shape, float('nan'), dtype=torch.float32,
                                               device=zb.device)
    if (zb.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or zb.stride(1) != 1
            or w.stride(1) != 1 or K % 16 or zb.shape[1] < K or zb.data_ptr() % 16
            or zb.stride(0) % 8 or w.data_ptr() % 16 or w.stride(0) % 8
            or tuple(u.shape) != shape or u.dtype != torch.float32 or not u.is_contiguous()):
        raise ValueError(f'wide.fold_u: zb {tuple(zb.shape)} {zb.dtype}, w {tuple(w.shape)} '
                         f'{w.dtype}, out {tuple(u.shape)} do not fit')
    plan = (ctypes.c_int * 8)()
    n = counts()
    lib = _build.library('rollout')
    rc = lib.tdm_wide_fold_u(
        (ctypes.c_int * 7)(*dims), N, zb.data_ptr(), zb.stride(0), K // 16, w.data_ptr(),
        w.stride(0), ncols, u.data_ptr(), u.stride(1), plan, n,
        torch.cuda.current_stream(zb.device).cuda_stream)
    _build.check(lib, rc, 'wide u product', dims)
    fold_u.launches += n[4]
    keys = ('ke', 'splits', 'kchunk', 'pstride')
    info = dict(zip(keys, plan[:4]), grid=tuple(plan[4:7]), blocks=plan[7])
    return u[:info['splits'], :, :ncols], info


fold_u.launches = 0


def fold_hidden_plain(xa, wa, u, b0, gain, beta, dims, S: int, dst, fdst=None, *, task=None):
    """The plain version of the fused folded layer: u's partial rows (u
    [nsplit, N, >= M]) summed in order, then each env's task bias row
    added, y = xa . wa.T + that[env] in f32 on the N*S rows' action columns
    (xa [N*S, Ap] bf16,
    wa [M, Ap] bf16: the action block of the layer's wide layout, the
    columns past A zeros in both; b0 the bias table [tasks, >= M] f32, task
    int [N] or None: task 0), then `rows_plain('hidden', y, ...)`:
    mish(layer_norm(y, gain, beta)) into dst (bf16 [N*S, >= up16(M)], zeros
    from M) and, when given, fdst (f32 [N*S, >= M])."""
    M = dims[1]
    us = u[0, :, :M].float().clone()
    for p in range(1, u.shape[0]):
        us += u[p, :, :M]
    env = torch.arange(xa.shape[0], device=xa.device) // S
    us += b0[_task_rows(task, u.shape[1], b0.shape[0], xa.device), :M]
    Ap = wa.shape[1]
    y = xa[:, :Ap].float() @ wa.float().T + us[env]
    rows_plain('hidden', y, dims, S, gain=gain, beta=beta, dst=dst, dpad=_up16(M), fdst=fdst)


def fold_hidden(xa, wa, u, b0, gain, beta, dims, S: int, *, task=None, dst):
    """The fused folded layer alone (the library's `tdm_wide_fold_hidden`,
    as Wide::hidden2 launches it after the u product; no path calls it),
    for checks and timings: `fold_hidden_plain`'s function (without fdst),
    which it takes on CPU tensors. On the card xa the rows' action columns
    (bf16, unit inner stride, rows on 16 bytes: x[:, Lp:] of the z||a rows),
    wa [M, >= up8(A)] bf16 of any row stride (a multiple of 8, on 16
    bytes), u [nsplit, N, >= M] f32 (rows on 16 bytes: u's stride(1) and
    stride(0) multiples of 4; `fold_u`'s partial rows), b0 [tasks, >= M]
    f32 with unit inner stride, task int32 [N] or None, gain and beta [M]
    f32 contiguous, dst [N*S, >= up16(M)] bf16 with rows on 8 bytes.
    Returns the launch's plan: threads a row, row groups a block, action
    chunks of 8, shared bytes a block, blocks launched and the blocks the
    card holds at once (None on the CPU)."""
    if xa.device.type == 'cpu':
        fold_hidden_plain(xa, wa, u, b0, gain, beta, dims, S, dst, task=task)
        return None
    R, M, A = xa.shape[0], dims[1], dims[2]
    N = u.shape[1]
    if (xa.dtype != torch.bfloat16 or wa.dtype != torch.bfloat16 or xa.stride(1) != 1
            or wa.stride(1) != 1 or u.dtype != torch.float32 or u.stride(2) != 1
            or R != N * S or dst.dtype != torch.bfloat16 or dst.stride(1) != 1
            or xa.shape[1] < -(-A // 8) * 8 or wa.shape[1] < -(-A // 8) * 8
            or b0.dtype != torch.float32 or b0.stride(1) != 1 or b0.shape[1] < M
            or (task is not None and (task.dtype != torch.int32 or task.numel() != N))
            or dst.shape[1] < _up16(M) or not (gain.is_contiguous() and beta.is_contiguous())):
        raise ValueError(f'wide.fold_hidden: xa {tuple(xa.shape)} {xa.dtype}, wa '
                         f'{tuple(wa.shape)}, u {tuple(u.shape)}, dst {tuple(dst.shape)} do '
                         f'not fit dims {tuple(dims)} and {N} envs of {S} rows')
    plan = (ctypes.c_int * 6)()
    n = counts()
    lib = _build.library('rollout')
    rc = lib.tdm_wide_fold_hidden(
        (ctypes.c_int * 7)(*dims), N, S, xa.data_ptr(), xa.stride(0), wa.data_ptr(),
        wa.stride(0), u.data_ptr(), u.stride(1), u.stride(0), u.shape[0], b0.data_ptr(),
        b0.stride(0), None if task is None else task.data_ptr(), b0.shape[0],
        gain.data_ptr(), beta.data_ptr(), dst.data_ptr(), dst.stride(0), plan, n,
        torch.cuda.current_stream(xa.device).cuda_stream)
    _build.check(lib, rc, 'wide fused folded layer', dims)
    fold_hidden.launches += n[5]
    keys = ('threads_a_row', 'row_groups', 'action_chunks', 'smem_bytes', 'blocks',
            'resident')
    return dict(zip(keys, plan))


fold_hidden.launches = 0


def gemm_sum(y, plan, ncols: int):
    """The product's [R, ncols] columns from the rows `gemm` wrote: its
    partial rows added in order, as the row kernel adds them."""
    out = y[:, :ncols].clone()
    for p in range(1, plan['splits']):
        out += y[:, p * plan['pstride']:p * plan['pstride'] + ncols]
    return out


# -------------------------------------------------------- the row kernel

# csrc/mlp_wide.cuh RowMode, in its order.
ROW_MODES = ('hidden', 'latent', 'reward', 'q0', 'q1', 'pi', 'term')


def row_width(mode: str, dims) -> int:
    """Columns of the product a row kernel of `mode` reads at dims (L, M,
    A, B, ...): M, L, the bins, the policy's 2A (mean, raw log-std), the
    termination logit."""
    L, M, A, B = dims[:4]
    return {'hidden': M, 'latent': L, 'reward': B, 'q0': B, 'q1': B,
            'pi': 2 * A, 'term': 1}[mode]


def rows_plain(mode, y, dims, S: int, *, nsplit: int = 1, pstride: int = 0,
               gain=None, beta=None, head=None, bins=None, dst=None, dpad: int = 0,
               fdst=None, G=None, q=None, term=None, term_at=None, discs=None,
               t: int = 0, out=None, eps=None, amask=None, log_std_min: float = 0.0,
               log_std_dif: float = 0.0):
    """The row kernel's function in torch ops, in place, on the rows of N
    envs of S rows. y [R, >= nsplit * pstride] f32 holds the product's
    row, or its nsplit partial rows pstride columns apart, summed here in
    order; ncols = row_width(mode, dims). The modes:

    - 'hidden': mish(layer_norm(y, gain, beta)), 'latent': simnorm of the
      LayerNorm over groups of dims[5]; gain and beta [ncols], or [heads,
      ncols] with `head` (int [N]: env e's row of them, clamped); into dst
      (bf16 [R, >= dpad]: the values, zeros from ncols to dpad) and, when
      given, fdst (f32 [R, >= ncols]);
    - 'reward', 'q0', 'q1': r, the two-hot decode over `bins`: G += discs[e,
      t] * (1 - term) * r; q = r; out = G + discs[e, t] * (1 - term) * (q +
      r) / 2 (G, q, term, out f32 [R]; term None: 0);
    - 'pi': act = tanh(mean * m + eps * m * exp(log_std)) on columns [0, A)
      (the mean) and [A, 2A) (the raw log-std through log_std_min/dif), eps
      a [N, S, >= A] view, m the amask row ([A], [N, A] or None: ones); into
      fdst (f32 [R, >= A]) when given and dst (bf16, zeros from A to dpad);
    - 'term': the sticky flag term = min(term + (logit > 0), 1), and term_at
      (int32 [R], or None) set to t + 1 where a row's flag is first set.
    """
    from tdmpc2_tpu_torch.models.layers import layer_norm, mish, simnorm
    from tdmpc2_tpu_torch.ops.value import _two_hot_dec, pi_action_plain
    ncols = row_width(mode, dims)
    R = y.shape[0]
    ys = y[:, :ncols].clone()
    for p in range(1, nsplit):
        ys += y[:, p * pstride:p * pstride + ncols]
    idx = torch.arange(R, device=y.device)
    env = idx // S
    if mode in ('hidden', 'latent'):
        if gain.dim() == 2:
            h = torch.zeros_like(env) if head is None else \
                head.long()[env].clamp(0, gain.shape[0] - 1)
            gain, beta = gain[h], beta[h]
        v = layer_norm(ys, gain, beta)
        v = mish(v) if mode == 'hidden' else simnorm(v, dims[5])
        dst[:, :ncols] = v.to(dst.dtype)
        dst[:, ncols:dpad] = 0
        if fdst is not None:
            fdst[:, :ncols] = v
    elif mode == 'pi':
        A = ncols // 2
        ls = log_std_min + 0.5 * log_std_dif * (torch.tanh(ys[:, A:]) + 1.0)
        m = 1.0 if amask is None else (amask[env] if amask.dim() == 2 else amask)
        act = pi_action_plain(ys[:, :A], ls, eps[env, idx % S, :A], m)
        if fdst is not None:
            fdst[:, :A] = act
        dst[:, :A] = act.to(dst.dtype)
        dst[:, A:dpad] = 0
    elif mode == 'term':
        hit = (ys[:, 0] > 0.0).float()
        if term_at is not None:
            term_at.copy_(torch.where((term == 0) & (hit != 0), t + 1, term_at))
        term.copy_(torch.clamp(term + hit, max=1.0))
    else:
        r = _two_hot_dec(ys, bins)[:, 0]
        keep = 1.0 - (term if term is not None else torch.zeros_like(r))
        if mode == 'reward':
            G += discs[env, t] * (keep * r)
        elif mode == 'q0':
            q.copy_(0.0 + r)
        else:
            out.copy_(G + discs[env, t] * (keep * ((q + r) / 2.0)))


def _ptr(x):
    return None if x is None else x.data_ptr()


def rows(mode, y, dims, S: int, *, nsplit: int = 1, pstride: int = 0, gain=None,
         beta=None, head=None, bins=None, dst=None, dpad: int = 0, fdst=None, G=None,
         q=None, term=None, term_at=None, discs=None, t: int = 0, out=None, eps=None,
         amask=None, log_std_min: float = 0.0, log_std_dif: float = 0.0):
    """One launch of the wide engine's row kernel on given operands (the
    library's `tdm_wide_rows`, as Wide::rows launches it after a product;
    no path calls it), for checks and timings; the arguments and the
    function are `rows_plain`'s, which it takes on CPU tensors. On the card
    y's rows and partial rows start on 16 bytes (y.stride(0), pstride: 4
    columns), dst's rows on 8 bytes; head int32; discs [N, > t] with unit
    inner stride. A y of row stride 0 (one row expanded, nsplit 1) has
    every row read from the same memory: a diagnostic of what the reads
    from device memory cost. Returns the launch's plan: threads a row, row
    groups a block, ring stages, shared bytes a block, blocks launched and
    the blocks the card holds at once (None on the CPU)."""
    kw = dict(nsplit=nsplit, pstride=pstride, gain=gain, beta=beta, head=head,
              bins=bins, dst=dst, dpad=dpad, fdst=fdst, G=G, q=q, term=term,
              term_at=term_at, discs=discs, t=t, out=out, eps=eps, amask=amask,
              log_std_min=log_std_min, log_std_dif=log_std_dif)
    if y.device.type == 'cpu':
        rows_plain(mode, y, dims, S, **kw)
        return None
    ncols = row_width(mode, dims)
    R = y.shape[0]
    width = (nsplit - 1) * pstride + -(-ncols // 4) * 4     # what a row's copy reads
    aligned = (y.dtype == torch.float32 and y.stride(1) == 1 and y.stride(0) % 4 == 0
               and y.data_ptr() % 16 == 0 and R % S == 0 and dpad % 4 == 0
               and 1 <= nsplit <= 8 and (nsplit == 1 or pstride % 4 == 0)
               and (width <= y.stride(0)
                    or (y.stride(0) == 0 and nsplit == 1 and width <= y.shape[1])))
    if dst is not None:
        aligned &= (dst.dtype == torch.bfloat16 and dst.stride(1) == 1
                    and dst.stride(0) % 4 == 0 and dst.data_ptr() % 8 == 0)
    if not aligned:
        raise ValueError(f'wide.rows: y {tuple(y.shape)} {y.dtype} (stride {y.stride()}), '
                         f'dst {None if dst is None else (tuple(dst.shape), dst.dtype)} do '
                         f'not fit mode {mode!r} at dims {tuple(dims)}')
    ptrs = (ctypes.c_void_p * 14)(
        _ptr(gain), _ptr(beta), _ptr(head), _ptr(bins), _ptr(dst), _ptr(fdst), _ptr(G),
        _ptr(q), _ptr(term), _ptr(term_at), _ptr(discs), _ptr(out), _ptr(eps),
        _ptr(amask))
    longs = (ctypes.c_long * 11)(
        0 if gain is None or gain.dim() == 1 else gain.stride(0),
        0 if head is None else head.stride(0),
        1 if gain is None or gain.dim() == 1 else gain.shape[0],
        dst.stride(0) if dst is not None else 0, dpad,
        fdst.stride(0) if fdst is not None else 0,
        discs.stride(0) if discs is not None else 0, t,
        eps.stride(0) if eps is not None else 0, eps.stride(1) if eps is not None else 0,
        amask.stride(0) if amask is not None and amask.dim() == 2 else 0)
    plan = (ctypes.c_int * 6)()
    n = counts()
    lib = _build.library('rollout')
    rc = lib.tdm_wide_rows(
        (ctypes.c_int * 7)(*dims), ROW_MODES.index(mode), R // S, S, y.data_ptr(),
        y.stride(0), nsplit, pstride, ptrs, longs, log_std_min, log_std_dif, plan, n,
        torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(lib, rc, 'wide row kernel', dims)
    rows.launches += n[2]
    keys = ('threads_a_row', 'row_groups', 'stages', 'smem_bytes', 'blocks', 'resident')
    return dict(zip(keys, plan))


rows.launches = 0


def stage_plain(dims, S: int, t: int, z0, mean, std, noise, pi_acts, amask, x, acts, *,
                load_z: bool = False, G=None, q=None, term=None, term_at=None, zb=None):
    """The plain version of one staging: step t's actions of N envs of S
    rows, `ops/value.py` sample_actions_plain's (mean, std [N, H*A]; noise
    [N, S, H*A]; pi_acts [N, n_pi, H*A]; amask [A] or [N, A]) at columns t*A
    to (t+1)*A, into acts [N, S, H*A] (f32) and the action columns of x
    [N*S, >= up16(L) + up16(A)] (bf16, zeros up to up16(A)); with load_z
    also G, q, term, term_at zeroed where given and z0 [N, S, L]: into the
    latent columns (zeros up to up16(L)), or folded (zb given: bf16 [N,
    up16(L)]; z0 one row an env, broadcast) each env's row 0 into its row of
    zb, x's latent columns untouched."""
    from tdmpc2_tpu_torch.ops.value import sample_actions_plain
    L, A = dims[0], dims[2]
    Lp, Ap = _up16(L), _up16(A)
    N = mean.shape[0]
    k = slice(t * A, (t + 1) * A)
    a = sample_actions_plain(mean, std, noise, pi_acts, amask)[..., k]
    acts[..., k] = a
    x[:, Lp:Lp + A] = a.reshape(N * S, A).to(x.dtype)
    x[:, Lp + A:Lp + Ap] = 0
    if load_z:
        if zb is not None:
            zb[:, :L] = z0[:, 0].to(zb.dtype)
            zb[:, L:Lp] = 0
        else:
            x[:, :L] = z0.expand(N, S, L).reshape(N * S, L).to(x.dtype)
            x[:, L:Lp] = 0
        for v in (G, q, term, term_at):
            if v is not None:
                v.zero_()


def stage(dims, S: int, t: int, z0, mean, std, noise, pi_acts, amask, x, acts, *,
          load_z: bool = False, G=None, q=None, term=None, term_at=None, zb=None):
    """One launch of the wide engine's staging on given operands (the
    library's `tdm_wide_stage`, as the sampled value step launches it at
    step t; no path calls it), for checks and timings; the arguments and
    the function are `stage_plain`'s, which it takes on CPU tensors. On the
    card: f32 operands with unit inner stride, noise's and pi_acts' rows H*A
    apart, acts contiguous, amask's rows contiguous; x bf16 with unit inner
    stride, its rows on 16 bytes; G, q, term f32 and term_at int32,
    contiguous [N*S]; folded, zb contiguous bf16 on 16 bytes, z0 of row
    stride 0."""
    kw = dict(load_z=load_z, G=G, q=q, term=term, term_at=term_at, zb=zb)
    if x.device.type == 'cpu':
        stage_plain(dims, S, t, z0, mean, std, noise, pi_acts, amask, x, acts, **kw)
        return
    L, A, H = dims[0], dims[2], dims[6]
    N, HA = mean.shape[0], H * A
    f32 = (z0, mean, std, noise, pi_acts, amask, acts)
    ok = (all(v.dtype == torch.float32 and v.stride(-1) == 1 for v in f32)
          and x.dtype == torch.bfloat16 and x.stride(1) == 1 and x.shape[0] == N * S
          and x.shape[1] >= _up16(L) + _up16(A) and acts.is_contiguous()
          and x.data_ptr() % 16 == 0 and x.stride(0) % 8 == 0
          and tuple(acts.shape) == (N, S, HA) and tuple(noise.shape) == (N, S, HA)
          and noise.stride(1) == HA and pi_acts.shape[1] <= S
          and (pi_acts.shape[1] == 0 or pi_acts.stride(1) == HA)
          and all(v is None or v.is_contiguous() for v in (G, q, term, term_at)))
    if zb is not None:
        ok &= (load_z and z0.stride(1) == 0 and zb.dtype == torch.bfloat16
               and zb.is_contiguous() and tuple(zb.shape) == (N, _up16(L))
               and zb.data_ptr() % 16 == 0)
    if not ok:
        raise ValueError(f'wide.stage: operands that do not fit dims {tuple(dims)} '
                         f'and {N} envs of {S} rows')
    n = counts()
    lib = _build.library('value')
    rc = lib.tdm_wide_stage(
        (ctypes.c_int * 7)(*dims), N, S, t, int(load_z), z0.data_ptr(), z0.stride(0),
        z0.stride(1), mean.data_ptr(), mean.stride(0), std.data_ptr(), std.stride(0),
        noise.data_ptr(), noise.stride(0), pi_acts.data_ptr(), pi_acts.stride(0),
        pi_acts.shape[1], acts.data_ptr(), amask.data_ptr(),
        amask.stride(0) if amask.dim() == 2 else 0, x.data_ptr(), x.stride(0),
        _ptr(G), _ptr(q), _ptr(term), _ptr(term_at), _ptr(zb), n,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, 'wide staging', dims)
    stage.launches += n[3]


stage.launches = 0
