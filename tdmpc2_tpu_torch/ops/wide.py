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
the f32 product and three per-row scalars. Inside the plan's CUDA graph
they come from the graph's pool, at fixed addresses, so the tensor maps
captured with the launches stay valid.

`engine_launches.launches` counts the wide engine's device launches and
`gemm_launches`, `row_launches` and `stage_launches` the products, row
kernels and stagings among them, each counted by the library where it
launches that kernel (the wrappers count their calls, one a kernel): a
value step is 13 launches a horizon step (19 with the termination gate) +
18, 6 (9) and 9 of them products, as many row kernels, a staging a step;
a pi rollout 12 H - 5, 6 H - 3 products and as many row kernels, one
staging; a rollout 13 H, 6 H products and row kernels, H stagings. `gemm`
launches one product on given operands (the library's `tdm_wide_gemm`),
for checks and timings; no path calls it.
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
COUNTERS = (engine_launches, gemm_launches, row_launches, stage_launches)


def counts():
    """The array a wide call's library entry fills (`launched` [4]: its
    launches, then the products, row kernels and stagings among them)."""
    return (ctypes.c_int * len(COUNTERS))()


def count(n) -> None:
    """Add a wide call's counts (`counts`) to the counters."""
    for c, k in zip(COUNTERS, n):
        c.launches += k


def value_launches(horizon: int, episodic: bool) -> int:
    """Device launches of one wide value step: per horizon step the staging
    and a product and a row kernel for each of the reward's and the
    dynamics' three layers (and the termination head's), then the policy's
    three layers and the two Q heads' six."""
    return horizon * (19 if episodic else 13) + 18


def value_products(horizon: int, episodic: bool) -> int:
    return horizon * (9 if episodic else 6) + 9


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


class Scratch:
    """One wide call's device buffers for R rows at dims: x (bf16 z||a
    rows), h (bf16 hidden rows), y (f32 product rows, as wide as the widest
    layer), and the per-row G, q, term (f32); `ptrs` and `lds` are the
    kernels' arguments."""

    def __init__(self, R: int, dims, device):
        L, M, A, B = dims[:4]
        Lp, Ap, Mp = _up16(L), _up16(A), _up16(M)
        ldy = y_width(dims)
        self.x = torch.empty(R, Lp + Ap, dtype=torch.bfloat16, device=device)
        self.h = torch.empty(R, Mp, dtype=torch.bfloat16, device=device)
        self.y = torch.empty(R, ldy, dtype=torch.float32, device=device)
        self.s = torch.empty(3, R, dtype=torch.float32, device=device)
        self.ptrs = (ctypes.c_void_p * 6)(
            self.x.data_ptr(), self.h.data_ptr(), self.y.data_ptr(),
            *(self.s[i].data_ptr() for i in range(3)))
        self.lds = (ctypes.c_long * 3)(Lp + Ap, Mp, ldy)


def gemm(x, w, bias, dims, S: int, *, b1=None, split: int = -1, task=None,
         ntask: int = 1, head=None, hn: int = 1, bt: int = 0, bh: int = 0,
         out=None):
    """One product of the wide engine on given CUDA operands (the library's
    `tdm_wide_gemm`; no path calls it): y = x[:, :K] @ W + bias for the
    model dims `dims` (its tile) and N envs of S rows. x [N*S, >= K] bf16
    with contiguous rows (K = w's last dim, a multiple of 16); w the wide
    layout [ncols, K] or [heads, ncols, K] bf16 (heads with `head`, int32,
    env e's head at head[e * hn]); bias f32, column c of env e at bias[task
    * bt + head * bh + c] (from column `split` on, b1[c - split]); task
    int32 [N] or None, of `ntask` tasks; K split as the engine's rule
    gives it. `out`, a contiguous f32 [N*S, ldy] tensor, receives y (None: a
    new one, NaN where the kernel writes nothing). Returns (y as the kernel
    wrote it, the plan: tile, splits, pstride, grid); `gemm_sum` adds the
    partial rows."""
    if x.device.type != 'cuda':
        raise ValueError(f'wide.gemm: unsupported device {x.device}')
    K, ncols = w.shape[-1], w.shape[-2]
    R = x.shape[0]
    if (x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or x.stride(1) != 1
            or not w.is_contiguous() or x.shape[1] < K or K % 16 or R % S
            or bias.dtype != torch.float32):
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
        w.data_ptr(), ncols, bias.data_ptr(), bt, bh,
        None if b1 is None else b1.data_ptr(), split,
        None if task is None else task.data_ptr(), ntask,
        None if head is None else head.data_ptr(), hn, y.data_ptr(), y.shape[1],
        plan, n, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, 'wide product', dims)
    gemm.launches += n[1]
    keys = ('bm', 'bn', 'wgs', 'splits', 'kchunk', 'pstride')
    return y, dict(zip(keys, plan[:6]), grid=tuple(plan[6:9]), blocks=plan[9])


gemm.launches = 0


def gemm_sum(y, plan, ncols: int):
    """The product's [R, ncols] columns from the rows `gemm` wrote: its
    partial rows added in order, as the row kernel adds them."""
    out = y[:, :ncols].clone()
    for p in range(1, plan['splits']):
        out += y[:, p * plan['pstride']:p * plan['pstride'] + ncols]
    return out
