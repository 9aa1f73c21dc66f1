"""Which engine the tensor-core kernels take, and the host side of the
layer-per-launch engine (csrc/mlp_wide.cuh).

The value kernel and the pi rollout have two engines. The row-tile engine
(csrc/mlp_rows.cuh) keeps a block's rows in shared memory for the whole
rollout and needs a layer's whole output row in one block's accumulators:
it takes widths up to 2048 columns (model_size 1 to 48). Above that
(model_size 317: mlp_dim 4096, latent 1376) the wide engine runs one
launch a layer: a tiled product over (column tile x row tile) blocks, then
a row kernel for what needs the whole row. The engine follows from the
widths alone (`engine`: the built library's own rule, `tdm_engine`);
nothing tries one engine and falls back to the other, and a width that
neither takes raises. The rollout kernel runs on the wide engine at every
width.

A wide call's intermediates live in scratch buffers that the wrapper
allocates per call (`Scratch`): the bf16 z||a rows, the bf16 hidden rows,
the f32 product and three per-row scalars. Inside the plan's CUDA graph
they come from the graph's pool, at fixed addresses.

`engine_launches.launches` counts the wide engine's device launches (the
wrappers count their calls, one a kernel): a value step is 13 launches a
horizon step (19 with the termination gate) + 18, a pi rollout 12 H - 5, a
rollout 13 H.
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


class LaunchCount:
    """A launch counter in the wrappers' form (`.launches`), which
    utils/cuda_graph.Graph counts through a capture and adds at each
    replay."""

    def __init__(self):
        self.launches = 0


engine_launches = LaunchCount()


def value_launches(horizon: int, episodic: bool) -> int:
    """Device launches of one wide value step: per horizon step the staging
    and a product and a row kernel for each of the reward's and the
    dynamics' three layers (and the termination head's), then the policy's
    three layers and the two Q heads' six."""
    return horizon * (19 if episodic else 13) + 18


def pi_rollout_launches(horizon: int) -> int:
    return 12 * horizon - 5


def rollout_launches(horizon: int) -> int:
    return 13 * horizon


def plan_launches(horizon: int, iterations: int, episodic: bool) -> int:
    """The wide engine's device launches of one plan: the pi rollout and
    `iterations` value steps (the elite kernel's launches apart)."""
    return (pi_rollout_launches(horizon)
            + iterations * value_launches(horizon, episodic))


def _up16(n: int) -> int:
    return -(-n // 16) * 16


class Scratch:
    """One wide call's device buffers for R rows at dims: x (bf16 z||a
    rows), h (bf16 hidden rows), y (f32 product rows, as wide as the widest
    layer), and the per-row G, q, term (f32); `ptrs` and `lds` are the
    kernels' arguments."""

    def __init__(self, R: int, dims, device):
        L, M, A, B = dims[:4]
        Lp, Ap, Mp = _up16(L), _up16(A), _up16(M)
        ldy = max(Mp, Lp, _up16(B), _up16(2 * A))
        self.x = torch.empty(R, Lp + Ap, dtype=torch.bfloat16, device=device)
        self.h = torch.empty(R, Mp, dtype=torch.bfloat16, device=device)
        self.y = torch.empty(R, ldy, dtype=torch.float32, device=device)
        self.s = torch.empty(3, R, dtype=torch.float32, device=device)
        self.ptrs = (ctypes.c_void_p * 6)(
            self.x.data_ptr(), self.h.data_ptr(), self.y.data_ptr(),
            *(self.s[i].data_ptr() for i in range(3)))
        self.lds = (ctypes.c_long * 3)(Lp + Ap, Mp, ldy)
