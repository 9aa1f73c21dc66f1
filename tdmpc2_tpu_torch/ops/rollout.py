"""Reward+dynamics rollout: the port of the TPU kernel `_rollout_kernel`
(tdmpc2_tpu/ops/pallas_rollout.py:50, entries `rollout_prepared` :149 and
`fused_value_rollout` :203), single-task.

For S action sequences of length H it returns the discounted model return
and the final latent,

    G = sum_t discount^t * r(z_t, a_t),   z_{t+1} = next(z_t, a_t)
    -> (G [S, 1], z_H [S, L])

`rollout_prepared` runs the hand-written kernel `csrc/rollout.cu` on CUDA
tensors and `rollout_prepared_plain` on CPU tensors; any other device
raises. The kernel runs on the layer-per-launch engine (csrc/mlp_wide.cuh,
ops/wide.py) at every width: 13 launches a step. The weights are laid out by `prepare_rollout_params` as for the
value step (ops/value.py): the first layers split into latent and action
rows. As there, SimNorm is a grouped softmax computed per group: the TPU
kernel's block-diagonal mask product is not carried over, so no group mask
is prepared. The kernel reads the packed copies of a bf16 prep, rounds
every dot input to bf16 and accumulates in f32; the plain version rounds
at the same places, to the weights' dtype.
"""

from __future__ import annotations

import ctypes

import torch

from tdmpc2_tpu_torch.ops import _build, wide
# The rollout is the value step's first part: its weight prep and plain
# version live in ops/value.py, which builds on them.
from tdmpc2_tpu_torch.ops.value import (ROLLOUT_KERNEL_NAMES, check_prep,
                                        prepare_rollout_params, rollout_plain,
                                        weight_ptrs)


def _discs(discount: float, horizon: int, device) -> torch.Tensor:
    # discount^t in f64 rounded once to f32, as the TPU kernel's running
    # product of Python floats; made on the device, so no host copy (which
    # would synchronise the stream) precedes the launch
    return (discount ** torch.arange(horizon, dtype=torch.float64,
                                     device=device)).float()


def rollout_prepared_plain(prep, z0, actions, *, horizon: int,
                           discount: float, simnorm_dim: int = 8):
    """z0 [S, L]; actions [H, S, A] -> (G [S, 1], z_H [S, L]), in torch ops."""
    return rollout_plain(prep, z0, actions[:horizon],
                         _discs(discount, horizon, z0.device), simnorm_dim)


def rollout_prepared(prep, z0, actions, *, horizon: int, discount: float,
                     simnorm_dim: int = 8):
    """The rollout kernel on CUDA tensors, its plain version on CPU tensors.

    z0 [S, L] f32 (rows may be a broadcast view, stride 0); actions
    [H, S, A] f32 with unit stride on A -> (G [S, 1], z_H [S, L]) f32.
    """
    dev = z0.device
    if dev.type == 'cpu':
        return rollout_prepared_plain(prep, z0, actions, horizon=horizon,
                                      discount=discount,
                                      simnorm_dim=simnorm_dim)
    if dev.type != 'cuda':
        raise ValueError(f'rollout_prepared: unsupported device {dev}')
    check_prep(prep, dev, simnorm_dim, ROLLOUT_KERNEL_NAMES)
    L, M = prep['dWz'].shape
    A, B = prep['dWa'].shape[0], prep['rW2'].shape[1]
    if (horizon < 1 or actions.dim() != 3 or actions.shape[0] < horizon
            or actions.shape[2] != A):
        raise ValueError(f'rollout_prepared: actions {tuple(actions.shape)} '
                         f'do not give {horizon} steps of A={A}')
    S = actions.shape[1]
    if (z0.shape != (S, L) or z0.stride(1) != 1 or actions.stride(2) != 1
            or z0.dtype != torch.float32 or actions.dtype != torch.float32
            or actions.device != dev):
        raise ValueError(f'rollout_prepared: z0 {tuple(z0.shape)} / actions '
                         f'{tuple(actions.shape)} must be f32 on {dev} with '
                         f'unit inner stride and L={L}')
    dims = (ctypes.c_int * 7)(L, M, A, B, 0, simnorm_dim, horizon)
    discs = _discs(discount, horizon, dev)
    G = torch.empty(S, 1, dtype=torch.float32, device=dev)
    zH = torch.empty(S, L, dtype=torch.float32, device=dev)
    lib = _build.library('rollout')
    sc, n = wide.Scratch(S, tuple(dims), dev), wide.counts()
    rc = lib.tdm_rollout(
        weight_ptrs(prep, 'wide'), dims, S, z0.data_ptr(), z0.stride(0),
        actions.data_ptr(), actions.stride(0), actions.stride(1),
        discs.data_ptr(), G.data_ptr(), zH.data_ptr(), sc.ptrs, sc.lds,
        n, torch.cuda.current_stream(dev).cuda_stream)
    wide.count(n)
    _build.check(lib, rc, 'rollout kernel', dims)
    rollout_prepared.launches += 1
    return G, zH


rollout_prepared.launches = 0


def fused_value_rollout(dyn, rew, z0, actions, *, horizon: int,
                        discount: float, simnorm_dim: int, vmin: float,
                        vmax: float, dot_dtype=torch.bfloat16):
    """Prepare the weights and run `rollout_prepared` (the JAX entry's
    arguments, without its interpret flag). dyn/rew: 3-layer MLP parameter
    tuples (models/layers.mlp_init layout); z0 [S, L]; actions [H, S, A]."""
    prep = prepare_rollout_params(dyn, rew, z0.shape[-1], vmin, vmax,
                                  dot_dtype)
    return rollout_prepared(prep, z0, actions, horizon=horizon,
                            discount=discount, simnorm_dim=simnorm_dim)


def fused_value_rollout_plain(dyn, rew, z0, actions, *, horizon: int,
                              discount: float, simnorm_dim: int, vmin: float,
                              vmax: float, dot_dtype=torch.float32):
    """`fused_value_rollout` through the plain version, on any device."""
    prep = prepare_rollout_params(dyn, rew, z0.shape[-1], vmin, vmax,
                                  dot_dtype)
    return rollout_prepared_plain(prep, z0, actions, horizon=horizon,
                                  discount=discount, simnorm_dim=simnorm_dim)
