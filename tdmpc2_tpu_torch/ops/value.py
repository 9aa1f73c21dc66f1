"""Planner value estimate: the port of the TPU kernel `_value_kernel`
(tdmpc2_tpu/ops/pallas_rollout.py:437, entry `value_prepared` :688) and of
its weight prep `prepare_value_params` (:538-632), single-task, for N
environments at once (the TPU kernel's env axis, `_value_flat` :635).

`value_estimate` runs the hand-written kernel `csrc/value.cu` on CUDA
tensors and `value_estimate_plain` on CPU tensors; on any other device it
raises. Both compute, for each env's S sampled action sequences of
length H,

    G = sum_t discs[t] * r(z_t, a_t),  z_{t+1} = next(z_t, a_t)
    v = G + discs[H] * avg_{i in qidx} Q_i(z_H, tanh(mean + eps * exp(log_std)))

with the weights as `prepare_value_params` laid them out: every first
layer split into its latent and action rows, the pi head split into mean
and log-std columns, the Q heads stacked. The TPU kernel's block-diagonal
mask product for SimNorm is not carried over: the grouped softmax is
computed directly.
"""

from __future__ import annotations

import ctypes

import torch

from tdmpc2_tpu_torch.models.layers import layer_norm, mish, simnorm
from tdmpc2_tpu_torch.ops import _build

# Operand order of the prepared weights; csrc/mlp_rows.cuh's WeightIndex
# follows it.
PREP_NAMES = (
    'dWz', 'dWa', 'db0', 'dg0', 'de0', 'dW1', 'db1', 'dg1', 'de1',
    'dW2', 'db2', 'dg2', 'de2',
    'rWz', 'rWa', 'rb0', 'rg0', 're0', 'rW1', 'rb1', 'rg1', 're1',
    'rW2', 'rb2',
    'pW0', 'pb0', 'pg0', 'pe0', 'pW1', 'pb1', 'pg1', 'pe1',
    'pWm', 'pbm', 'pWl', 'pbl',
    'qWz', 'qWa', 'qb0', 'qg0', 'qe0', 'qW1', 'qb1', 'qg1', 'qe1',
    'qW2', 'qb2',
    'bins',
)


# The reward+dynamics operands (and `bins`), all that the rollout kernel
# reads (ops/rollout.py).
ROLLOUT_NAMES = tuple(k for k in PREP_NAMES if k[0] in 'dr') + ('bins',)


def _casts(dot_dtype):
    def w(x):
        return x.to(dot_dtype).contiguous()

    def f(x):
        return x.float().contiguous()
    return w, f


def prepare_rollout_params(dyn, rew, latent_dim: int, vmin: float,
                           vmax: float, dot_dtype=torch.bfloat16) -> dict:
    """The rollout's operands (keys ROLLOUT_NAMES) from the dynamics and
    reward MLP parameter tuples: each first layer split into its latent and
    action rows, matrices in `dot_dtype` (bf16 for the kernels, f32 for an
    exact plain reference), the rest f32, all contiguous."""
    L = latent_dim
    w, f = _casts(dot_dtype)
    B = rew[2]['w'].shape[-1]
    return {
        'dWz': w(dyn[0]['w'][:L]), 'dWa': w(dyn[0]['w'][L:]),
        'db0': f(dyn[0]['b']), 'dg0': f(dyn[0]['ln_w']), 'de0': f(dyn[0]['ln_b']),
        'dW1': w(dyn[1]['w']), 'db1': f(dyn[1]['b']),
        'dg1': f(dyn[1]['ln_w']), 'de1': f(dyn[1]['ln_b']),
        'dW2': w(dyn[2]['w']), 'db2': f(dyn[2]['b']),
        'dg2': f(dyn[2]['ln_w']), 'de2': f(dyn[2]['ln_b']),
        'rWz': w(rew[0]['w'][:L]), 'rWa': w(rew[0]['w'][L:]),
        'rb0': f(rew[0]['b']), 'rg0': f(rew[0]['ln_w']), 're0': f(rew[0]['ln_b']),
        'rW1': w(rew[1]['w']), 'rb1': f(rew[1]['b']),
        'rg1': f(rew[1]['ln_w']), 're1': f(rew[1]['ln_b']),
        'rW2': w(rew[2]['w']), 'rb2': f(rew[2]['b']),
        'bins': torch.linspace(vmin, vmax, B, dtype=torch.float32,
                               device=dyn[0]['w'].device),
    }


def prepare_value_params(params, cfg, dot_dtype=torch.bfloat16) -> dict:
    """Slice and cast the value step's operands once per set of weights.

    Matrices go to `dot_dtype` (bf16 for the kernel; f32 gives the exact
    plain reference), everything else stays f32; all contiguous, on the
    params' device. Keys are PREP_NAMES.
    """
    L, A = cfg.latent_dim, cfg.action_dim
    pi, qs = params['pi'], params['Qs']
    w, f = _casts(dot_dtype)
    prep = prepare_rollout_params(params['dynamics'], params['reward'], L,
                                  cfg.vmin, cfg.vmax, dot_dtype)
    prep.update({
        'pW0': w(pi[0]['w']), 'pb0': f(pi[0]['b']),
        'pg0': f(pi[0]['ln_w']), 'pe0': f(pi[0]['ln_b']),
        'pW1': w(pi[1]['w']), 'pb1': f(pi[1]['b']),
        'pg1': f(pi[1]['ln_w']), 'pe1': f(pi[1]['ln_b']),
        'pWm': w(pi[2]['w'][:, :A]), 'pbm': f(pi[2]['b'][:A]),
        'pWl': w(pi[2]['w'][:, A:]), 'pbl': f(pi[2]['b'][A:]),
        'qWz': w(qs[0]['w'][:, :L]), 'qWa': w(qs[0]['w'][:, L:]),
        'qb0': f(qs[0]['b']), 'qg0': f(qs[0]['ln_w']), 'qe0': f(qs[0]['ln_b']),
        'qW1': w(qs[1]['w']), 'qb1': f(qs[1]['b']),
        'qg1': f(qs[1]['ln_w']), 'qe1': f(qs[1]['ln_b']),
        'qW2': w(qs[2]['w']), 'qb2': f(qs[2]['b']),
    })
    return {k: prep[k] for k in PREP_NAMES}


def prep_dims(prep, simnorm_dim: int, horizon: int) -> tuple:
    """(L, M, A, B, NQ, G, H), the order of csrc/mlp_rows.cuh's Dims."""
    L, M = prep['dWz'].shape
    return (L, M, prep['dWa'].shape[0], prep['rW2'].shape[1],
            prep['qWz'].shape[0], simnorm_dim, horizon)


def check_prep(prep, device, simnorm_dim: int, names=PREP_NAMES):
    """Validate prepared weights `names` for the kernels: device, dtype,
    layout."""
    for k in names:
        t = prep[k]
        want = torch.bfloat16 if k[1] == 'W' else torch.float32
        if t.device != device or t.dtype != want or not t.is_contiguous():
            raise ValueError(
                f'prepared weight {k}: need a contiguous {want} tensor on '
                f'{device}, got {t.dtype} on {t.device}')
    if prep['dWz'].shape[0] % simnorm_dim:
        raise ValueError('latent_dim must be a multiple of simnorm_dim')


def weight_ptrs(prep):
    """Pointers in PREP_NAMES order; a name `prep` lacks is null."""
    return (ctypes.c_void_p * len(PREP_NAMES))(
        *[prep[k].data_ptr() if k in prep else None for k in PREP_NAMES])


# ---------------------------------------------------------------------------
# Plain version: the same arithmetic in torch ops.
# ---------------------------------------------------------------------------


def _dot(x, w):
    """x @ w with x rounded to w's dtype and f32 accumulation."""
    return x.to(w.dtype).float() @ w.float()


def _two_hot_dec(logits, bins):
    m = logits.max(dim=-1, keepdim=True).values
    e = torch.exp(logits - m)
    x = (e * bins).sum(-1, keepdim=True) / e.sum(-1, keepdim=True)
    return torch.sign(x) * torch.expm1(torch.abs(x))


def _hidden2(x, p, pre):
    """Two NormedLinear+Mish layers of head `pre` ('d', 'r', 'p', 'q').
    The first layer's product (without its bias) is given as `x`."""
    def g(name):
        return p[pre + name]
    u = mish(layer_norm(x + g('b0'), g('g0'), g('e0')))
    u = _dot(u, g('W1')) + g('b1')
    return mish(layer_norm(u, g('g1'), g('e1')))


def dynamics_plain(p, z, a, simnorm_dim: int):
    u = _hidden2(_dot(z, p['dWz']) + _dot(a, p['dWa']), p, 'd')
    u = layer_norm(_dot(u, p['dW2']) + p['db2'], p['dg2'], p['de2'])
    return simnorm(u, simnorm_dim)


def pi_head_plain(p, z, log_std_min: float, log_std_dif: float):
    """(mean, log_std) of the policy prior on z."""
    u = _hidden2(_dot(z, p['pW0']), p, 'p')
    mean = _dot(u, p['pWm']) + p['pbm']
    ls = _dot(u, p['pWl']) + p['pbl']
    return mean, log_std_min + 0.5 * log_std_dif * (torch.tanh(ls) + 1.0)


def rollout_plain(prep, z0, actions, discs, simnorm_dim: int = 8):
    """The reward+dynamics rollout: z0 [S, L]; actions [H, S, A]; discs
    [>= H] -> (G [S, 1], z_H [S, L]), G = sum_t discs[t] * r(z_t, a_t).
    Leading axes of z0 and actions[t] broadcast (value_estimate_plain
    passes N envs' rows, with discs[t] shaped to match)."""
    p = prep
    z = z0.float()
    G = torch.zeros(z.shape[:-1] + (1,), dtype=torch.float32, device=z.device)
    for t in range(actions.shape[0]):
        a = actions[t]
        u = _hidden2(_dot(z, p['rWz']) + _dot(a, p['rWa']), p, 'r')
        G = G + discs[t] * _two_hot_dec(_dot(u, p['rW2']) + p['rb2'], p['bins'])
        z = dynamics_plain(p, z, a, simnorm_dim)
    return G, z


def value_estimate_plain(prep, z0, actions, eps, qidx, discs, *,
                         log_std_min: float, log_std_dif: float,
                         simnorm_dim: int = 8, episodic: bool = False):
    """z0 [N, S, L]; actions [N, H, S, A]; eps [N, S, A]; qidx [N, 2] int;
    discs [N, H+1] -> value [N, S, 1], each env with its own Q heads and
    discounts (N=1 for one env)."""
    if episodic:
        raise NotImplementedError('episodic value estimate (termination head)')
    p = prep
    H = actions.shape[1]
    G, z = rollout_plain(p, z0, actions.transpose(0, 1), discs.T[..., None, None],
                         simnorm_dim)
    mean, ls = pi_head_plain(p, z, log_std_min, log_std_dif)
    a = torch.tanh(mean + eps * torch.exp(ls))
    q = 0.0
    for j in range(2):
        # each env's head, picked on the device (no host read of qidx):
        # matrices [N, K, M], vectors [N, 1, M]
        i = qidx[:, j].long()
        h = {k: torch.index_select(p[k], 0, i) for k in PREP_NAMES if k[0] == 'q'}
        h = {k: v if k[1] == 'W' else v[:, None] for k, v in h.items()}
        u = _hidden2(_dot(z, h['qWz']) + _dot(a, h['qWa']), h, 'q')
        q = q + _two_hot_dec(_dot(u, h['qW2']) + h['qb2'], p['bins'])
    return G + discs[:, H, None, None] * (q / 2.0)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def value_estimate(prep, z0, actions, eps, qidx, discs, *,
                   log_std_min: float, log_std_dif: float,
                   simnorm_dim: int = 8, episodic: bool = False):
    """The value kernel on CUDA tensors, its plain version on CPU tensors.

    N envs in one launch (N=1 for one env): z0 [N, S, L] f32; actions
    [N, H, S, A] f32; eps [N, S, A] f32; qidx [N, 2] int32; discs [N, H+1]
    f32 -> value [N, S, 1] f32. Any strides on the env and row axes (the
    planner passes a broadcast latent, stride 0, and permuted or strided
    views of its samples and noise); unit stride on the last axis, and eps
    rows contiguous.
    """
    if episodic:
        raise NotImplementedError('episodic value estimate (termination head)')
    dev = z0.device
    if dev.type == 'cpu':
        return value_estimate_plain(
            prep, z0, actions, eps, qidx, discs, log_std_min=log_std_min,
            log_std_dif=log_std_dif, simnorm_dim=simnorm_dim)
    if dev.type != 'cuda':
        raise ValueError(f'value_estimate: unsupported device {dev}')
    check_prep(prep, dev, simnorm_dim)
    if actions.dim() != 4:
        raise ValueError(f'value_estimate: actions {tuple(actions.shape)} '
                         'must be [N, H, S, A] with z0 [N, S, L]')
    N, H, S, A = actions.shape
    L = prep['dWz'].shape[0]
    if (z0.shape != (N, S, L) or z0.stride(2) != 1 or actions.stride(3) != 1
            or prep['dWa'].shape[0] != A):
        raise ValueError(f'value_estimate: z0 {tuple(z0.shape)} / actions '
                         f'{tuple(actions.shape)} do not fit the weights '
                         f'(L={L}, A={prep["dWa"].shape[0]}) with unit inner stride')
    for name, t, shape, dtype, inner in (
            ('eps', eps, (N, S, A), torch.float32, (A, 1)),
            ('qidx', qidx, (N, 2), torch.int32, (1,)),
            ('discs', discs, (N, H + 1), torch.float32, (1,))):
        if (t.device != dev or tuple(t.shape) != shape or t.dtype != dtype
                or t.stride()[1:] != inner):
            raise ValueError(f'value_estimate: {name} must be a {dtype} '
                             f'{shape} tensor on {dev}, contiguous after the '
                             'env axis')
    for t in (z0, actions):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError('value_estimate: z0/actions must be f32 on the '
                             'weights\' device')
    out = torch.empty(N, S, 1, dtype=torch.float32, device=dev)
    lib = _build.library('value')
    dims = (ctypes.c_int * 7)(*prep_dims(prep, simnorm_dim, H))
    rc = lib.tdm_value(
        weight_ptrs(prep), dims, log_std_min, log_std_dif, N, S,
        z0.data_ptr(), z0.stride(0), z0.stride(1),
        actions.data_ptr(), actions.stride(0), actions.stride(1),
        actions.stride(2), eps.data_ptr(), eps.stride(0), qidx.data_ptr(),
        qidx.stride(0), discs.data_ptr(), discs.stride(0), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, 'value kernel')
    value_estimate.launches += 1
    return out


value_estimate.launches = 0
