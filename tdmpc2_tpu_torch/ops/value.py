"""Planner value estimate: the port of the TPU kernel `_value_kernel`
(tdmpc2_tpu/ops/pallas_rollout.py:437, entry `value_prepared` :688) and of
its weight prep `prepare_value_params` (:538-632), for N environments at
once (the TPU kernel's env axis, `_value_flat` :635), single- and
multi-task.

`value_estimate` runs the hand-written kernel `csrc/value.cu` on CUDA
tensors and `value_estimate_plain` on CPU tensors; on any other device it
raises. Both compute, for each env's S sampled action sequences of
length H,

    G = sum_t discs[t] * (1 - term_t) * r(z_t, a_t),  z_{t+1} = next(z_t, a_t)
    v = G + discs[H] * (1 - term_H) * avg_{i in qidx} Q_i(z_H, tanh(mean + eps * exp(log_std)))

with the weights as `prepare_value_params` laid them out: every first
layer split into its latent and action rows, the pi head split into mean
and log-std columns, the Q heads stacked. On episodic tasks the sticky
termination flag starts at term_0 = 0 and after each dynamics step
becomes term_{t+1} = min(term_t + (logit(z_{t+1}) > 0), 1), the
termination head's logit on the new latent (pallas_rollout.py:503-510);
otherwise term stays 0. The TPU kernel's block-diagonal mask product for
SimNorm is not carried over: the grouped softmax is computed directly.

Task axis. A multi-task model concatenates a task embedding to the input
of every head. The embedding is constant for a task, so the prep folds its
product into the first-layer bias of the dynamics, reward, termination,
pi and every Q head, as the JAX prep does for one task (`fold`,
pallas_rollout.py:575-588), but for all tasks at once: each such bias is a
table with a row per task, [tasks, M] ([tasks, num_q, M] for the Q heads),
and the matrices keep only their latent and action rows, shared by every
task. The wrappers take an int32 task id per env (`task` [N]; None: task 0)
and an action mask per env (`amask` [N, A], or [A] for every env). Where
the JAX prep folds the mask into the pi mean head's columns, the port
multiplies the head's mean and eps by it (exact for a mask of 0s and 1s:
the masked action is 0 either way, at most its sign differs). A
single-task model is the one-row table, task 0, with a mask of ones.

`value_sampled` is the planner's step: the same value, on actions that the
kernel samples where it stages them, as the TPU kernel `_cem_kernel`
(tdmpc2_tpu/ops/pallas_cem.py:136-147) does in the program that rolls them
out,

    a[s, t*A + c] = (s < n_pi ? pi_acts[s, t*A + c]
                     : clip(mean[t*A + c] + std[t*A + c] * noise[s, t*A + c], -1, 1)) * amask[c]

returning the actions too, for the elite step. Its plain version is
`sample_actions_plain` followed by `value_estimate_plain`.

Two engines run the kernel (ops/wide.py `engine`, from the widths alone):
the row-tile engine up to 2048 columns (model_size 1 to 48), and above it
(model_size 317) the layer-per-launch engine of csrc/mlp_wide.cuh; the
rollout kernel runs on the wide engine at every width. Each reads the
matrices in a layout of its own, which the prep adds for bf16 weights
(`_add_layouts`): the row tiles a fragment-packed copy (`pack_matrix`,
PACKED: zero-padded to multiples of 16 and laid out in the order of the
mma fragments they load, csrc/mlp_rows.cuh), the wide engine a transposed
copy read through TMA tensor maps (`wide_matrix`, WIDE: [N, K] with K
contiguous). A prep holds the packed copies only where the row tiles take
the widths (on the card the built library says which, ops/wide.py
`engine`), and the wide copies of the dynamics and reward (the rollout's)
at every width and of every matrix where the row tiles do not take them:
at model_size 317 no packed copy, at the 5M model the dynamics and reward
in both layouts. Both engines read the same per-task bias tables. The
plain versions read the [in, out] matrices.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tdmpc2_tpu_torch.models.layers import layer_norm, mish, simnorm
from tdmpc2_tpu_torch.ops import _build, wide

# The prepared weights the plain versions read.
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
    # the termination head, episodic tasks only (last, so that the indices
    # above stay those of every kernel)
    'tW0', 'tb0', 'tg0', 'te0', 'tW1', 'tb1', 'tg1', 'te1', 'tW2', 'tb2',
)

# Operand order of the kernels: packed matrices (xP*) and f32 vectors;
# csrc/mlp_rows.cuh's Op follows it. The termination head's come last.
KERNEL_NAMES = (
    'dP0', 'db0', 'dg0', 'de0', 'dP1', 'db1', 'dg1', 'de1',
    'dP2', 'db2', 'dg2', 'de2',
    'rP0', 'rb0', 'rg0', 're0', 'rP1', 'rb1', 'rg1', 're1', 'rP2', 'rb2',
    'pP0', 'pb0', 'pg0', 'pe0', 'pP1', 'pb1', 'pg1', 'pe1', 'pP2', 'pbm',
    'pbl',
    'qP0', 'qb0', 'qg0', 'qe0', 'qP1', 'qb1', 'qg1', 'qe1', 'qP2', 'qb2',
    'bins',
    'tP0', 'tb0', 'tg0', 'te0', 'tP1', 'tb1', 'tg1', 'te1', 'tP2', 'tb2',
)

# Each packed matrix and the [in, out] matrices it is made of, stacked
# along K (the z||a first layers) or, for the pi head's mean and log-std
# columns, along N.
PACKED = {
    'dP0': ('dWz', 'dWa'), 'dP1': ('dW1',), 'dP2': ('dW2',),
    'rP0': ('rWz', 'rWa'), 'rP1': ('rW1',), 'rP2': ('rW2',),
    'pP0': ('pW0',), 'pP1': ('pW1',), 'pP2': ('pWm', 'pWl'),
    'qP0': ('qWz', 'qWa'), 'qP1': ('qW1',), 'qP2': ('qW2',),
    'tP0': ('tW0',), 'tP1': ('tW1',), 'tP2': ('tW2',),
}


def _wide_name(k: str) -> str:
    """The wide engine's name of a kernel operand: xT* for a packed xP*."""
    return k[0] + 'T' + k[2:] if k[1] == 'P' else k


# The wide engine's copy of each packed matrix (`wide_matrix`), of the same
# [in, out] matrices.
WIDE = {_wide_name(k): parts for k, parts in PACKED.items()}

# The termination head's weights (episodic tasks only).
TERM_NAMES = tuple(k for k in PREP_NAMES if k[0] == 't')


# The reward+dynamics operands (and `bins`), all that the rollout reads
# (ops/rollout.py): the plain version's and the kernel's.
ROLLOUT_NAMES = tuple(k for k in PREP_NAMES if k[0] in 'dr') + ('bins',)


def kernel_names(route: str, names=KERNEL_NAMES) -> tuple:
    """The operands `names` as the engine `route` reads them: the packed
    matrices on the row tiles ('rows'), their wide copies on 'wide'."""
    return tuple(names) if route == 'rows' else tuple(_wide_name(k) for k in names)


# The rollout's operands: it runs on the wide engine at every width.
ROLLOUT_KERNEL_NAMES = kernel_names(
    'wide', tuple(k for k in KERNEL_NAMES if k[0] in 'dr') + ('bins',))


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def pack_matrix(*blocks, cat_dim: int = -2):
    """The kernels' copy of a matrix given as blocks [..., K_i, N_i]
    stacked along K (cat_dim=-2, each block's rows zero-padded to a
    multiple of 16: the latent rows, then the action rows of a z||a
    layer) or along N (cat_dim=-1). N is zero-padded to a multiple of 16,
    and the result is flat in the order the kernels load it
    (csrc/mlp_rows.cuh): for each 16-row k-tile kt and 16-column pair p,
    32 lanes l = 4g + q of 8 values, value 4t + 2r + h being
    W[16kt + 8r + 2q + h, 16p + 8t + g] (the mma B fragments of the pair's
    two 8-column tiles). Leading axes (the stacked Q heads) stay."""
    if cat_dim == -2:
        W = torch.cat([F.pad(b, (0, 0, 0, _up16(b.shape[-2]) - b.shape[-2]))
                       for b in blocks], dim=-2)
    else:
        W = torch.cat(blocks, dim=-1)
        W = F.pad(W, (0, 0, 0, _up16(W.shape[-2]) - W.shape[-2]))
    W = F.pad(W, (0, _up16(W.shape[-1]) - W.shape[-1]))
    lead, (Kp, Np) = W.shape[:-2], W.shape[-2:]
    n = len(lead)
    # k = 16 kt + 8 r + 2 q + h, n = 16 p + 8 t + g
    W = W.reshape(*lead, Kp // 16, 2, 4, 2, Np // 16, 2, 8)
    order = (0, 4, 6, 2, 5, 1, 3)
    W = W.permute(*range(n), *(n + i for i in order))
    return W.reshape(*lead, -1).contiguous()


def wide_matrix(*blocks, cat_dim: int = -2):
    """The wide engine's copy of a matrix given as blocks [..., K_i, N_i]
    stacked along K (cat_dim=-2, each block's rows zero-padded to a
    multiple of 16 as `pack_matrix` pads them: the layout of the activation
    rows, the latent then the actions of a z||a layer) or along N
    (cat_dim=-1, K padded to 16): transposed, [..., N, Kp] with K
    contiguous, the operand that csrc/mlp_wide.cuh's product reads through
    a TMA tensor map (K-major for wgmma). N is not padded: the copy fills
    the columns past N with zeros. Leading axes (the stacked Q heads)
    stay."""
    if cat_dim == -2:
        W = torch.cat([F.pad(b, (0, 0, 0, _up16(b.shape[-2]) - b.shape[-2]))
                       for b in blocks], dim=-2)
    else:
        W = torch.cat(blocks, dim=-1)
        W = F.pad(W, (0, 0, 0, _up16(W.shape[-2]) - W.shape[-2]))
    return W.transpose(-1, -2).contiguous()


def _add_layouts(prep: dict, dot_dtype, engine):
    """Add the kernels' copies of prep's matrices (bf16 preps only: the
    kernels take bf16; an f32 prep feeds the plain versions): the packed
    copies unless the value step and the pi rollout take the wide engine
    (`engine` 'wide'), the wide copies of the dynamics and reward (the
    rollout's) and, unless they take the row tiles (`engine` 'rows'), of
    every matrix. `engine` None holds both layouts of every matrix."""
    if dot_dtype != torch.bfloat16:
        return prep
    for table, make, take in ((PACKED, pack_matrix, lambda k: engine != 'wide'),
                              (WIDE, wide_matrix,
                               lambda k: k[0] in 'dr' or engine != 'rows')):
        for k, parts in table.items():
            if take(k) and k not in prep and all(p in prep for p in parts):
                prep[k] = make(*[prep[p] for p in parts],
                               cat_dim=-1 if k[0] == 'p' and k[2] == '2' else -2)
    return prep


def _casts(dot_dtype):
    def w(x):
        return x.to(dot_dtype).contiguous()

    def f(x):
        return x.float().contiguous()
    return w, f


def _fold(W, b, L: int, emb):
    """The first-layer bias table of a layer whose input rows are
    [latent (L) | task embedding (dt) | rest]: b + emb @ W[L:L+dt] for each
    task's embedding row of `emb` [tasks, dt] -> [tasks, out] (a leading Q
    head axis of W and b goes after the task axis); emb None: b with a task
    axis of one."""
    if emb is None:
        return b[None]
    dt = emb.shape[-1]
    return b + torch.einsum('td,...do->t...o', emb, W[..., L:L + dt, :])


def prepare_rollout_params(dyn, rew, latent_dim: int, vmin: float,
                           vmax: float, dot_dtype=torch.bfloat16,
                           emb=None) -> dict:
    """The rollout's operands (keys ROLLOUT_NAMES) from the dynamics and
    reward MLP parameter tuples: each first layer split into its latent and
    action rows, matrices in `dot_dtype` (bf16 for the kernels, f32 for an
    exact plain reference), the rest f32, all contiguous. The first-layer
    biases are tables with a row per task of `emb` ([tasks, dt], the
    renormed task embeddings; None: one row)."""
    L = latent_dim
    dt = 0 if emb is None else emb.shape[-1]
    w, f = _casts(dot_dtype)
    B = rew[2]['w'].shape[-1]
    return _add_layouts({
        'dWz': w(dyn[0]['w'][:L]), 'dWa': w(dyn[0]['w'][L + dt:]),
        'db0': f(_fold(dyn[0]['w'], dyn[0]['b'], L, emb)),
        'dg0': f(dyn[0]['ln_w']), 'de0': f(dyn[0]['ln_b']),
        'dW1': w(dyn[1]['w']), 'db1': f(dyn[1]['b']),
        'dg1': f(dyn[1]['ln_w']), 'de1': f(dyn[1]['ln_b']),
        'dW2': w(dyn[2]['w']), 'db2': f(dyn[2]['b']),
        'dg2': f(dyn[2]['ln_w']), 'de2': f(dyn[2]['ln_b']),
        'rWz': w(rew[0]['w'][:L]), 'rWa': w(rew[0]['w'][L + dt:]),
        'rb0': f(_fold(rew[0]['w'], rew[0]['b'], L, emb)),
        'rg0': f(rew[0]['ln_w']), 're0': f(rew[0]['ln_b']),
        'rW1': w(rew[1]['w']), 'rb1': f(rew[1]['b']),
        'rg1': f(rew[1]['ln_w']), 're1': f(rew[1]['ln_b']),
        'rW2': w(rew[2]['w']), 'rb2': f(rew[2]['b']),
        'bins': torch.linspace(vmin, vmax, B, dtype=torch.float32,
                               device=dyn[0]['w'].device),
    }, dot_dtype, 'wide')


def prepare_value_params(params, cfg, dot_dtype=torch.bfloat16,
                         engine=None) -> dict:
    """Slice and cast the value step's operands once per set of weights.

    Matrices go to `dot_dtype` (bf16 for the kernel; f32 gives the exact
    plain reference), everything else stays f32; all contiguous, on the
    params' device. Keys are PREP_NAMES, the termination head's
    (TERM_NAMES) only when cfg.episodic; a bf16 prep also holds the
    kernels' copies of the matrices (`_add_layouts`: PACKED where the row
    tiles take the value step and the pi rollout, WIDE for the wide
    engine). `engine` ('rows' or 'wide') names the engine those two take;
    None asks the built library on the card (ops/wide.py `engine`, at
    cfg's widths, simnorm_dim and horizon) and holds both layouts on the
    CPU, where no kernel runs. The first-layer biases (db0, rb0,
    pb0, qb0, tb0) are tables with a row per task (cfg.tasks when
    cfg.multitask, else one): the module docstring's task axis.
    """
    L, A = cfg.latent_dim, cfg.action_dim
    pi, qs = params['pi'], params['Qs']
    w, f = _casts(dot_dtype)
    emb = task_embeddings(params) if getattr(cfg, 'multitask', False) else None
    dt = 0 if emb is None else emb.shape[-1]
    prep = prepare_rollout_params(params['dynamics'], params['reward'], L,
                                  cfg.vmin, cfg.vmax, dot_dtype, emb)
    prep.update({
        'pW0': w(pi[0]['w'][:L]), 'pb0': f(_fold(pi[0]['w'], pi[0]['b'], L, emb)),
        'pg0': f(pi[0]['ln_w']), 'pe0': f(pi[0]['ln_b']),
        'pW1': w(pi[1]['w']), 'pb1': f(pi[1]['b']),
        'pg1': f(pi[1]['ln_w']), 'pe1': f(pi[1]['ln_b']),
        'pWm': w(pi[2]['w'][:, :A]), 'pbm': f(pi[2]['b'][:A]),
        'pWl': w(pi[2]['w'][:, A:]), 'pbl': f(pi[2]['b'][A:]),
        'qWz': w(qs[0]['w'][:, :L]), 'qWa': w(qs[0]['w'][:, L + dt:]),
        'qb0': f(_fold(qs[0]['w'], qs[0]['b'], L, emb)),
        'qg0': f(qs[0]['ln_w']), 'qe0': f(qs[0]['ln_b']),
        'qW1': w(qs[1]['w']), 'qb1': f(qs[1]['b']),
        'qg1': f(qs[1]['ln_w']), 'qe1': f(qs[1]['ln_b']),
        'qW2': w(qs[2]['w']), 'qb2': f(qs[2]['b']),
    })
    if cfg.episodic:
        # the first layer reads the latent only: no action rows to split
        trm = params['termination']
        prep.update({
            'tW0': w(trm[0]['w'][:L]),
            'tb0': f(_fold(trm[0]['w'], trm[0]['b'], L, emb)),
            'tg0': f(trm[0]['ln_w']), 'te0': f(trm[0]['ln_b']),
            'tW1': w(trm[1]['w']), 'tb1': f(trm[1]['b']),
            'tg1': f(trm[1]['ln_w']), 'te1': f(trm[1]['ln_b']),
            'tW2': w(trm[2]['w']), 'tb2': f(trm[2]['b']),
        })
    if engine is None and dot_dtype == torch.bfloat16 and prep['dWz'].is_cuda:
        engine = wide.engine(_build.library('value'),
                             prep_dims(prep, getattr(cfg, 'simnorm_dim', 8),
                                       getattr(cfg, 'horizon', 3)))
    return _add_layouts({k: prep[k] for k in (*PREP_NAMES, *PACKED, *WIDE)
                         if k in prep}, dot_dtype, engine)


def task_embeddings(params):
    """Every task's embedding row with the lookup's max_norm=1 renorm
    (models/world_model.py `task_emb`) -> [tasks, task_dim]."""
    emb = params['task_emb']['w']
    norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb * torch.clamp(1.0 / torch.clamp(norm, min=1e-12), max=1.0)


def num_tasks(prep) -> int:
    """Rows of the prep's first-layer bias tables: the tasks it folds."""
    return prep['db0'].shape[0]


def prep_dims(prep, simnorm_dim: int, horizon: int) -> tuple:
    """(L, M, A, B, NQ, G, H), the order of csrc/mlp_rows.cuh's Dims."""
    L, M = prep['dWz'].shape
    nq = prep['qWz'].shape[0] if 'qWz' in prep else 0   # none in a rollout prep
    return (L, M, prep['dWa'].shape[0], prep['rW2'].shape[1], nq,
            simnorm_dim, horizon)


def check_prep(prep, device, simnorm_dim: int, names=KERNEL_NAMES):
    """Validate the kernels' operands `names` in `prep`: present, device,
    dtype, layout. The termination head's are checked where present."""
    for k in names:
        if k[0] == 't' and 'tW0' not in prep:
            continue
        want = torch.bfloat16 if k[1] in 'WPT' else torch.float32
        if k not in prep:
            raise ValueError(f'prepared weight {k}: missing (the kernels take '
                             'the packed or wide copies of a bf16 prep, each '
                             'where its engine reads it)')
        t = prep[k]
        if t.device != device or t.dtype != want or not t.is_contiguous():
            raise ValueError(
                f'prepared weight {k}: need a contiguous {want} tensor on '
                f'{device}, got {t.dtype} on {t.device}')
    if prep['dWz'].shape[0] % simnorm_dim:
        raise ValueError('latent_dim must be a multiple of simnorm_dim')


def weight_ptrs(prep, route: str = 'rows'):
    """Pointers in KERNEL_NAMES order, the matrices in the layout of the
    engine `route`; a name `prep` lacks is null."""
    return (ctypes.c_void_p * len(KERNEL_NAMES))(
        *[prep[k].data_ptr() if k in prep else None
          for k in kernel_names(route)])


def launch_route(name: str, libname: str, prep, dev, simnorm_dim: int, H: int):
    """(library, dims, engine) of a launch on `dev`: ValueError for a device
    other than CUDA and for widths that no engine takes, before anything is
    built or launched."""
    if dev.type != 'cuda':
        raise ValueError(f'{name}: unsupported device {dev}')
    lib = _build.library(libname)
    dims = (ctypes.c_int * 7)(*prep_dims(prep, simnorm_dim, H))
    return lib, dims, wide.engine(lib, dims)


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


def bias0(p, name: str, task=None):
    """First-layer bias `name` (db0, rb0, pb0, tb0, qb0) of each env's
    task: the table's row 0 when `task` is None (broadcasts over any
    leading axes), else rows `task` [N] as [N, 1, ...] (over an env axis N
    and a row axis)."""
    t = p[name]
    if task is None:
        return t[0]
    return t.index_select(0, task.long())[:, None]


def mask_rows(amask, A: int):
    """An action mask [A] (every env) or [N, A] (one row per env) as
    [1 or N, 1, A], to multiply [N, rows, A] tensors."""
    return amask.reshape(-1, A)[:, None]


def _hidden2(x, p, pre, b0):
    """Two NormedLinear+Mish layers of head `pre` ('d', 'r', 'p', 'q', 't').
    The first layer's product (without its bias) is given as `x`, its bias
    as `b0`."""
    def g(name):
        return p[pre + name]
    u = mish(layer_norm(x + b0, g('g0'), g('e0')))
    u = _dot(u, g('W1')) + g('b1')
    return mish(layer_norm(u, g('g1'), g('e1')))


def dynamics_plain(p, z, a, simnorm_dim: int, task=None):
    u = _hidden2(_dot(z, p['dWz']) + _dot(a, p['dWa']), p, 'd',
                 bias0(p, 'db0', task))
    u = layer_norm(_dot(u, p['dW2']) + p['db2'], p['dg2'], p['de2'])
    return simnorm(u, simnorm_dim)


def pi_head_plain(p, z, log_std_min: float, log_std_dif: float, task=None):
    """(mean, log_std) of the policy prior on z, before the action mask."""
    u = _hidden2(_dot(z, p['pW0']), p, 'p', bias0(p, 'pb0', task))
    mean = _dot(u, p['pWm']) + p['pbm']
    ls = _dot(u, p['pWl']) + p['pbl']
    return mean, log_std_min + 0.5 * log_std_dif * (torch.tanh(ls) + 1.0)


def pi_action_plain(mean, ls, eps, mask):
    """tanh(mean + eps * exp(ls)) with mean and eps times the action mask
    (broadcast against them): a masked column gives 0."""
    return torch.tanh(mean * mask + (eps * mask) * torch.exp(ls))


def termination_logit_plain(p, z, task=None):
    """The termination head's logit on z [..., L] -> [..., 1]."""
    u = _hidden2(_dot(z, p['tW0']), p, 't', bias0(p, 'tb0', task))
    return _dot(u, p['tW2']) + p['tb2']


def _rollout(p, z0, actions, discs, simnorm_dim, episodic, logits=None,
             task=None):
    """(G, z_H, term_H, term_at) of the module docstring; term is None
    unless `episodic`, and term_at [..., S] int32 is the step 1..H at which
    a row's flag was set, or 0. Each step's logit is appended to `logits`
    when that is a list. `task` [N] picks each env's bias rows (z0
    [N, S, L])."""
    z = z0.float()
    G = torch.zeros(z.shape[:-1] + (1,), dtype=torch.float32, device=z.device)
    term = torch.zeros_like(G) if episodic else None
    term_at = torch.zeros(z.shape[:-1], dtype=torch.int32, device=z.device)
    rb0 = bias0(p, 'rb0', task)
    for t in range(actions.shape[0]):
        a = actions[t]
        u = _hidden2(_dot(z, p['rWz']) + _dot(a, p['rWa']), p, 'r', rb0)
        r = _two_hot_dec(_dot(u, p['rW2']) + p['rb2'], p['bins'])
        if episodic:
            r = (1.0 - term) * r
        G = G + discs[t] * r
        z = dynamics_plain(p, z, a, simnorm_dim, task)
        if episodic:
            logit = termination_logit_plain(p, z, task)
            if logits is not None:
                logits.append(logit[..., 0])
            hit = (logit > 0.0).float()
            term_at = torch.where(((term == 0) & (hit > 0))[..., 0],
                                  t + 1, term_at).to(torch.int32)
            term = torch.clamp(term + hit, max=1.0)
    return G, z, term, term_at


def termination_trace_plain(prep, z0, actions, discs, simnorm_dim: int = 8,
                            task=None):
    """The plain value step's termination logits and flags: z0 [N, S, L];
    actions [N, H, S, A]; discs [N, H+1]; task [N] or None -> (logits
    [N, H, S] of the new latent at steps 1..H, term_at [N, S] int32: the
    step at which a row's sticky flag was set, or 0)."""
    logits = []
    _, _, _, term_at = _rollout(prep, z0, actions.transpose(0, 1),
                                discs.T[..., None, None], simnorm_dim, True,
                                logits, task)
    return torch.stack(logits, dim=1), term_at


def rollout_plain(prep, z0, actions, discs, simnorm_dim: int = 8):
    """The reward+dynamics rollout: z0 [S, L]; actions [H, S, A]; discs
    [>= H] -> (G [S, 1], z_H [S, L]), G = sum_t discs[t] * r(z_t, a_t).
    Leading axes of z0 and actions[t] broadcast."""
    G, z, _, _ = _rollout(prep, z0, actions, discs, simnorm_dim, False)
    return G, z


def value_estimate_plain(prep, z0, actions, eps, qidx, discs, *,
                         log_std_min: float, log_std_dif: float,
                         simnorm_dim: int = 8, episodic: bool = False,
                         term_at=None, task=None, amask=None):
    """z0 [N, S, L]; actions [N, H, S, A]; eps [N, S, A]; qidx [N, 2] int;
    discs [N, H+1] -> value [N, S, 1], each env with its own Q heads and
    discounts (N=1 for one env); `episodic` gates by the termination
    head, whose weights `prep` must then hold. `term_at` [N, S] int32, if
    given, receives the step 1..H at which each row's flag was set, or 0.
    `task` [N] int (None: task 0) picks each env's first-layer bias rows;
    `amask` ([A] or [N, A]; None: ones) masks the terminal policy."""
    p = prep
    H = actions.shape[1]
    G, z, term, at = _rollout(p, z0, actions.transpose(0, 1),
                              discs.T[..., None, None], simnorm_dim, episodic,
                              task=task)
    if term_at is not None:
        term_at.copy_(at)
    mean, ls = pi_head_plain(p, z, log_std_min, log_std_dif, task)
    m = 1.0 if amask is None else mask_rows(amask, mean.shape[-1])
    a = pi_action_plain(mean, ls, eps, m)
    qb0 = p['qb0'][0] if task is None else p['qb0'].index_select(0, task.long())
    q = 0.0
    for j in range(2):
        # each env's head, picked on the device (no host read of qidx):
        # matrices [N, K, M], vectors [N, 1, M]
        i = qidx[:, j].long()
        h = {k: torch.index_select(p[k], 0, i) for k in PREP_NAMES
             if k[0] == 'q' and k != 'qb0'}
        h = {k: v if k[1] == 'W' else v[:, None] for k, v in h.items()}
        b0 = (qb0.index_select(0, i) if task is None
              else qb0[torch.arange(len(i), device=i.device), i])[:, None]
        u = _hidden2(_dot(z, h['qWz']) + _dot(a, h['qWa']), h, 'q', b0)
        q = q + _two_hot_dec(_dot(u, h['qW2']) + h['qb2'], p['bins'])
    q = q / 2.0
    if episodic:
        q = (1.0 - term) * q
    return G + discs[:, H, None, None] * q


def sample_actions_plain(mean, std, noise, pi_acts, amask):
    """mean/std [N, H*A]; noise [N, S, H*A]; pi_acts [N, n_pi, H*A];
    amask [A] or [N, A] -> actions [N, S, H*A]."""
    n_pi = pi_acts.shape[1]
    acts = torch.clamp(mean[:, None] + std[:, None] * noise, -1.0, 1.0)
    if n_pi:
        acts = torch.cat([pi_acts, acts[:, n_pi:]], dim=1)
    A = amask.shape[-1]
    return acts * mask_rows(amask, A).repeat(1, 1, mean.shape[-1] // A)


def value_sampled_plain(prep, z0, mean, std, noise, pi_acts, amask, eps, qidx,
                        discs, **kw):
    """`sample_actions_plain`, then `value_estimate_plain` on its actions
    with the same mask (keywords as there) -> (value [N, S, 1], actions
    [N, S, H*A])."""
    acts = sample_actions_plain(mean, std, noise, pi_acts, amask)
    N, S, HA = acts.shape
    H = discs.shape[-1] - 1
    v = value_estimate_plain(prep, z0, acts.view(N, S, H, HA // H).permute(0, 2, 1, 3),
                             eps, qidx, discs, amask=amask, **kw)
    return v, acts


def gate_check(got, want, got_at, want_at, logits, *, rtol: float,
               atol: float, near: float = 1e-2):
    """Hold an episodic value step `got` against the plain `want` (both
    [N, S, 1]) under the gate rule. The gate is a step function of the
    logit, so a logit within a bf16 step of 0 may set the flag in one
    version and not the other, and that zeroes the row's later reward and
    Q. A row whose flags agree (`got_at == want_at`, each the step at which
    the flag was set, or 0) must be finite and within atol + rtol * |want|;
    a row whose flags differ is allowed only if the plain logit (`logits`
    [N, H, S], termination_trace_plain) at the first step where they differ
    has |logit| < `near`. Returns (flips, bad): the allowed disagreements
    and the rows that break the rule."""
    got, want = got[..., 0], want[..., 0]
    H = logits.shape[1]
    k_at = torch.where(got_at > 0, got_at, H + 1)
    p_at = torch.where(want_at > 0, want_at, H + 1)
    differ = k_at != p_at
    first = (torch.minimum(k_at, p_at).clamp(max=H) - 1).long()
    logit = logits.gather(1, first[:, None]).squeeze(1)
    flip = differ & (logit.abs() < near)
    outside = ~((got - want).abs() <= atol + rtol * want.abs())
    bad = (~differ & outside) | (differ & ~flip) | ~torch.isfinite(got)
    return int(flip.sum()), int(bad.sum())


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _check_operands(name, prep, z0, eps, qidx, discs, N, S, simnorm_dim,
                    term_at, route):
    """Validate the operands both launches share, on a CUDA device, the
    weights in the layout of the engine `route`; returns (the device, H)."""
    dev = z0.device
    if dev.type != 'cuda':
        raise ValueError(f'{name}: unsupported device {dev}')
    check_prep(prep, dev, simnorm_dim, kernel_names(route))
    L = prep['dWz'].shape[0]
    H = discs.shape[-1] - 1
    if (z0.shape != (N, S, L) or z0.stride(2) != 1 or z0.dtype != torch.float32):
        raise ValueError(f'{name}: z0 {tuple(z0.shape)} must be an f32 [N, S, L] '
                         f'tensor (N={N}, S={S}, L={L}) with unit inner stride')
    A = prep['dWa'].shape[0]
    for what, t, shape, dtype, inner in (
            ('eps', eps, (N, S, A), torch.float32, (A, 1)),
            ('qidx', qidx, (N, 2), torch.int32, (1,)),
            ('discs', discs, (N, H + 1), torch.float32, (1,))):
        if (t.device != dev or tuple(t.shape) != shape or t.dtype != dtype
                or t.stride()[1:] != inner):
            raise ValueError(f'{name}: {what} must be a {dtype} {shape} tensor '
                             f'on {dev}, contiguous after the env axis')
    if term_at is not None and (
            term_at.device != dev or term_at.dtype != torch.int32
            or tuple(term_at.shape) != (N, S) or not term_at.is_contiguous()):
        raise ValueError(f'{name}: term_at must be a contiguous int32 '
                         f'{(N, S)} tensor on {dev}')
    return dev, H


def task_operands(name, prep, task, amask, N: int, dev, need_mask: bool):
    """The task axis's kernel operands: (task pointer or None, the number of
    tasks, amask pointer or None, amask's env stride). `task` is an int32
    [N] tensor or None (task 0); `amask` an f32 [A] tensor (every env,
    stride 0), [N, A] with contiguous rows, or None (ones; refused when
    `need_mask`)."""
    A = prep['dWa'].shape[0]
    if task is not None and (task.device != dev or task.dtype != torch.int32
                             or tuple(task.shape) != (N,)
                             or not task.is_contiguous()):
        raise ValueError(f'{name}: task must be a contiguous int32 ({N},) '
                         f'tensor on {dev}')
    if amask is None:
        if need_mask:
            raise ValueError(f'{name}: amask is required')
        return (None if task is None else task.data_ptr(), num_tasks(prep),
                None, 0)
    if (amask.device != dev or amask.dtype != torch.float32
            or tuple(amask.shape) not in ((A,), (N, A)) or amask.stride(-1) != 1):
        raise ValueError(f'{name}: amask must be an f32 ({A},) or ({N}, {A}) '
                         f'tensor on {dev} with contiguous rows')
    return (None if task is None else task.data_ptr(), num_tasks(prep),
            amask.data_ptr(), amask.stride(0) if amask.dim() == 2 else 0)


def value_estimate(prep, z0, actions, eps, qidx, discs, *,
                   log_std_min: float, log_std_dif: float,
                   simnorm_dim: int = 8, episodic: bool = False, term_at=None,
                   task=None, amask=None):
    """The value kernel on CUDA tensors, its plain version on CPU tensors.

    N envs in one launch (N=1 for one env): z0 [N, S, L] f32; actions
    [N, H, S, A] f32; eps [N, S, A] f32; qidx [N, 2] int32; discs [N, H+1]
    f32 -> value [N, S, 1] f32. Any strides on the env and row axes (the
    planner passes a broadcast latent, stride 0, and permuted or strided
    views of its samples and noise); unit stride on the last axis, and eps
    rows contiguous. `episodic` needs the termination head's weights in
    `prep`. `term_at`, a contiguous int32 [N, S] tensor or None, receives
    the step 1..H at which each row's termination flag was set, or 0 (for
    checks of the gate). `task` (int32 [N], or None for task 0) and `amask`
    (f32 [A] or [N, A], or None for ones) are the task axis of the module
    docstring.
    """
    if episodic and any(k not in prep for k in TERM_NAMES):
        raise ValueError('value_estimate: episodic=True needs the termination '
                         'head in prep (prepare_value_params with cfg.episodic)')
    if z0.device.type == 'cpu':
        return value_estimate_plain(
            prep, z0, actions, eps, qidx, discs, log_std_min=log_std_min,
            log_std_dif=log_std_dif, simnorm_dim=simnorm_dim,
            episodic=episodic, term_at=term_at, task=task, amask=amask)
    if actions.dim() != 4:
        raise ValueError(f'value_estimate: actions {tuple(actions.shape)} '
                         'must be [N, H, S, A] with z0 [N, S, L]')
    N, H, S, A = actions.shape
    lib, dims, route = launch_route('value_estimate', 'value', prep, z0.device,
                                    simnorm_dim, H)
    dev, _ = _check_operands('value_estimate', prep, z0, eps, qidx, discs, N, S,
                             simnorm_dim, term_at, route)
    if (actions.device != dev or actions.dtype != torch.float32
            or actions.stride(3) != 1 or prep['dWa'].shape[0] != A
            or discs.shape[-1] != H + 1):
        raise ValueError(f'value_estimate: actions {tuple(actions.shape)} must be '
                         f'f32 on {dev} with unit inner stride and fit the weights '
                         f'(A={prep["dWa"].shape[0]}) and discs')
    tk = task_operands('value_estimate', prep, task, amask, N, dev, False)
    out = torch.empty(N, S, 1, dtype=torch.float32, device=dev)
    args = (weight_ptrs(prep, route), dims, log_std_min, log_std_dif, int(episodic),
            N, S, z0.data_ptr(), z0.stride(0), z0.stride(1),
            actions.data_ptr(), actions.stride(0), actions.stride(1),
            actions.stride(2), *tk, eps.data_ptr(), eps.stride(0),
            qidx.data_ptr(), qidx.stride(0), discs.data_ptr(), discs.stride(0),
            out.data_ptr(), None if term_at is None else term_at.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == 'rows':
        rc = lib.tdm_value(*args, stream)
    else:
        sc = wide.Scratch(N * S, tuple(dims), dev, envs=0 if episodic else N)
        n = wide.counts()
        rc = lib.tdm_value_wide(*args, sc.ptrs, sc.lds, n, stream)
        wide.count(n)
    _build.check(lib, rc, 'value kernel', dims)
    value_estimate.launches += 1
    return out


value_estimate.launches = 0


def value_sampled(prep, z0, mean, std, noise, pi_acts, amask, eps, qidx, discs,
                  *, log_std_min: float, log_std_dif: float,
                  simnorm_dim: int = 8, episodic: bool = False, term_at=None,
                  task=None):
    """The planner's step: the value kernel in its sampled mode on CUDA
    tensors, `value_sampled_plain` on CPU tensors.

    mean/std [N, H*A] f32; noise [N, S, H*A] f32 (rows below n_pi unused);
    pi_acts [N, n_pi, H*A] f32, n_pi <= S; amask [A] (every env) or [N, A]
    f32; task int32 [N] or None (task 0); the rest as for `value_estimate`
    -> (value [N, S, 1], actions [N, S, H*A]), the actions the module
    docstring gives, bit for bit as `sample_actions_plain`'s. Any stride on
    the env axes; rows and the last axis contiguous.
    """
    if episodic and any(k not in prep for k in TERM_NAMES):
        raise ValueError('value_sampled: episodic=True needs the termination '
                         'head in prep (prepare_value_params with cfg.episodic)')
    kw = dict(log_std_min=log_std_min, log_std_dif=log_std_dif,
              simnorm_dim=simnorm_dim, episodic=episodic, term_at=term_at,
              task=task)
    if z0.device.type == 'cpu':
        return value_sampled_plain(prep, z0, mean, std, noise, pi_acts, amask,
                                   eps, qidx, discs, **kw)
    N, S, HA = noise.shape
    H = discs.shape[-1] - 1
    lib, dims, route = launch_route('value_sampled', 'value', prep, z0.device,
                                    simnorm_dim, H)
    dev, H = _check_operands('value_sampled', prep, z0, eps, qidx, discs, N, S,
                             simnorm_dim, term_at, route)
    A, n_pi = prep['dWa'].shape[0], pi_acts.shape[1]
    for what, t, shape, inner in (
            ('mean', mean, (N, HA), (1,)), ('std', std, (N, HA), (1,)),
            ('noise', noise, (N, S, HA), (HA, 1)),
            ('pi_acts', pi_acts, (N, n_pi, HA), (HA, 1) if n_pi else None)):
        if (t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape
                or (inner is not None and t.stride()[1:] != inner)):
            raise ValueError(f'value_sampled: {what} must be an f32 {shape} tensor '
                             f'on {dev}, contiguous after the env axis (H={H}, '
                             f'A={A}, H*A={H * A})')
    if HA != H * A or n_pi > S:
        raise ValueError(f'value_sampled: H*A={HA} columns for H={H}, A={A}, or '
                         f'{n_pi} policy rows for S={S}')
    tk = task_operands('value_sampled', prep, task, amask, N, dev, True)
    out = torch.empty(N, S, 1, dtype=torch.float32, device=dev)
    acts = torch.empty(N, S, HA, dtype=torch.float32, device=dev)
    args = (weight_ptrs(prep, route), dims, log_std_min, log_std_dif, int(episodic), N,
            S, z0.data_ptr(), z0.stride(0), z0.stride(1), mean.data_ptr(),
            mean.stride(0), std.data_ptr(), std.stride(0), noise.data_ptr(),
            noise.stride(0), pi_acts.data_ptr(), pi_acts.stride(0), n_pi,
            acts.data_ptr(), *tk, eps.data_ptr(), eps.stride(0),
            qidx.data_ptr(), qidx.stride(0), discs.data_ptr(), discs.stride(0),
            out.data_ptr(), None if term_at is None else term_at.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == 'rows':
        rc = lib.tdm_value_sampled(*args, stream)
    else:
        sc = wide.Scratch(N * S, tuple(dims), dev, envs=0 if episodic else N)
        n = wide.counts()
        rc = lib.tdm_value_sampled_wide(*args, sc.ptrs, sc.lds, n, stream)
        wide.count(n)
    _build.check(lib, rc, 'value kernel (sampled)', dims)
    value_sampled.launches += 1
    return out, acts


value_sampled.launches = 0


def kernel_plan(prep, simnorm_dim: int = 8, horizon: int = 3,
                kernel: str = 'value', rows: int = 512) -> dict:
    """The built kernel's plan for these weights' dims. `kernel` is
    'value', 'pi_rollout' or 'rollout'. On the row-tile engine
    (csrc/mlp_rows.cuh Plan): route 'rows', rows per block `rt`,
    shared-memory bytes of one block, weight ring `stages`, and blocks that
    fit one SM. On the wide engine (csrc/mlp_wide.cuh; the rollout always):
    route 'wide', the product block's rows `bm`, columns `bn` and K depth a
    stage `bk` at `rows` rows an env (the tile follows from them and the
    widths), its `stages`, shared bytes, blocks per SM, consumer
    warpgroups `wgs` and registers a thread at launch `regs`. `engine` is
    the engine the value kernel and the pi rollout take at these widths
    (the rollout's route is 'wide' whatever it is). Raises ValueError when
    no engine takes the widths."""
    libname, fn = {'value': ('value', 'tdm_value_plan'),
                   'pi_rollout': ('cem', 'tdm_pi_rollout_plan'),
                   'rollout': ('rollout', None)}[kernel]
    lib = _build.library(libname)
    dims = (ctypes.c_int * 7)(*prep_dims(prep, simnorm_dim, horizon))
    engine = wide.engine(lib, dims)
    route = 'wide' if fn is None else engine
    if route == 'rows':
        out = (ctypes.c_int * 4)()
        _build.check(lib, getattr(lib, fn)(dims, out), f'{kernel} plan', dims)
        return dict(route=route, engine=engine, rt=out[0], smem_bytes=out[1],
                    stages=out[2], blocks_per_sm=out[3])
    out = (ctypes.c_int * 8)()
    _build.check(lib, lib.tdm_wide_plan(dims, rows, out), f'{kernel} plan', dims)
    return dict(route=route, engine=engine, bm=out[0], bn=out[1], bk=out[2],
                stages=out[3], smem_bytes=out[4], blocks_per_sm=out[5], wgs=out[6],
                regs=out[7])
