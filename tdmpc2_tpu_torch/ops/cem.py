"""The MPPI/CEM planning loop: the port of the TPU kernel `_cem_kernel`
(tdmpc2_tpu/ops/pallas_cem.py:53, entry `cem_prepared` :247), for N
environments at once (the TPU kernel's grid=(N,), `_cem_flat` :303).

The TPU kernel runs one environment's whole loop in one program. Here the
loop is three hand-written kernels (csrc/cem.cu, csrc/value.cu) whose launch
boundaries are the only synchronisation across thread blocks; each launch
covers all N envs, 1 + 2 x iterations launches a plan:

    pi_rollout                 once per plan: the n_pi policy-prior rows
    per iteration:
      value_sampled            ops/value.py: clip(mean + std * noise), pi
                               rows override, sampled where the value
                               kernel stages the actions; the value of each
      elite_moments            one warp per env: NaN guard, E-th largest
                               by bisection in one warp with boundary-shell
                               tie weights, softmax-weighted mean/std update

Each wrapper launches its kernel on CUDA tensors and runs its plain
version on CPU tensors. At widths above the row tiles (model_size 317) the
pi rollout and the value step run on the layer-per-launch engine
(ops/wide.py): still one wrapper call a step, of several launches. `cem_plan` chains the wrappers; `cem_plan_plain`
chains the plain versions. All noise is input, laid out as for
`cem_prepared` with a leading env axis N (N=1 for one env): z0 [N, 1, L];
pi_eps [N, n_pi, H*A]; noise [N, I, S, H*A] (rows below n_pi unused); eps
[N, I, S, A]; qidx [N, I, 2] int32; discs [N, H+1]; mean0/std0 [N, H*A];
amask [A] (every env) or [N, A]; task int32 [N] or None; returns (mean
[N, H*A], std [N, H*A], value [N, S, 1] of the last iteration,
NaN-guarded, and its actions [N, S, H*A]). With `episodic=True` the value
step applies the termination gate (pallas_cem.py:161-172, 190-191;
ops/value.py); the policy-prior rollouts have none, as in the TPU kernel.

The envs may be the tasks of a multi-task model (the task axis of
ops/value.py): each env's `task` id picks its first-layer bias rows, and
its `amask` row masks the policy's mean and eps in the rollouts and the
terminal value, the sampled actions, and the new mean and std, where the
JAX planner masks the actions, the mean and the std
(tdmpc2_tpu/tdmpc2.py:652-671). N tasks plan in the same 1 + 2 x
iterations launches as one.
"""

from __future__ import annotations

import torch

from tdmpc2_tpu_torch.ops import _build, wide
from tdmpc2_tpu_torch.ops.value import (check_prep, dynamics_plain, kernel_names,
                                        launch_route, mask_rows,
                                        pi_action_plain, pi_head_plain,
                                        sample_actions_plain,  # noqa: F401
                                        task_operands, value_sampled,
                                        value_sampled_plain, weight_ptrs)

_F32_HUGE = 3.0e38  # finite-value guard (nan_to_num semantics)


def _cuda_operands(name, dev, *tensors):
    for t in tensors:
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f'{name}: operands must be contiguous f32 '
                             f'tensors on {dev}')


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# Policy-prior rollouts
# ---------------------------------------------------------------------------


def pi_rollout_plain(prep, z0, pi_eps, *, log_std_min: float,
                     log_std_dif: float, simnorm_dim: int = 8, task=None,
                     amask=None, latents=None):
    """z0 [N, 1, L]; pi_eps [N, n_pi, H*A]; task [N] or None; amask [A],
    [N, A] or None (ones) -> actions [N, n_pi, H*A]. `latents` [H-1, N,
    n_pi, L], when given, receives z_1 .. z_{H-1}."""
    A = prep['pWm'].shape[1]
    HA = pi_eps.shape[-1]
    z = z0.float().expand(*pi_eps.shape[:-1], z0.shape[-1])
    m = 1.0 if amask is None else mask_rows(amask, A)
    out = []
    for t in range(HA // A):
        mean, ls = pi_head_plain(prep, z, log_std_min, log_std_dif, task)
        a = pi_action_plain(mean, ls, pi_eps[..., t * A:(t + 1) * A], m)
        out.append(a)
        z = dynamics_plain(prep, z, a, simnorm_dim, task)
        if latents is not None and t + 1 < HA // A:
            latents[t] = z
    return torch.cat(out, dim=-1)


def pi_rollout(prep, z0, pi_eps, *, log_std_min: float, log_std_dif: float,
               simnorm_dim: int = 8, task=None, amask=None, latents=None):
    """The pi-rollout kernel on CUDA tensors, the plain version on CPU.
    pi_eps rows contiguous; any stride on the env axes. `task` (int32 [N])
    and `amask` ([A] or [N, A]) as for ops/value.py `value_estimate`.
    `latents`, a contiguous f32 [H-1, N, n_pi, L] tensor, receives the
    latents z_1 .. z_{H-1} the kernel advances to: on the wide engine only
    (the row tiles keep them in shared memory), to hold each step on its own
    inputs."""
    dev = z0.device
    if dev.type == 'cpu':
        return pi_rollout_plain(prep, z0, pi_eps, log_std_min=log_std_min,
                                log_std_dif=log_std_dif,
                                simnorm_dim=simnorm_dim, task=task,
                                amask=amask, latents=latents)
    if dev.type != 'cuda':
        raise ValueError(f'pi_rollout: unsupported device {dev}')
    N, n_pi, HA = pi_eps.shape
    L, A = prep['dWz'].shape[0], prep['pWm'].shape[1]
    lib, dims, route = launch_route('pi_rollout', 'cem', prep, dev, simnorm_dim,
                                    HA // A)
    check_prep(prep, dev, simnorm_dim, kernel_names(route))
    for t in (z0, pi_eps):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f'pi_rollout: operands must be f32 on {dev}')
    if (z0.shape != (N, 1, L) or z0.stride(2) != 1 or HA % A or n_pi < 1
            or pi_eps.stride()[1:] != (HA, 1)):
        raise ValueError(f'pi_rollout: z0 {tuple(z0.shape)} / pi_eps '
                         f'{tuple(pi_eps.shape)} do not fit L={L}, A={A} '
                         'with contiguous rows')
    tk = task_operands('pi_rollout', prep, task, amask, N, dev, False)
    out = torch.empty(N, n_pi, HA, dtype=torch.float32, device=dev)
    args = (weight_ptrs(prep, route), dims, log_std_min, log_std_dif, N, n_pi,
            z0.data_ptr(), z0.stride(0), pi_eps.data_ptr(), pi_eps.stride(0),
            *tk, out.data_ptr())
    if latents is not None and (
            route != 'wide' or latents.device != dev
            or latents.dtype != torch.float32 or not latents.is_contiguous()
            or latents.shape != (HA // A - 1, N, n_pi, L)):
        raise ValueError(f'pi_rollout: latents must be a contiguous f32 '
                         f'{(HA // A - 1, N, n_pi, L)} tensor on {dev}, on the '
                         f'wide engine (this model takes the {route} engine)')
    if route == 'rows':
        rc = lib.tdm_pi_rollout(*args, _stream(dev))
    else:
        sc, n = wide.Scratch(N * n_pi, tuple(dims), dev), wide.counts()
        zs = None if latents is None else latents.data_ptr()
        rc = lib.tdm_pi_rollout_wide(*args, sc.ptrs, sc.lds, zs, n, _stream(dev))
        wide.count(n)
    _build.check(lib, rc, 'pi_rollout kernel', dims)
    pi_rollout.launches += 1
    return out


pi_rollout.launches = 0


# ---------------------------------------------------------------------------
# Elite selection and moment update
# ---------------------------------------------------------------------------


def elite_moments_plain(value, acts, amask, *, num_elites: int,
                        temperature: float, min_std: float, max_std: float):
    """value [N, S] or [N, S, 1]; acts [N, S, H*A]; amask [A] (every env)
    or [N, A] -> (mean [N, H*A], std [N, H*A], guarded value [N, S]), each
    env on its own.

    The E-th largest value is found by 32-step bisection; the weight left
    over at the boundary is shared by the values tied there, so distinct
    values give exactly the top E and all-tied values a uniform E/S
    (tdmpc2_tpu/ops/pallas_cem.py:186-231).
    """
    N, S, HA = acts.shape
    v = value.reshape(N, S).float()
    v = torch.where((v == v) & (torch.abs(v) <= _F32_HUGE), v,
                    torch.zeros_like(v))
    E = float(num_elites)
    vmax = v.max(-1, keepdim=True).values
    lo = v.min(-1, keepdim=True).values
    hi = vmax + 0.001 * torch.abs(vmax) + 1.0
    for _ in range(32):
        mid = lo + 0.5 * (hi - lo)
        ge = (v >= mid).float().sum(-1, keepdim=True) >= E
        lo = torch.where(ge, mid, lo)
        hi = torch.where(ge, hi, mid)
    n1 = (v >= hi).float().sum(-1, keepdim=True)
    nb = (v >= lo).float().sum(-1, keepdim=True) - n1
    wb = (E - n1) / torch.clamp(nb, min=1.0)
    w = torch.where(v >= hi, torch.ones_like(v),
                    torch.where(v >= lo, wb, torch.zeros_like(v)))
    score = torch.exp(temperature * (v - vmax)) * w
    score = (score / score.sum(-1, keepdim=True))[..., None]
    denom = score.sum(-2) + 1e-9
    mean = (score * acts).sum(-2) / denom
    std = torch.sqrt((score * (acts - mean[:, None]) ** 2).sum(-2) / denom)
    std = torch.clamp(std, min_std, max_std)
    A = amask.shape[-1]
    mask = mask_rows(amask, A)[:, 0].repeat(1, HA // A)
    return mean * mask, std * mask, v


def elite_moments(value, acts, amask, *, num_elites: int, temperature: float,
                  min_std: float, max_std: float):
    """The elite kernel on CUDA tensors, the plain version on CPU. Raises
    ValueError where S values and their row list do not fit in a block's
    shared memory (S above 29,022)."""
    dev = acts.device
    if dev.type == 'cpu':
        return elite_moments_plain(value, acts, amask, num_elites=num_elites,
                                   temperature=temperature, min_std=min_std,
                                   max_std=max_std)
    if dev.type != 'cuda':
        raise ValueError(f'elite_moments: unsupported device {dev}')
    _cuda_operands('elite_moments', dev, value, acts, amask)
    N, S, HA = acts.shape
    A = amask.shape[-1]
    if (value.numel() != N * S or HA % A or not 0 < num_elites <= S
            or amask.numel() not in (A, N * A)):
        raise ValueError('elite_moments: shapes do not agree')
    v_out = torch.empty(N, S, dtype=torch.float32, device=dev)
    mean = torch.empty(N, HA, dtype=torch.float32, device=dev)
    std = torch.empty(N, HA, dtype=torch.float32, device=dev)
    lib = _build.library('cem')
    rc = lib.tdm_elite(value.data_ptr(), acts.data_ptr(), amask.data_ptr(),
                       A if amask.dim() == 2 else 0, N, S, HA, A, num_elites, temperature, min_std, max_std,
                       v_out.data_ptr(), mean.data_ptr(), std.data_ptr(),
                       _stream(dev))
    if rc == _build.NO_PLAN:
        raise ValueError(f'elite_moments: S={S} samples of HA={HA} columns do '
                         'not fit in a block\'s shared memory')
    _build.check(lib, rc, 'elite kernel')
    elite_moments.launches += 1
    return mean, std, v_out


elite_moments.launches = 0


# ---------------------------------------------------------------------------
# The planning loop
# ---------------------------------------------------------------------------


def _cem_loop(steps, prep, z0, pi_eps, noise, eps, qidx, discs, mean0, std0,
              amask, *, iterations, n_pi, num_elites, temperature, min_std,
              max_std, log_std_min, log_std_dif, simnorm_dim, episodic=False,
              task=None):
    pi_roll, value, elite = steps
    N, I, S, HA = noise.shape
    H = discs.shape[-1] - 1
    A = HA // H
    if not 1 <= iterations <= I:
        raise ValueError(f'{iterations} iterations with noise for {I}')
    heads = dict(log_std_min=log_std_min, log_std_dif=log_std_dif,
                 simnorm_dim=simnorm_dim, task=task)
    amask = amask.reshape(A) if amask.numel() == A else amask.reshape(N, A)
    if n_pi > 0:
        pi_acts = pi_roll(prep, z0, pi_eps[:, :n_pi], amask=amask, **heads)
    else:
        pi_acts = noise.new_zeros(N, 0, HA)
    z = z0.expand(N, S, z0.shape[-1])
    mean, std = mean0.reshape(N, HA), std0.reshape(N, HA)
    for it in range(iterations):
        v, acts = value(prep, z, mean, std, noise[:, it], pi_acts, amask,
                        eps[:, it], qidx[:, it], discs, episodic=episodic,
                        **heads)
        mean, std, v = elite(v, acts, amask, num_elites=num_elites,
                             temperature=temperature, min_std=min_std,
                             max_std=max_std)
    return mean, std, v[..., None], acts


def cem_plan(prep, z0, pi_eps, noise, eps, qidx, discs, mean0, std0, amask,
             **kw):
    """The planning loop through the kernels (CUDA) or plain versions (CPU)."""
    return _cem_loop((pi_rollout, value_sampled, elite_moments), prep, z0,
                     pi_eps, noise, eps, qidx, discs, mean0, std0, amask,
                     **kw)


def cem_plan_plain(prep, z0, pi_eps, noise, eps, qidx, discs, mean0, std0,
                   amask, **kw):
    """The planning loop through the plain versions, on any device."""
    return _cem_loop((pi_rollout_plain, value_sampled_plain,
                      elite_moments_plain), prep, z0, pi_eps, noise, eps,
                     qidx, discs, mean0, std0, amask, **kw)
