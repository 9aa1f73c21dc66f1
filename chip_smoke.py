#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `tdmpc2_tpu_torch/csrc` with nvcc,
holds every kernel of the acting path against its plain PyTorch version at
the default 5M model's full width, then drives the path through its entry
point, `tdmpc2_tpu_torch.evaluate`, on the `toy-reach` task with random
weights drawn from a seed, and shows through the launch counters that the
planner ran on the kernels. Phases print one progress line each. It ends
with the card's name and power limit, one JSON line of per-kernel numbers
(launches on the path, error against the plain version, kernel and plain
times, the card's least time for the same work), and last
`{"ok": true, "device": {...}}`. Any failed phase exits non-zero before
that line; so does a machine without CUDA, or a directory without the
port's package. A watchdog turns a hang into an exit with a traceback.
"""

from __future__ import annotations

import faulthandler
import json
import math
import os
import subprocess
import sys
import time

WATCHDOG_S = 1000          # the whole run is expected well under 300 s
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12        # dense bf16 tensor-core peak
F32_FLOPS = 67e12          # f32 outside the tensor cores
SEED = 1

# Bands of kernel against plain version. Both round every dot input to
# bf16 and accumulate in f32; they differ in summation order and in the
# transcendental routines, and a last-bit difference ahead of a bf16
# rounding can move an activation by one bf16 step (2^-8 relative). The
# elite kernel has no dot and is held at 1e-4; sampling is exact.
VALUE_TOL = dict(rtol=2e-2, atol=2e-2)
PI_TOL = dict(rtol=2e-2, atol=2e-2)
SAMPLE_TOL = dict(rtol=0.0, atol=1e-6)
ELITE_TOL = dict(rtol=1e-4, atol=1e-4)
# The whole loop: an elite swap at the boundary (values within the value
# band of each other) moves the softmax-weighted mean by about 1/E of an
# action's range per swap, and later iterations sample around that mean.
CEM_TOL = dict(rtol=0.0, atol=0.15)
# Plain value estimate in f32 against the model heads in f32 (the JAX
# agent's plain branch): the same function in another factoring.
REF_TOL = dict(rtol=1e-4, atol=1e-4)


def log(msg):
    print(msg, flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f'[phase] {self.name} ...')
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        log(f'[phase] {self.name} {"ok" if exc is None else "FAILED"} '
            f'({dt:.1f} s)')
        return False


def nvidia_smi_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def hold(name, got, want, tol):
    """Raise unless |got - want| <= atol + rtol * |want| everywhere."""
    import torch
    err = max_err(got, want)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f'{name}: non-finite kernel output')
    bad = (got.float() - want.float()).abs() > (
        tol['atol'] + tol['rtol'] * want.float().abs())
    if bool(bad.any()):
        raise AssertionError(f'{name}: max |err| {err:.3g} outside {tol}')
    log(f'  {name}: max |err| {err:.3g} within {tol}')
    return err


def time_ms(fn, reps):
    """Mean ms of fn() over `reps` runs on the current stream (CUDA events),
    after one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes, flops, peak_flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


def perturbed(params, gen, scale=0.05):
    """Every leaf plus scale * N(0, 1), so the zero-init reward and Q heads
    give distinct sample values."""
    import torch
    if isinstance(params, dict):
        return {k: perturbed(v, gen, scale) for k, v in params.items()}
    if isinstance(params, tuple):
        return tuple(perturbed(v, gen, scale) for v in params)
    return params + scale * torch.randn(params.shape, generator=gen)


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'False)', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from tdmpc2_tpu_torch.config import load_cfg
        from tdmpc2_tpu_torch.envs import make_env
        from tdmpc2_tpu_torch.evaluate import evaluate
        from tdmpc2_tpu_torch.models.layers import simnorm
        from tdmpc2_tpu_torch.ops import _build, cem, value
        from tdmpc2_tpu_torch.tdmpc2 import TDMPC2
    except ImportError as e:
        print(f'chip_smoke: the port is not importable here ({e})',
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')

    with Phase('device'):
        smi = nvidia_smi_line()
        log(f'  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, '
            f'{torch.cuda.device_count()} device(s)')

    with Phase('build'):
        for name, (secs, report) in _build.build().items():
            log(f'  {name}.cu built in {secs:.1f} s')
            for line in report.splitlines():
                if 'registers' in line or 'spill' in line:
                    log(f'    {line.strip()}')
        for name in _build.SOURCES:
            _build.library(name)

    # the main path's model: toy-reach at the default 5M config
    cfg = load_cfg(overrides=['task=toy-reach', f'seed={SEED}'])
    make_env(cfg)
    agent = TDMPC2(cfg, device='cuda')
    H, S, A, E = cfg.horizon, cfg.num_samples, cfg.action_dim, cfg.num_elites
    L, n_pi, I = cfg.latent_dim, cfg.num_pi_trajs, agent.iterations
    gen = torch.Generator().manual_seed(SEED)
    agent.load_params(perturbed(agent.model.init(gen), gen))
    prep = agent.prep
    heads = dict(log_std_min=agent.model.log_std_min,
                 log_std_dif=agent.model.log_std_dif,
                 simnorm_dim=cfg.simnorm_dim)
    g = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    with Phase(f'value kernel vs plain (S={S}, L={L}, H={H}, A={A})'):
        z0 = simnorm(torch.randn(S, L, device=dev, generator=g), cfg.simnorm_dim)
        actions = torch.rand(H, S, A, device=dev, generator=g) * 2 - 1
        eps = torch.randn(S, A, device=dev, generator=g)
        qidx = torch.tensor([1, 3], dtype=torch.int32, device=dev)
        v_args = (prep, z0, actions, eps, qidx, agent.discs)
        v_k = value.value_estimate(*v_args, **heads)
        v_p = value.value_estimate_plain(*v_args, **heads)
        torch.cuda.synchronize()
        if v_k.shape != (S, 1) or float(v_p.std()) == 0.0:
            raise AssertionError('value: wrong shape or tied values')
        results['value'] = hold('value', v_k, v_p, VALUE_TOL)
        log(f'  value range [{float(v_p.min()):.3f}, {float(v_p.max()):.3f}]')

    with Phase('plain value (f32) vs the model heads (f32)'):
        prep32 = value.prepare_value_params(agent.params, cfg, torch.float32)
        n = 64
        hold('value_f32_vs_heads',
             value.value_estimate_plain(prep32, z0[:n], actions[:, :n],
                                        eps[:n], qidx, agent.discs, **heads),
             agent._estimate_value(z0[:n], actions[:, :n], eps[:n], qidx),
             REF_TOL)

    obs = torch.randn(1, cfg.obs_shape['state'][0], device=dev, generator=g)
    zenc = agent.model.encode(agent.params, obs)
    noise = agent.draw_noise()

    with Phase(f'pi rollout kernel vs plain (n_pi={n_pi})'):
        pi_args = (prep, zenc, noise.pi_eps[:n_pi])
        pa_k = cem.pi_rollout(*pi_args, **heads)
        pa_p = cem.pi_rollout_plain(*pi_args, **heads)
        results['cem_pi_rollout'] = hold('pi_rollout', pa_k, pa_p, PI_TOL)

    mean0 = torch.zeros(H * A, device=dev)
    std0 = torch.full((H * A,), cfg.max_std, device=dev)
    with Phase('sample kernel vs plain'):
        s_args = (mean0 + 0.1, std0, noise.sample[0], pa_p, agent.amask)
        acts = cem.sample_actions(*s_args)
        results['cem_sample'] = hold('sample', acts,
                                     cem.sample_actions_plain(*s_args),
                                     SAMPLE_TOL)

    elite_kw = dict(num_elites=E, temperature=cfg.temperature,
                    min_std=cfg.min_std, max_std=cfg.max_std)
    with Phase('elite kernel vs plain on identical values'):
        v_in = value.value_estimate(prep, zenc.expand(S, L),
                                    acts.view(S, H, A).permute(1, 0, 2),
                                    noise.eps[0], noise.qidx[0], agent.discs,
                                    **heads)
        errs = []
        for label, vv in (('distinct', v_in), ('all tied', torch.zeros_like(v_in))):
            mk, sk, gk = cem.elite_moments(vv, acts, agent.amask, **elite_kw)
            mp, sp, gp = cem.elite_moments_plain(vv, acts, agent.amask, **elite_kw)
            errs += [hold(f'elite mean ({label})', mk, mp, ELITE_TOL),
                     hold(f'elite std ({label})', sk, sp, ELITE_TOL),
                     hold(f'elite guarded v ({label})', gk, gp, SAMPLE_TOL)]
        results['cem_elite'] = max(errs)

    with Phase(f'cem_plan vs cem_plan_plain ({I} iterations)'):
        plan_kw = dict(iterations=I, n_pi=n_pi, **elite_kw, **heads)
        plan_args = (prep, zenc, noise.pi_eps, noise.sample, noise.eps,
                     noise.qidx, agent.discs, mean0, std0, agent.amask)
        mk, sk, vk, ak = cem.cem_plan(*plan_args, **plan_kw)
        mp, sp, vp, ap = cem.cem_plan_plain(*plan_args, **plan_kw)
        hold('cem_plan mean', mk, mp, CEM_TOL)
        hold('cem_plan std', sk, sp, CEM_TOL)
        if vk.shape != (S, 1) or ak.shape != (S, H * A):
            raise AssertionError('cem_plan: wrong output shapes')

    wrappers = {'value': value.value_estimate,
                'cem_pi_rollout': cem.pi_rollout,
                'cem_sample': cem.sample_actions,
                'cem_elite': cem.elite_moments}
    with Phase('main path: evaluate toy-reach, 5M model, 2 episodes'):
        ev_cfg = load_cfg(overrides=['task=toy-reach', 'eval_episodes=2',
                                     f'seed={SEED}', 'device=cuda'])
        for w in wrappers.values():
            w.launches = 0
        res = evaluate(ev_cfg)['toy-reach']
        launches = {k: w.launches for k, w in wrappers.items()}
        log(f'  reward {res["reward"]:.4f}, {res["plans"]} plans, '
            f'{res["plans"] / res["seconds"]:.1f} plans/s; launches {launches}')
        if not math.isfinite(res['reward']):
            raise AssertionError('evaluate: non-finite reward')
        for k, n in launches.items():
            if n <= 0:
                raise AssertionError(f'evaluate: kernel {k} never launched')

    with Phase('timing (CUDA events) and bounds'):
        HA = H * A
        W = [prep[k] for k in value.PREP_NAMES]
        q_heads = [k for k in value.PREP_NAMES if k[0] == 'q']
        w_all = nbytes(*[t for k, t in zip(value.PREP_NAMES, W) if k[0] != 'q'])
        w_q2 = 2 * nbytes(*[prep[k][0] for k in q_heads])
        M, B = prep['dWz'].shape[1], prep['rW2'].shape[1]
        mac_rew = L * M + A * M + M * M + M * B
        mac_dyn = L * M + A * M + M * M + M * L
        mac_pi = L * M + M * M + 2 * M * A
        v_flops = 2 * S * (H * (mac_rew + mac_dyn) + mac_pi + 2 * mac_rew)
        v_bytes = w_all + w_q2 + nbytes(z0, actions, eps, qidx, agent.discs) + S * 4
        pi_w = nbytes(*[prep[k] for k in value.PREP_NAMES if k[0] in 'dp'])
        pi_flops = 2 * n_pi * H * (mac_pi + mac_dyn)
        pi_bytes = pi_w + nbytes(zenc, noise.pi_eps[:n_pi]) + n_pi * HA * 4
        s_bytes = nbytes(mean0, std0, noise.sample[0], pa_p, agent.amask) + S * HA * 4
        e_bytes = nbytes(v_in, acts, agent.amask) + S * 4 + 2 * HA * 4
        e_flops = 35 * S + 8 * S * HA
        timed = {
            'value': (lambda: value.value_estimate(*v_args, **heads),
                      lambda: value.value_estimate_plain(*v_args, **heads),
                      bound_ms(v_bytes, v_flops, BF16_FLOPS)),
            'cem_pi_rollout': (lambda: cem.pi_rollout(*pi_args, **heads),
                               lambda: cem.pi_rollout_plain(*pi_args, **heads),
                               bound_ms(pi_bytes, pi_flops, BF16_FLOPS)),
            'cem_sample': (lambda: cem.sample_actions(*s_args),
                           lambda: cem.sample_actions_plain(*s_args),
                           bound_ms(s_bytes, 3 * S * HA, F32_FLOPS)),
            'cem_elite': (lambda: cem.elite_moments(v_in, acts, agent.amask, **elite_kw),
                          lambda: cem.elite_moments_plain(v_in, acts, agent.amask,
                                                          **elite_kw),
                          bound_ms(e_bytes, e_flops, F32_FLOPS)),
        }
        source = {'value': 'tdmpc2_tpu_torch/csrc/value.cu'}
        replaces = {'value': 'tdmpc2_tpu/ops/pallas_rollout.py:437'}
        kernels = []
        for name, (kern, plain, (b_ms, b_by)) in timed.items():
            ms = time_ms(kern, 50)
            plain_ms = time_ms(plain, 10)
            log(f'  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
                f'bound {b_ms:.5f} ms ({b_by})')
            kernels.append({
                'name': name, 'route': 'cuda',
                'source': source.get(name, 'tdmpc2_tpu_torch/csrc/cem.cu'),
                'replaces': replaces.get(name, 'tdmpc2_tpu/ops/pallas_cem.py:53'),
                'launches': launches[name], 'max_abs_err': results[name],
                'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms,
                'bound_by': b_by, 'library_ms': None})
        plan_ms = time_ms(lambda: cem.cem_plan(*plan_args, **plan_kw), 10)
        plan_plain_ms = time_ms(lambda: cem.cem_plan_plain(*plan_args, **plan_kw), 3)
        log(f'  whole cem_plan: kernels {plan_ms:.3f} ms, plain {plan_plain_ms:.3f} ms; '
            f'value flops/call {v_flops / 1e9:.2f} G')

    log(f'[done] {time.perf_counter() - t_start:.1f} s')
    log(smi)
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
