#!/usr/bin/env python
"""Env-steps/s of the port's env copies on the host: random actions through
`tdmpc2_tpu_torch.envs.make_env` with the copies in worker processes
(vec_mode=subproc) and in this process (inproc), in turns.

Usage:
    python scripts/torch_env_rate.py [--task walker-walk] [--obs rgb]
        [--num-envs 4] [--steps 200] [--rounds 2]

No model and no card: it times the env layer alone (a reset, then
`steps` vector steps of `rand_act` and `step`, resets where an episode
ends), in the order subproc, inproc, inproc, subproc, ... for `rounds`
pairs, and prints one JSON line with each mode's rates and the host's
CPU model and core count. The task's backend must import (dm_control
for walker-walk).
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cpu_model() -> str:
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith('model name'):
                    return line.split(':', 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or 'unknown'


def rate(task, obs, num_envs, mode, steps) -> float:
    """Vector steps x num_envs over the seconds they took (the build and
    the first reset excluded)."""
    from tdmpc2_tpu_torch.config import Config, parse_cfg
    from tdmpc2_tpu_torch.envs import make_env
    env = make_env(parse_cfg(Config(task=task, obs=obs, num_envs=num_envs,
                                    vec_mode=mode, device='cpu')))
    try:
        env.reset()
        t0 = time.perf_counter()
        for _ in range(steps):
            _, _, dones, _ = env.step(env.rand_act())
            for i in np.flatnonzero(dones):
                env.reset_at(i)
        return steps * num_envs / (time.perf_counter() - t0)
    finally:
        if hasattr(env, 'close'):
            env.close()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--task', default='walker-walk')
    ap.add_argument('--obs', default='rgb')
    ap.add_argument('--num-envs', type=int, default=4)
    ap.add_argument('--steps', type=int, default=200)
    ap.add_argument('--rounds', type=int, default=2)
    a = ap.parse_args()
    rates = {'subproc': [], 'inproc': []}
    for r in range(a.rounds):
        for mode in (('subproc', 'inproc') if r % 2 == 0 else ('inproc', 'subproc')):
            rates[mode].append(rate(a.task, a.obs, a.num_envs, mode, a.steps))
            print(f'{mode}: {rates[mode][-1]:.1f} env-steps/s', file=sys.stderr)
    print(json.dumps({
        'task': a.task, 'obs': a.obs, 'num_envs': a.num_envs, 'steps': a.steps,
        'env_steps_per_s': rates,
        'median': {k: float(np.median(v)) for k, v in rates.items()},
        'host': {'cpu': cpu_model(), 'cores': os.cpu_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
