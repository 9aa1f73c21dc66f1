"""Evaluation entry point, single-task (port of tdmpc2_tpu/evaluate.py).

Usage:
    python -m tdmpc2_tpu_torch.evaluate task=toy-reach eval_episodes=2
    python -m tdmpc2_tpu_torch.evaluate task=toy-reach device=cpu
    python -m tdmpc2_tpu_torch.evaluate task=toy-reach-episodic episodic=true

Runs `eval_episodes` greedy-planning episodes and reports the mean return.
`device` defaults to `cuda`, where the planner runs on the hand-written
kernels; without a card that raises unless `device=cpu` is given. With
`checkpoint=<file>` the weights come from a checkpoint of this port or
of the JAX package (`TDMPC2.load`, which refuses one whose architecture
differs from the config's; the committed bf16 files need `ml_dtypes`);
without one the agent keeps its fresh weights, drawn from `seed`.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from tdmpc2_tpu_torch.config import load_cfg
from tdmpc2_tpu_torch.envs import make_env
from tdmpc2_tpu_torch.tdmpc2 import TDMPC2, device_of
from tdmpc2_tpu_torch.utils.seed import set_seed


def evaluate(cfg) -> dict:
    """-> {task: {'reward', 'success', 'lengths', 'plans', 'seconds'}}:
    mean episode return and success, each episode's length, and the plans
    made in `seconds` of acting."""
    device_of(cfg.device)       # raise before any work when there is no card
    set_seed(cfg.seed)
    env = make_env(cfg)
    agent = TDMPC2(cfg)
    if cfg.checkpoint:
        agent.load(cfg.checkpoint)      # raises on an architecture mismatch

    rewards, successes, lengths, plans, seconds = [], [], [], 0, 0.0
    for _ in range(cfg.eval_episodes):
        obs, done, ep_reward, t, info = env.reset(), False, 0.0, 0, {}
        while not done:
            t0 = time.perf_counter()
            action = agent.act(obs, t0=(t == 0), eval_mode=True)
            seconds += time.perf_counter() - t0
            plans += 1
            obs, reward, done, info = env.step(action)
            ep_reward += reward
            t += 1
        rewards.append(ep_reward)
        successes.append(info.get('success', 0.0))
        lengths.append(t)
    r, s = float(np.nanmean(rewards)), float(np.nanmean(successes))
    print(f'  {cfg.task:<28s} R: {r:8.1f}  S: {s:.2f}  '
          f'({plans / seconds:.1f} plans/s on {agent.device})')
    return {cfg.task: {'reward': r, 'success': s, 'lengths': lengths,
                       'plans': plans, 'seconds': seconds}}


def main(argv=None):
    cfg = load_cfg(overrides=(argv if argv is not None else sys.argv[1:]))
    evaluate(cfg)


if __name__ == '__main__':
    main()
