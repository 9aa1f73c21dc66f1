"""Evaluation entry point (port of tdmpc2_tpu/evaluate.py).

Usage:
    python -m tdmpc2_tpu_torch.evaluate task=toy-reach eval_episodes=2
    python -m tdmpc2_tpu_torch.evaluate task=toy-reach device=cpu
    python -m tdmpc2_tpu_torch.evaluate task=toy-reach-episodic episodic=true
    python -m tdmpc2_tpu_torch.evaluate task=toy-reach checkpoint=<file>
    python -m tdmpc2_tpu_torch.evaluate task=acrobot-swingup checkpoint=<file>

Runs `eval_episodes` greedy-planning episodes and reports the mean return.
`device` defaults to `cuda`, where the planner runs on the hand-written
kernels; without a card that raises unless `device=cpu` is given. With
`checkpoint=<file>` the weights come from a checkpoint (`TDMPC2.load`,
which refuses one whose architecture differs from the config's): a
pickle of this port or of the JAX package, full or stripped, gzipped or
not (read without jax, optax or ml_dtypes), or a reference PyTorch `.pt`
checkpoint; without one the agent keeps its fresh weights, drawn from
`seed`.

A multi-task config evaluates every task, all tasks' episodes in lockstep
through one `act_tasks` plan a step (JAX evaluate.py:36-75; a pi-only
agent, `mpc=false`, one task after another), and prints each task's return
and success and the normalized score (success x 100 on Meta-World tasks,
return / 10 elsewhere; reference evaluate.py:93-99).
The env is any task the JAX package builds, where its backend imports
(envs/__init__.py), or one given to `evaluate(cfg, env)` (a pixel env
around any env that renders). `save_video=true` raises: the recorder is
ROADMAP A12.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from tdmpc2_tpu_torch.config import load_cfg
from tdmpc2_tpu_torch.envs import make_env
from tdmpc2_tpu_torch.tdmpc2 import TDMPC2, device_of
from tdmpc2_tpu_torch.utils.seed import set_seed


def evaluate(cfg, env=None) -> dict:
    """-> {task: {'reward', 'success', 'lengths', 'plans', 'seconds'}}:
    mean episode return and success, each episode's length, and the plans
    made in `seconds` of acting (for a multi-task config, the lockstep
    plans, which serve every task at once). `env` replaces `make_env(cfg)`
    (a pixel env, `PixelObs` around one that renders); cfg's env fields
    must then be set to its spaces."""
    if cfg.save_video:
        raise NotImplementedError('save_video=true: the eval video recorder '
                                  'is a later part of the port (ROADMAP A12)')
    device_of(cfg.device)       # raise before any work when there is no card
    set_seed(cfg.seed)
    env = make_env(cfg) if env is None else env
    agent = TDMPC2(cfg)
    if cfg.checkpoint:
        agent.load(cfg.checkpoint)      # raises on an architecture mismatch
    if cfg.multitask and cfg.mpc:
        return _evaluate_tasks(cfg, env, agent)

    # one task after another (a multi-task pi-only agent: each task's
    # episodes through `act(task=i)`, JAX evaluate.py:77-118)
    results, scores = {}, []
    for task_idx, task in enumerate(cfg.tasks if cfg.multitask else [cfg.task]):
        idx = task_idx if cfg.multitask else None
        rewards, successes, lengths, plans, seconds = [], [], [], 0, 0.0
        for _ in range(cfg.eval_episodes):
            obs = env.reset(task_idx) if cfg.multitask else env.reset()
            done, ep_reward, t, info = False, 0.0, 0, {}
            while not done:
                t0 = time.perf_counter()
                action = agent.act(obs, t0=(t == 0), eval_mode=True, task=idx)
                seconds += time.perf_counter() - t0
                plans += 1
                obs, reward, done, info = env.step(action)
                ep_reward += reward
                t += 1
            rewards.append(ep_reward)
            successes.append(info.get('success', 0.0))
            lengths.append(t)
        r, s = float(np.nanmean(rewards)), float(np.nanmean(successes))
        print(f'  {task:<28s} R: {r:8.1f}  S: {s:.2f}  '
              f'({plans / seconds:.1f} plans/s on {agent.device})')
        results[task] = {'reward': r, 'success': s, 'lengths': lengths,
                         'plans': plans, 'seconds': seconds}
        scores.append(s * 100 if task.startswith('mw-') else r / 10)
    if cfg.multitask:
        print(f'Normalized score: {np.nanmean(scores):.2f}')
    return results


def _evaluate_tasks(cfg, env, agent) -> dict:
    """Every task's episodes in lockstep, one `act_tasks` plan a step for
    all tasks still running (JAX evaluate.py:41-75)."""
    envs = env.envs
    n = len(envs)
    H, A = cfg.horizon, cfg.action_dim
    rewards = [[] for _ in range(n)]
    successes = [[] for _ in range(n)]
    lengths = [[] for _ in range(n)]
    plans, seconds = 0, 0.0
    for _ in range(cfg.eval_episodes):
        obs = np.stack([env._pad(e.reset()) for e in envs])
        prev_mean = np.zeros((n, H, A), np.float32)
        t0 = np.ones(n, bool)
        active = np.ones(n, bool)
        ep_reward, ep_len = np.zeros(n), np.zeros(n, int)
        while active.any():
            start = time.perf_counter()
            actions, prev_mean = agent.act_tasks(obs, prev_mean, t0, np.arange(n))
            seconds += time.perf_counter() - start
            plans += 1
            t0[:] = False
            for i in np.flatnonzero(active):
                o, r, done, info = envs[i].step(actions[i][: env.action_dims[i]])
                obs[i] = env._pad(o)
                ep_reward[i] += r
                ep_len[i] += 1
                if done:
                    active[i] = False
                    rewards[i].append(float(ep_reward[i]))
                    successes[i].append(info.get('success', 0.0))
                    lengths[i].append(int(ep_len[i]))
    results, scores = {}, []
    for i, task in enumerate(cfg.tasks):
        r, s = float(np.nanmean(rewards[i])), float(np.nanmean(successes[i]))
        results[task] = {'reward': r, 'success': s, 'lengths': lengths[i],
                         'plans': plans, 'seconds': seconds}
        print(f'  {task:<28s} R: {r:8.1f}  S: {s:.2f}')
        scores.append(s * 100 if task.startswith('mw-') else r / 10)
    print(f'Normalized score: {np.nanmean(scores):.2f}  ({plans / seconds:.1f} '
          f'lockstep plans/s for {n} tasks on {agent.device})')
    return results


def main(argv=None):
    cfg = load_cfg(overrides=(argv if argv is not None else sys.argv[1:]))
    evaluate(cfg)


if __name__ == '__main__':
    main()
