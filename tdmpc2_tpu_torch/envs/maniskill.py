"""ManiSkill2 adapter (5 robotic manipulation tasks; a copy of
tdmpc2_tpu/envs/maniskill.py).

Behavioral parity with the reference adapter (reference: tdmpc2/envs/
maniskill.py:8-82): 5-task registry with per-task control modes, symmetrized
action box, action repeat 2 with early break on done, info['terminated']
passthrough, 100-step timeout.

Where the mani_skill2 package does not import, make_env raises
ValueError, so the factory chain degrades gracefully.
"""

from __future__ import annotations

import numpy as np

from tdmpc2_tpu_torch.envs.base import Env, NormalizeInfo, Timeout

MANISKILL_TASKS = {
    'lift-cube': dict(env='LiftCube-v0', control_mode='pd_ee_delta_pos'),
    'pick-cube': dict(env='PickCube-v0', control_mode='pd_ee_delta_pos'),
    'stack-cube': dict(env='StackCube-v0', control_mode='pd_ee_delta_pos'),
    'pick-ycb': dict(env='PickSingleYCB-v0', control_mode='pd_ee_delta_pose'),
    'turn-faucet': dict(env='TurnFaucet-v0', control_mode='pd_ee_delta_pose'),
}

ACTION_REPEAT = 2
EPISODE_STEPS = 100


class _SymBox:
    """Symmetrized action box (reference maniskill.py:38-42)."""

    def __init__(self, space):
        self.low = np.full(space.shape, space.low.min(), space.dtype)
        self.high = np.full(space.shape, space.high.max(), space.dtype)
        self.shape, self.dtype = tuple(space.shape), space.dtype
        self._rng = np.random.default_rng(0)

    def sample(self):
        return self._rng.uniform(self.low, self.high).astype(np.float32)


class ManiSkillAdapter(Env):
    def __init__(self, env):
        self._env = env
        self.observation_space = env.observation_space
        self.action_space = _SymBox(env.action_space)

    def reset(self):
        out = self._env.reset()
        return out[0] if isinstance(out, tuple) else out

    def step(self, action):
        reward = 0.0
        for _ in range(ACTION_REPEAT):
            out = self._env.step(np.asarray(action))
            if len(out) == 5:
                obs, r, term, trunc, info = out
                done = bool(term or trunc)
                info = dict(info, terminated=float(term))
            else:
                obs, r, done, info = out
                info = dict(info, terminated=float(done))
            reward += r
            if done:
                break
        return obs, reward, done, info

    def render(self, *args, **kwargs):
        return self._env.render(mode='cameras')


def make_env(cfg):
    if cfg.task not in MANISKILL_TASKS:
        raise ValueError('Unknown task:', cfg.task)
    if cfg.obs != 'state':
        raise ValueError('ManiSkill2 supports state observations only.')
    try:
        import gymnasium as gym
        import mani_skill2.envs  # noqa: F401
    except ImportError as e:
        raise ValueError(
            f'Missing dependencies for task {cfg.task}: {e}') from e
    task_cfg = MANISKILL_TASKS[cfg.task]
    env = gym.make(task_cfg['env'], obs_mode='state',
                   control_mode=task_cfg['control_mode'],
                   render_camera_cfgs=dict(width=384, height=384))
    env = ManiSkillAdapter(env)
    env = Timeout(env, max_episode_steps=EPISODE_STEPS)
    return NormalizeInfo(env)
