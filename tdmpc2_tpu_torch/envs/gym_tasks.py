"""Gymnasium MuJoCo / Box2D adapter (episodic tasks; a copy of
tdmpc2_tpu/envs/gym_tasks.py).

Behavioral parity with the reference adapter (reference: tdmpc2/envs/
mujoco.py:6-59): true `terminated` passthrough (these are the episodic
tasks), lunarlander success = cumulative reward > 200, per-task timeouts,
and the reference's config mutation (discount_max=0.99, rho=0.7).

Where Gymnasium (or the task's MuJoCo or Box2D) does not import, make_env
raises ValueError, so the factory chain degrades as for the other
adapters.
"""

from __future__ import annotations

import numpy as np

from tdmpc2_tpu_torch.envs.base import Env, NormalizeInfo, Timeout

GYM_TASKS = {
    'mujoco-walker': ('Walker2d-v5', {}),
    'mujoco-halfcheetah': ('HalfCheetah-v5', {}),
    'bipedal-walker': ('BipedalWalker-v3', {}),
    'lunarlander-continuous': ('LunarLander-v3', dict(continuous=True)),
}

_TIMEOUTS = {'lunarlander-continuous': 500, 'bipedal-walker': 1600}


class GymAdapter(Env):
    def __init__(self, env, track_success: bool):
        self._env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self._track_success = track_success
        self._cum_reward = 0.0

    def rand_act(self):
        return self._env.action_space.sample().astype(np.float32)

    def reset(self):
        self._cum_reward = 0.0
        obs, _info = self._env.reset()
        return obs

    def step(self, action):
        obs, reward, terminated, truncated, info = self._env.step(
            np.asarray(action).copy())
        self._cum_reward += reward
        info = dict(info)
        info['terminated'] = float(terminated)
        if self._track_success:
            info['success'] = float(self._cum_reward > 200)
        return obs, reward, bool(terminated or truncated), info

    def render(self, *args, **kwargs):
        return self._env.render()


def make_env(cfg):
    if cfg.task not in GYM_TASKS:
        raise ValueError('Unknown task:', cfg.task)
    if cfg.obs != 'state':
        raise ValueError('These tasks support state observations only.')
    env_id, kwargs = GYM_TASKS[cfg.task]
    try:
        import gymnasium as gym
        env = gym.make(env_id, render_mode='rgb_array', **kwargs)
    except ImportError as e:
        raise ValueError(
            f'Missing dependencies for task {cfg.task}: {e}') from e
    env = GymAdapter(env, track_success=cfg.task == 'lunarlander-continuous')
    env = Timeout(env, max_episode_steps=_TIMEOUTS.get(cfg.task, 1000))
    # reference quirk: these episodic envs override two training knobs
    cfg.discount_max = 0.99
    cfg.rho = 0.7
    return NormalizeInfo(env)
