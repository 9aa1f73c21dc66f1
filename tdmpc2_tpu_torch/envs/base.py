"""Environment protocol and shared wrappers (a copy of tdmpc2_tpu/envs/base.py).

All environments in this framework speak one numpy protocol (the analogue of
the reference's TensorWrapper-normalized gym API, envs/wrappers/tensor.py):

    reset() -> obs: np.float32 array (or dict of arrays)
    step(action: np.float32) -> (obs, reward: float, done: bool, info: dict)
    rand_act() -> np.float32 action
    max_episode_steps, observation_space, action_space, render()

`info` always contains float 'success' and float 'terminated' (defaulted to 0
when the backend does not provide them).
"""

from __future__ import annotations

import numpy as np


class Env:
    """Minimal base: stores spaces; subclasses implement reset/step."""

    observation_space = None
    action_space = None
    max_episode_steps = None

    def rand_act(self):
        return self.action_space.sample().astype(np.float32)

    def render(self, *args, **kwargs):
        raise NotImplementedError


class Wrapper(Env):
    def __init__(self, env):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self.max_episode_steps = getattr(env, 'max_episode_steps', None)

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, **kwargs):
        return self.env.reset(**kwargs)

    def step(self, action):
        return self.env.step(action)

    def render(self, *args, **kwargs):
        return self.env.render(*args, **kwargs)


class Timeout(Wrapper):
    """Fixed-length episodes: done after `max_episode_steps` env steps
    (reference envs/wrappers/timeout.py)."""

    def __init__(self, env, max_episode_steps: int):
        super().__init__(env)
        self.max_episode_steps = max_episode_steps
        self._t = 0

    def reset(self, **kwargs):
        self._t = 0
        return self.env.reset(**kwargs)

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        self._t += 1
        done = done or self._t >= self.max_episode_steps
        return obs, reward, done, info


class NormalizeInfo(Wrapper):
    """Guarantee float32 obs/reward and default info keys
    (reference envs/wrappers/tensor.py)."""

    def _obs(self, obs):
        if isinstance(obs, dict):
            return {k: np.asarray(v) for k, v in obs.items()}
        obs = np.asarray(obs)
        return obs.astype(np.float32) if obs.dtype == np.float64 else obs

    def reset(self, **kwargs):
        return self._obs(self.env.reset(**kwargs))

    def step(self, action):
        obs, reward, done, info = self.env.step(np.asarray(action))
        info = dict(info)
        info['success'] = float(info.get('success', 0.0))
        info['terminated'] = float(info.get('terminated', 0.0))
        return self._obs(obs), np.float32(reward), bool(done), info
