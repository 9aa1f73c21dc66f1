"""Multi-task environment wrapper (a copy of tdmpc2_tpu/envs/multitask.py;
reference tdmpc2/envs/wrappers/multitask.py).

Holds one env per task; observations are zero-padded to the largest obs
dim, actions are cut to the active task's dim, and reset(task_idx)
switches the active sub-env.
"""

from __future__ import annotations

import numpy as np

from tdmpc2_tpu_torch.envs.base import Env


class _Box:
    def __init__(self, low, high, shape):
        self.low = np.full(shape, low, np.float32)
        self.high = np.full(shape, high, np.float32)
        self.shape = tuple(shape)
        self.dtype = np.float32
        self._rng = np.random.default_rng(0)

    def sample(self):
        return self._rng.uniform(self.low, self.high).astype(np.float32)


class MultitaskEnv(Env):
    def __init__(self, cfg, envs):
        self.cfg = cfg
        self.envs = envs
        self._task_idx = 0
        self.obs_dims = [e.observation_space.shape[0] for e in envs]
        self.action_dims = [e.action_space.shape[0] for e in envs]
        self.episode_lengths = [e.max_episode_steps for e in envs]
        self._obs_dim = max(self.obs_dims)
        self._action_dim = max(self.action_dims)
        self.observation_space = _Box(-np.inf, np.inf, (self._obs_dim,))
        self.action_space = _Box(-1.0, 1.0, (self._action_dim,))

    @property
    def task_idx(self):
        return self._task_idx

    @property
    def task(self):
        return self.cfg.tasks[self._task_idx]

    @property
    def _env(self):
        return self.envs[self._task_idx]

    @property
    def max_episode_steps(self):
        return self._env.max_episode_steps

    def _pad(self, obs):
        obs = np.asarray(obs, np.float32)
        if obs.shape[0] < self._obs_dim:
            obs = np.concatenate(
                [obs, np.zeros(self._obs_dim - obs.shape[0], np.float32)])
        return obs

    def reset(self, task_idx: int = -1):
        self._task_idx = task_idx % len(self.envs)
        return self._pad(self._env.reset())

    def step(self, action):
        a = np.asarray(action)[: self.action_dims[self._task_idx]]
        obs, reward, done, info = self._env.step(a)
        return self._pad(obs), reward, done, info

    def rand_act(self):
        return self.action_space.sample()

    def render(self, *args, **kwargs):
        return self._env.render(*args, **kwargs)
