"""Pure-numpy CI environment — no physics dependency (a copy of
tdmpc2_tpu/envs/toy.py).

A 2-D point-mass reach task with known-optimal behavior: the agent applies
bounded accelerations to drive the mass to a fixed goal; reward is a smooth
negative-distance shaping in [0, 1]. Used by the integration tests (SURVEY.md
§4) so the full train-loop/buffer/eval stack runs without MuJoCo.
"""

from __future__ import annotations

import numpy as np

from tdmpc2_tpu_torch.envs.base import Env, NormalizeInfo, Timeout


class _Box:
    def __init__(self, low, high, shape, dtype=np.float32):
        self.low = np.full(shape, low, dtype)
        self.high = np.full(shape, high, dtype)
        self.shape = tuple(shape)
        self.dtype = dtype
        self._rng = np.random.default_rng(0)

    def sample(self):
        return self._rng.uniform(self.low, self.high).astype(self.dtype)


class PointMassEnv(Env):
    OBS_DIM = 6   # pos(2), vel(2), goal-pos delta(2)
    ACT_DIM = 2

    def __init__(self, seed: int = 0, episode_length: int = 50):
        self.observation_space = _Box(-np.inf, np.inf, (self.OBS_DIM,))
        self.action_space = _Box(-1.0, 1.0, (self.ACT_DIM,))
        self.max_episode_steps = episode_length
        self._rng = np.random.default_rng(seed)
        self._dt = 0.1
        self._goal = np.array([0.5, -0.3], np.float32)

    def _obs(self):
        return np.concatenate(
            [self._pos, self._vel, self._goal - self._pos]).astype(np.float32)

    def reset(self):
        self._pos = self._rng.uniform(-1, 1, 2).astype(np.float32)
        self._vel = np.zeros(2, np.float32)
        return self._obs()

    def step(self, action):
        a = np.clip(np.asarray(action, np.float32), -1, 1)
        self._vel = 0.9 * self._vel + self._dt * a
        self._pos = np.clip(self._pos + self._dt * self._vel, -2, 2)
        dist = float(np.linalg.norm(self._goal - self._pos))
        reward = float(np.exp(-4.0 * dist))
        info = {'success': float(dist < 0.1), 'terminated': 0.0}
        return self._obs(), reward, False, info

    def render(self, *args, **kwargs):
        img = np.zeros((64, 64, 3), np.uint8)
        px = ((self._pos + 2) / 4 * 63).astype(int)
        gx = ((self._goal + 2) / 4 * 63).astype(int)
        img[px[1], px[0]] = (255, 255, 255)
        img[gx[1], gx[0]] = (0, 255, 0)
        return img


class EpisodicPointMassEnv(PointMassEnv):
    """Episodic variant: terminates on reaching the goal (exercises the
    terminated-bootstrap path, reference envs/mujoco.py:24-31 analogue)."""

    def step(self, action):
        obs, reward, done, info = super().step(action)
        if info['success']:
            info['terminated'] = 1.0
            done = True
        return obs, reward, done, info


def make_env(cfg):
    if cfg.task not in ('toy-reach', 'toy', 'toy-reach-episodic'):
        raise ValueError('Unknown task:', cfg.task)
    if cfg.task == 'toy-reach-episodic':
        env = EpisodicPointMassEnv(seed=cfg.seed)
    else:
        env = PointMassEnv(seed=cfg.seed)
    env = Timeout(env, max_episode_steps=50)
    return NormalizeInfo(env)
