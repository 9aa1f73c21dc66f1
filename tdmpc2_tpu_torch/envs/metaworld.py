"""Meta-World adapter (50 mw-* manipulation tasks; a copy of
tdmpc2_tpu/envs/metaworld.py).

Behavioral parity with the reference adapter (reference: tdmpc2/envs/
metaworld.py:8-52): task name 'mw-x' -> 'x-v2-goal-observable', corner2
camera repositioned, unfrozen goal randomization, an extra zero-action step
after reset, action repeat 2, never terminates, 100-step timeout.

Where the metaworld package does not import, make_env raises
ValueError, so the factory chain degrades exactly like the reference
(envs/__init__.py:12-31).
"""

from __future__ import annotations

import numpy as np

from tdmpc2_tpu_torch.envs.base import Env, NormalizeInfo, Timeout

ACTION_REPEAT = 2
EPISODE_STEPS = 100


class MetaWorldAdapter(Env):
    def __init__(self, env):
        self._env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        # reposition the corner2 camera (reference metaworld.py:13-14)
        self.camera_name = 'corner2'
        env.model.cam_pos[2] = [0.75, 0.075, 0.7]
        env._freeze_rand_vec = False

    def reset(self):
        obs = self._env.reset()
        if isinstance(obs, tuple):
            obs = obs[0]
        # settle one zero step (reference metaworld.py:17-20)
        self._env.step(np.zeros(self._env.action_space.shape))
        return np.asarray(obs, np.float32)

    def step(self, action):
        reward = 0.0
        for _ in range(ACTION_REPEAT):
            out = self._env.step(np.asarray(action).copy())
            obs, r, info = out[0], out[1], out[-1]
            reward += r
        return np.asarray(obs, np.float32), reward, False, dict(info)

    def render(self, *args, **kwargs):
        return self._env.render(
            offscreen=True, resolution=(384, 384),
            camera_name=self.camera_name).copy()


def make_env(cfg):
    if not cfg.task.startswith('mw-'):
        raise ValueError('Unknown task:', cfg.task)
    if cfg.obs != 'state':
        raise ValueError('Meta-World supports state observations only.')
    try:
        from metaworld.envs import ALL_V2_ENVIRONMENTS_GOAL_OBSERVABLE
    except ImportError as e:
        raise ValueError(
            f'Missing dependencies for task {cfg.task}: {e}') from e
    env_id = cfg.task.split('-', 1)[-1] + '-v2-goal-observable'
    if env_id not in ALL_V2_ENVIRONMENTS_GOAL_OBSERVABLE:
        raise ValueError('Unknown task:', cfg.task)
    env = ALL_V2_ENVIRONMENTS_GOAL_OBSERVABLE[env_id](seed=cfg.seed)
    env = MetaWorldAdapter(env)
    env = Timeout(env, max_episode_steps=EPISODE_STEPS)
    return NormalizeInfo(env)
