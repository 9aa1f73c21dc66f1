"""DeepMind Control Suite adapter (a copy of tdmpc2_tpu/envs/dmcontrol.py).

Behavioral parity with the reference adapter (reference: tdmpc2/envs/
dmcontrol.py:27-111): OrderedDict observations flattened to one float32
vector, fixed action repeat of 2, actions rescaled to [-1, 1], 500-step
timeout, quadruped renders from camera 2, and a pixel mode that stacks three
64x64 RGB frames channel-first (`PixelObs`).

`make_env` registers the custom tasks (cup-spin, cheetah-jump, ...:
`envs.tasks`) before it queries the suite. Importing this module imports no
dm_control: `make_env` imports it, sets `MUJOCO_GL=egl` (offscreen
rendering) first unless the caller chose a backend, and raises ValueError
where dm_control or MuJoCo does not import, so the factory chain goes on to
the next adapter. `PixelObs` wraps any env of the port's protocol whose
`render(width=, height=, fast=)` returns an [H, W, 3] uint8 frame (the
dm_control adapter's, or the toy point mass's).
"""

from __future__ import annotations

import os
from collections import deque

import numpy as np

from tdmpc2_tpu_torch.envs.base import Env, NormalizeInfo, Timeout, Wrapper

ACTION_REPEAT = 2
EPISODE_STEPS = 500  # after action repeat: 1000 physics control steps


class _Box:
    def __init__(self, low, high, shape, dtype):
        self.low, self.high = np.broadcast_to(low, shape), np.broadcast_to(high, shape)
        self.shape, self.dtype = tuple(shape), dtype
        self._rng = np.random.default_rng(0)

    def sample(self):
        return self._rng.uniform(self.low, self.high).astype(np.float32)


def _flat_obs_size(env) -> int:
    total = 0
    for v in env.observation_spec().values():
        total += int(np.prod(v.shape)) if v.shape else 1
    return total


class DMControlAdapter(Env):
    """dm_env -> framework protocol, with action repeat."""

    def __init__(self, env, domain: str):
        self._env = env
        self.camera_id = 2 if domain == 'quadruped' else 0
        n_obs = _flat_obs_size(env)
        spec = env.action_spec()
        self.observation_space = _Box(-np.inf, np.inf, (n_obs,), np.float32)
        self.action_space = _Box(spec.minimum, spec.maximum, spec.shape, spec.dtype)
        self.max_episode_steps = EPISODE_STEPS

    @staticmethod
    def _flatten(obs_dict):
        return np.concatenate(
            [np.atleast_1d(np.asarray(v)).ravel() for v in obs_dict.values()]
        ).astype(np.float32)

    def reset(self):
        return self._flatten(self._env.reset().observation)

    def step(self, action):
        action = np.asarray(action, self.action_space.dtype)
        reward = 0.0
        for _ in range(ACTION_REPEAT):
            ts = self._env.step(action)
            reward += ts.reward
        return self._flatten(ts.observation), reward, False, {}

    def render(self, width=384, height=384, camera_id=None, fast=False):
        """`fast=True` drops shadows and reflections, which dominate a
        software-GL frame and carry almost no signal at 64 px; the PixelObs
        observations use it, a video keeps the defaults."""
        kw = (dict(render_flag_overrides=dict(shadow=False, reflection=False))
              if fast else {})
        return self._env.physics.render(
            height, width, camera_id if camera_id is not None else self.camera_id,
            **kw)


class PixelObs(Wrapper):
    """A stack of `num_frames` size x size RGB frames, channel-first uint8
    [num_frames * 3, size, size], oldest first; a reset repeats its frame
    (reference envs/dmcontrol.py:66-89)."""

    def __init__(self, env, num_frames: int = 3, size: int = 64):
        super().__init__(env)
        self._frames = deque(maxlen=num_frames)
        self._size = size
        self.observation_space = _Box(
            0, 255, (num_frames * 3, size, size), np.uint8)

    def _obs(self, reset=False):
        frame = self.env.render(
            width=self._size, height=self._size, fast=True).transpose(2, 0, 1)
        for _ in range(self._frames.maxlen if reset else 1):
            self._frames.append(frame)
        return np.concatenate(self._frames)

    def reset(self):
        self.env.reset()
        return self._obs(reset=True)

    def step(self, action):
        _, reward, done, info = self.env.step(action)
        return self._obs(), reward, done, info


_DOMAIN_ALIASES = dict(cup='ball_in_cup', pointmass='point_mass')


def make_env(cfg):
    """Make a DMControl env (standard suite + this framework's custom tasks)."""
    os.environ.setdefault('MUJOCO_GL', 'egl')   # before mujoco picks a GL platform
    try:
        from dm_control import suite
        from dm_control.suite.wrappers import action_scale
    except ImportError as e:
        raise ValueError(f'Missing dependencies for task {cfg.task}: {e}') from e
    from tdmpc2_tpu_torch.envs import tasks
    tasks.register_all()    # the custom tasks, before querying the suite

    domain, task = cfg.task.replace('-', '_').split('_', 1)
    domain = _DOMAIN_ALIASES.get(domain, domain)
    if (domain, task) not in suite.ALL_TASKS:
        raise ValueError('Unknown task:', cfg.task)
    if cfg.obs not in ('state', 'rgb'):
        raise ValueError('DMControl supports state and rgb observations only.')
    env = suite.load(domain, task,
                     task_kwargs={'random': cfg.seed},
                     visualize_reward=False)
    env = action_scale.Wrapper(env, minimum=-1.0, maximum=1.0)
    env = DMControlAdapter(env, domain)
    if cfg.obs == 'rgb':
        env = PixelObs(env)
    env = Timeout(env, max_episode_steps=EPISODE_STEPS)
    return NormalizeInfo(env)
