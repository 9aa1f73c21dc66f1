"""MyoSuite adapter (10 myo-* hand-dexterity tasks; a copy of
tdmpc2_tpu/envs/myosuite.py).

Behavioral parity with the reference adapter (reference: tdmpc2/envs/
myosuite.py:6-58): registry of 10 tasks, success = info['solved'], no action
repeat, never terminates, 100-step timeout, hand-camera offscreen render.

Where the myosuite package does not import, make_env raises
ValueError, so the factory chain degrades gracefully.
"""

from __future__ import annotations

import numpy as np

from tdmpc2_tpu_torch.envs.base import Env, NormalizeInfo, Timeout

MYOSUITE_TASKS = {
    'myo-reach': 'myoHandReachFixed-v0',
    'myo-reach-hard': 'myoHandReachRandom-v0',
    'myo-pose': 'myoHandPoseFixed-v0',
    'myo-pose-hard': 'myoHandPoseRandom-v0',
    'myo-obj-hold': 'myoHandObjHoldFixed-v0',
    'myo-obj-hold-hard': 'myoHandObjHoldRandom-v0',
    'myo-key-turn': 'myoHandKeyTurnFixed-v0',
    'myo-key-turn-hard': 'myoHandKeyTurnRandom-v0',
    'myo-pen-twirl': 'myoHandPenTwirlFixed-v0',
    'myo-pen-twirl-hard': 'myoHandPenTwirlRandom-v0',
}

EPISODE_STEPS = 100


class MyoSuiteAdapter(Env):
    def __init__(self, env):
        self._env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self.camera_id = 'hand_side_inter'

    def reset(self):
        out = self._env.reset()
        return out[0] if isinstance(out, tuple) else out

    def step(self, action):
        obs, reward, _term, _trunc, info = self._env.step(
            np.asarray(action).copy())
        info = dict(info)
        info['success'] = float(info.get('solved', 0.0))
        return obs, reward, False, info

    def render(self, *args, **kwargs):
        return self._env.sim.renderer.render_offscreen(
            width=384, height=384, camera_id=self.camera_id).copy()


def make_env(cfg):
    if cfg.task not in MYOSUITE_TASKS:
        raise ValueError('Unknown task:', cfg.task)
    if cfg.obs != 'state':
        raise ValueError('MyoSuite supports state observations only.')
    try:
        import myosuite  # noqa: F401
        from myosuite.utils import gym as myo_gym
    except ImportError as e:
        raise ValueError(
            f'Missing dependencies for task {cfg.task}: {e}') from e
    env = myo_gym.make(MYOSUITE_TASKS[cfg.task])
    env = MyoSuiteAdapter(env)
    env = Timeout(env, max_episode_steps=EPISODE_STEPS)
    return NormalizeInfo(env)
