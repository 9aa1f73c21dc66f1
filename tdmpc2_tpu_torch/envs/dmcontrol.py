"""DeepMind Control Suite: the pixel observation wrapper (a copy of
`PixelObs` of tdmpc2_tpu/envs/dmcontrol.py:88-115; reference
envs/dmcontrol.py:66-89).

The suite's adapter and `make_env` are a later part of the port (ROADMAP
A11); importing this module imports no dm_control. `PixelObs` wraps any env
of the port's protocol whose `render(width=, height=, fast=)` returns an
[H, W, 3] uint8 frame (the dm_control adapter's, or the toy point mass's).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from tdmpc2_tpu_torch.envs.base import Wrapper
from tdmpc2_tpu_torch.envs.toy import _Box


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
