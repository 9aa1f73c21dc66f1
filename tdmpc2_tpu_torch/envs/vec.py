"""Host-side vectorised environment (a copy of tdmpc2_tpu/envs/vec.py).

No reference counterpart (the reference steps ONE env synchronously,
reference: tdmpc2/trainer/online_trainer.py:74-127): N env copies stepped
together on the host, feeding one batched `act` call per vector step.
"""

from __future__ import annotations

from copy import deepcopy

import numpy as np


class VecEnv:
    """N same-task env copies with stacked obs/action/reward interfaces."""

    def __init__(self, envs):
        if not envs:
            raise ValueError('VecEnv needs at least one env')
        self.envs = envs
        self.observation_space = envs[0].observation_space
        self.action_space = envs[0].action_space
        self.max_episode_steps = envs[0].max_episode_steps

    @property
    def num_envs(self) -> int:
        return len(self.envs)

    def reset(self):
        return np.stack([e.reset() for e in self.envs])

    def reset_at(self, i: int):
        """Reset one env copy (per-env episode boundaries)."""
        return self.envs[i].reset()

    def step(self, actions):
        obs, rewards, dones, infos = [], [], [], []
        for e, a in zip(self.envs, actions):
            o, r, d, i = e.step(a)
            obs.append(o)
            rewards.append(r)
            dones.append(d)
            infos.append(i)
        return (np.stack(obs), np.asarray(rewards, np.float32),
                np.asarray(dones), infos)

    def rand_act(self):
        return np.stack([e.rand_act() for e in self.envs])

    def render(self, *args, **kwargs):
        return self.envs[0].render(*args, **kwargs)


def make_vec_env(cfg, make_single):
    """A VecEnv of cfg.num_envs decorrelated copies, seeded cfg.seed + 1000*i."""
    envs = []
    for i in range(cfg.num_envs):
        c = deepcopy(cfg)
        c.seed = int(cfg.seed + 1000 * i)
        envs.append(make_single(c))
    return VecEnv(envs)
