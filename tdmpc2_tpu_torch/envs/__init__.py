"""Environment factory (the single-task part of tdmpc2_tpu/envs/__init__.py).

`make_env(cfg)` builds the environment and fills the config's env-derived
fields (obs_shape, action_dim, episode_length, seed_steps). The port knows
only the pure-numpy `toy*` tasks so far; the dm_control adapters come with
a later part of the port.
"""

from __future__ import annotations

from tdmpc2_tpu_torch.envs import toy


def make_env(cfg):
    env = toy.make_env(cfg)
    cfg.obs_shape = {cfg.get('obs', 'state'): tuple(env.observation_space.shape)}
    cfg.action_dim = env.action_space.shape[0]
    cfg.episode_length = env.max_episode_steps
    cfg.seed_steps = max(1000, 5 * cfg.episode_length)
    return env
