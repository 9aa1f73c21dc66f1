"""Environment factory (the single-task part of tdmpc2_tpu/envs/__init__.py).

`make_env(cfg)` builds the environment and fills the config's env-derived
fields (obs_shape, action_dim, episode_length, seed_steps). The port knows
only the pure-numpy `toy*` tasks with state observations so far; the
dm_control adapters come with a later part of the port, and pixel
observations, with the worker-process env copies that render them, with
the pixel slice. `num_envs > 1` builds a `VecEnv` of decorrelated copies
stepped in this process (JAX envs/__init__.py:66-92).
"""

from __future__ import annotations

from tdmpc2_tpu_torch.envs import toy
from tdmpc2_tpu_torch.envs.vec import make_vec_env


def make_env(cfg):
    if cfg.get('obs', 'state') != 'state':
        raise NotImplementedError(
            f'obs={cfg.obs}: pixel observations, and the worker-process env '
            'copies that render them, come with the pixel slice of the port '
            '(ROADMAP A8)')
    if int(cfg.get('num_envs') or 1) > 1:
        env = make_vec_env(cfg, toy.make_env)
    else:
        env = toy.make_env(cfg)
    cfg.obs_shape = {cfg.get('obs', 'state'): tuple(env.observation_space.shape)}
    cfg.action_dim = env.action_space.shape[0]
    cfg.episode_length = env.max_episode_steps
    cfg.seed_steps = max(1000, 5 * cfg.episode_length)
    return env
