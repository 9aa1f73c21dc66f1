"""Environment factory (tdmpc2_tpu/envs/__init__.py).

`make_env(cfg)` builds the environment and fills the config's env-derived
fields (obs_shape, action_dim, episode_length, seed_steps). The port knows
only the pure-numpy `toy*` tasks so far, whose observations are state
vectors; the dm_control adapters, and with them the rgb tasks, come with a
later part of the port (ROADMAP A11). The pixel wrapper `PixelObs`
(envs/dmcontrol.py) takes any env that renders, and a trainer takes such an
env directly, as the JAX package's pixel loop does
(tests/test_pixels_loop.py). `num_envs > 1` builds a `VecEnv` of
decorrelated copies stepped in this process (JAX envs/__init__.py:66-92);
the JAX package's worker-process copies (`vec_mode=subproc`) serve the
rendered dm_control tasks and come with them (ROADMAP A11). A multi-task
config builds a `MultitaskEnv` of one env per task and fills the per-task
fields (obs_shapes, action_dims, episode_lengths), as `make_multitask_env`
does in the JAX package (envs/__init__.py:14-28); a task the port has no
env for raises "Failed to make environment", as the JAX factory does where
its backend is missing (the mt30 and mt80 tasks need dm_control and
Meta-World).
"""

from __future__ import annotations

from copy import deepcopy

from tdmpc2_tpu_torch.envs import toy
from tdmpc2_tpu_torch.envs.vec import make_vec_env


def make_multitask_env(cfg):
    from tdmpc2_tpu_torch.envs.multitask import MultitaskEnv
    print('Creating multi-task environment with tasks:', cfg.tasks)
    envs = []
    for task in cfg.tasks:
        _cfg = deepcopy(cfg)
        _cfg.task = task
        _cfg.multitask = False
        envs.append(_make_single_env(_cfg))
    env = MultitaskEnv(cfg, envs)
    cfg.obs_shapes = env.obs_dims
    cfg.action_dims = env.action_dims
    cfg.episode_lengths = env.episode_lengths
    return env


def _check_obs(cfg):
    """Raise where no env of the port has cfg's observations."""
    is_toy = str(cfg.task).startswith('toy')
    if cfg.get('obs', 'state') != 'state':
        raise ValueError(
            f'obs={cfg.obs} on task {cfg.task}: '
            + ('the toy tasks have state observations only (no rgb mode, as in '
               'the JAX package); wrap an env in envs.dmcontrol.PixelObs and '
               'give it to a trainer instead' if is_toy else
               'the dm_control rgb tasks come with the dm_control adapter '
               '(ROADMAP A11)'))


def _make_single_env(cfg):
    try:
        return toy.make_env(cfg)
    except ValueError as e:
        raise ValueError(
            f'Failed to make environment "{cfg.task}": the port has the toy '
            f'tasks only so far (ROADMAP A11): {e}') from e


def make_env(cfg):
    _check_obs(cfg)
    if cfg.multitask:
        env = make_multitask_env(cfg)
    elif int(cfg.get('num_envs') or 1) > 1:
        env = make_vec_env(cfg, _make_single_env)
    else:
        env = _make_single_env(cfg)
    cfg.obs_shape = {cfg.get('obs', 'state'): tuple(env.observation_space.shape)}
    cfg.action_dim = env.action_space.shape[0]
    cfg.episode_length = env.max_episode_steps
    cfg.seed_steps = max(1000, 5 * cfg.episode_length)
    return env
