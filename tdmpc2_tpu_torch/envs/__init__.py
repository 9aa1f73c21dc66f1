"""Environment factory (tdmpc2_tpu/envs/__init__.py).

`make_env(cfg)` tries each domain factory in the JAX package's order (toy,
dm_control with the 28 custom tasks, ManiSkill2, Meta-World, MyoSuite,
Gymnasium) and fills the config's env-derived fields (obs_shape,
action_dim, episode_length, seed_steps) — reference:
tdmpc2/envs/__init__.py:37-83. Each adapter imports its backend inside its
`make_env`, so importing this package needs none of them; where a backend
does not import, its adapter raises ValueError and the chain goes on, and
a task no adapter builds raises "Failed to make environment ... Tried:
[...]" with each adapter's reason. The toy tasks have state observations
only (no rgb mode, as in the JAX package); the dm_control tasks take
`obs=rgb` (`dmcontrol.PixelObs`: three 64 x 64 RGB frames). A trainer or
`evaluate` also takes any env of the port's protocol directly, such as
`PixelObs` around an env that renders.

`num_envs > 1` builds N decorrelated copies (JAX envs/__init__.py:66-92):
in this process (`vec.VecEnv`, vec_mode=inproc) or one worker process a
copy (`subproc.SubprocVecEnv`, vec_mode=subproc); vec_mode=auto picks the
workers for a rendered (rgb) non-toy task, whose frames dominate a step,
and this process otherwise. `make_fleet_env(cfg, seeds)` builds the flat
vector of a seed fleet (K seeds x num_envs copies, JAX
envs/__init__.py:45-63) the same way. A multi-task config (mt30, mt80)
builds a `MultitaskEnv` of one env per task and fills the per-task fields
(obs_shapes, action_dims, episode_lengths), as `make_multitask_env` does
in the JAX package (envs/__init__.py:14-28).
"""

from __future__ import annotations

from copy import deepcopy


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
    """A toy task has no rgb mode: raise rather than build its state env
    under an rgb config."""
    if str(cfg.task).startswith('toy') and cfg.get('obs', 'state') != 'state':
        raise ValueError(
            f'obs={cfg.obs} on task {cfg.task}: the toy tasks have state '
            'observations only (no rgb mode, as in the JAX package); wrap an '
            'env in envs.dmcontrol.PixelObs and give it to a trainer instead')


def _make_single_env(cfg):
    from tdmpc2_tpu_torch.envs import (dmcontrol, gym_tasks, maniskill,
                                       metaworld, myosuite, toy)
    errors = []
    for factory in (toy.make_env, dmcontrol.make_env, maniskill.make_env,
                    metaworld.make_env, myosuite.make_env, gym_tasks.make_env):
        try:
            return factory(cfg)
        except ValueError as e:
            errors.append(str(e))
    raise ValueError(
        f'Failed to make environment "{cfg.task}": verify that dependencies '
        f'are installed and the task exists. Tried: {errors}')


def _vec_mode(cfg) -> str:
    """cfg.vec_mode, with auto resolved: worker processes for a rendered
    non-toy task (rendering dominates its steps; the toy tasks have no rgb
    mode), this process otherwise."""
    mode = cfg.get('vec_mode', 'auto')
    if mode == 'auto':
        mode = ('subproc' if cfg.get('obs') == 'rgb'
                and not str(cfg.task).startswith('toy') else 'inproc')
    return mode


def _make_vec(cfg, seed_list=None):
    if _vec_mode(cfg) == 'subproc':
        from tdmpc2_tpu_torch.envs.subproc import SubprocVecEnv
        return SubprocVecEnv(cfg, seed_list=seed_list)
    from tdmpc2_tpu_torch.envs.vec import make_vec_env
    return make_vec_env(cfg, _make_single_env, seed_list=seed_list)


def make_fleet_env(cfg, seeds):
    """The flat vector of K seeds x cfg.num_envs copies of a fleet (JAX
    envs/__init__.py:45-63): copy (k, i) is seeded seeds[k] + 1000*i, the
    env seeds K single-seed runs would use; in this process or in worker
    processes as vec_mode says. Fills cfg's env fields as `make_env`
    does."""
    _check_obs(cfg)
    if cfg.multitask:
        raise ValueError('a fleet trains one task online (single-task)')
    env = _make_vec(cfg, seed_list=[int(s) + 1000 * i for s in seeds
                                    for i in range(int(cfg.get('num_envs') or 1))])
    _fill_env_cfg(cfg, env)
    return env


def make_env(cfg):
    """Make an environment and fill the env-derived config fields.

    cfg.num_envs > 1 builds N decorrelated same-task copies for batched
    collection (single-task online only), as vec_mode says."""
    _check_obs(cfg)
    if cfg.multitask:
        env = make_multitask_env(cfg)
    elif int(cfg.get('num_envs') or 1) > 1:
        env = _make_vec(cfg)
    else:
        env = _make_single_env(cfg)
    _fill_env_cfg(cfg, env)
    return env


def _fill_env_cfg(cfg, env):
    obs_space = env.observation_space
    if isinstance(obs_space, dict):
        cfg.obs_shape = {k: v.shape for k, v in obs_space.items()}
    else:
        cfg.obs_shape = {cfg.get('obs', 'state'): tuple(obs_space.shape)}
    cfg.action_dim = env.action_space.shape[0]
    cfg.episode_length = env.max_episode_steps
    cfg.seed_steps = max(1000, 5 * cfg.episode_length)
