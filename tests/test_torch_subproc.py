"""PyTorch port: the worker-process env copies (`vec_mode=subproc`,
envs/subproc.py) against the in-process ones (CPU).

- `SubprocVecEnv` against `VecEnv`, bit for bit, on toy-reach, on
  cartpole-swingup (state) and on walker-walk (rgb): reset, step,
  reset_at, rand_act and render; `close` ends every worker;
- a worker never loads torch (nor jax or the JAX package): the libraries
  mapped into its process, where a dm_control worker's MuJoCo shows;
- `vec_mode=auto` picks worker processes for a rendered dm_control task
  and this process for a toy task and for state observations, as the JAX
  factory does, and a build error in a worker is raised in the caller;
- `VecOnlineTrainer` and a seed fleet (`make_fleet_env`) with
  vec_mode=subproc against vec_mode=inproc, bit for bit: the replay
  buffer's contents, the final parameters and the eval rows, on the
  model_size 1 network (the fleet on narrower widths; a cut planner and
  batch) with seed_steps set low after `make_env`.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tdmpc2_tpu.config import Config as JConfig, parse_cfg as jparse
from tdmpc2_tpu.envs import make_env as jmake_env
from tdmpc2_tpu_torch.config import Config, parse_cfg
from tdmpc2_tpu_torch.data.buffer import Buffer
from tdmpc2_tpu_torch.data.fleet_buffer import FleetBuffer
from tdmpc2_tpu_torch.envs import make_env, make_fleet_env
from tdmpc2_tpu_torch.envs.subproc import SubprocVecEnv
from tdmpc2_tpu_torch.envs.vec import VecEnv
from tdmpc2_tpu_torch.fleet import FleetAgent
from tdmpc2_tpu_torch.tdmpc2 import TDMPC2
from tdmpc2_tpu_torch.trainer.fleet_online import FleetOnlineTrainer
from tdmpc2_tpu_torch.trainer.vec_online import VecOnlineTrainer
from tdmpc2_tpu_torch.utils import tree
from tdmpc2_tpu_torch.utils.logger import Logger
from torch_threads import one_torch_thread  # noqa: F401

SEEDS = [3, 7]


def _cfg(task, mode, num_envs=2, **kw):
    return parse_cfg(Config(task=task, num_envs=num_envs, vec_mode=mode, seed=4,
                            device='cpu', **kw))


def _mapped(pid):
    """The files mapped into process `pid` (its loaded libraries)."""
    return {line.split()[-1] for line in Path(f'/proc/{pid}/maps').read_text().splitlines()
            if len(line.split()) >= 6}


@pytest.mark.parametrize('task,obs,steps', [
    ('toy-reach', 'state', 120), ('cartpole-swingup', 'state', 30), ('walker-walk', 'rgb', 8)])
def test_subproc_matches_inproc(task, obs, steps):
    if task != 'toy-reach':
        pytest.importorskip('dm_control')
    env, ienv = make_env(_cfg(task, 'subproc', obs=obs)), make_env(_cfg(task, 'inproc', obs=obs))
    assert isinstance(env, SubprocVecEnv) and isinstance(ienv, VecEnv)
    try:
        assert env.num_envs == ienv.num_envs == 2
        assert env.max_episode_steps == ienv.max_episode_steps
        for a, b in ((env.observation_space, ienv.observation_space),
                     (env.action_space, ienv.action_space)):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a.low, b.low)
        np.testing.assert_array_equal(env.reset(), ienv.reset())
        rng = np.random.default_rng(1)
        for t in range(steps):
            if t % 3 == 0:
                a = env.rand_act()
                np.testing.assert_array_equal(a, ienv.rand_act())
            else:
                a = rng.uniform(-1, 1, a.shape).astype(np.float32)
            out, iout = env.step(a), ienv.step(a)
            for x, y in zip(out[:3], iout[:3]):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            assert out[3] == iout[3]
            for i in np.flatnonzero(out[2]) if t % 7 else [t % 2]:
                np.testing.assert_array_equal(env.reset_at(i), ienv.reset_at(i))
        if task != 'toy-reach':
            np.testing.assert_array_equal(env.render(width=32, height=32),
                                          ienv.render(width=32, height=32))
        for p in env.procs:
            libs = _mapped(p.pid)
            assert not any('torch' in f or 'jax' in f for f in libs), p.pid
            assert any('mujoco' in f for f in libs) == (task != 'toy-reach')
    finally:
        env.close()
    assert all(p.poll() is not None for p in env.procs)
    env.close()                                    # idempotent


def test_vec_mode_auto_picks_as_jax():
    """auto: workers for a rendered dm_control task, this process for a toy
    task and for state observations (JAX envs/__init__.py:73-86)."""
    pytest.importorskip('dm_control')
    for task, obs, want in (('toy-reach', 'state', VecEnv),
                            ('cartpole-swingup', 'state', VecEnv),
                            ('walker-walk', 'rgb', SubprocVecEnv)):
        env = make_env(_cfg(task, 'auto', obs=obs))
        jenv = jmake_env(jparse(JConfig(task=task, num_envs=2, obs=obs)))
        try:
            assert type(env) is want and type(jenv).__name__ == want.__name__
        finally:
            for e in (env, jenv):
                if hasattr(e, 'close'):
                    e.close()


def test_worker_build_error_is_raised():
    with pytest.raises(ValueError, match='Failed to make environment "no-such-task"'):
        make_env(_cfg('no-such-task', 'subproc'))


# the planner and batch cut; the vectorised trainer on the model_size 1
# network, the fleet (two agents a step) on narrower widths
CUT = dict(eval_episodes=1, batch_size=16, num_samples=32, num_elites=4,
           num_pi_trajs=4, iterations=2, save_agent=False)
TINY = dict(enc_dim=32, mlp_dim=32, latent_dim=16, num_q=2)
STEPS, SEED_STEPS = 120, 100    # the first episodes end at 100: the burst,
                                # then 10 planned vector steps
EVAL_FREQ = 1000                # one eval, at step 0


def _trained(cfg, fleet=False):
    if fleet:
        env = make_fleet_env(cfg, SEEDS)
        cfg.seed_steps = SEED_STEPS
        agent = FleetAgent(cfg, SEEDS)
        tr = FleetOnlineTrainer(
            cfg=cfg, env=env, agent=agent, buffer=FleetBuffer(cfg, len(SEEDS)),
            loggers=[Logger(cfg.replace(seed=s, work_dir=str(agent.work_dir(k))))
                     for k, s in enumerate(SEEDS)])
    else:
        env = make_env(cfg)
        cfg.seed_steps = SEED_STEPS
        tr = VecOnlineTrainer(cfg=cfg, env=env, agent=TDMPC2(cfg), buffer=Buffer(cfg),
                              logger=Logger(cfg))
    tr.train()
    return tr


@pytest.mark.parametrize('fleet', [False, True], ids=['vec', 'fleet'])
def test_trainer_subproc_matches_inproc(tmp_path, fleet):
    """The same run with the copies in worker processes and in this
    process: buffers, parameters and eval rows bit for bit; the workers
    are closed at the end."""
    runs = {}
    for mode in ('subproc', 'inproc'):
        cfg = _cfg('toy-reach', mode, steps=STEPS, eval_freq=EVAL_FREQ, **CUT,
                   **(TINY if fleet else dict(model_size=1)))
        cfg.work_dir = str(tmp_path / mode / 'toy-reach' / str(cfg.seed) / cfg.exp_name)
        runs[mode] = tr = _trained(cfg, fleet)
        assert isinstance(tr.env, SubprocVecEnv if mode == 'subproc' else VecEnv)
        assert tr.env.num_envs == 2 * (len(SEEDS) if fleet else 1)
    sub, inp = runs['subproc'], runs['inproc']
    assert all(p.poll() is not None for p in sub.env.procs)
    assert sub._step == inp._step >= STEPS
    assert np.array_equal(sub.buffer.num_eps, inp.buffer.num_eps)
    assert np.all(np.asarray(sub.buffer.num_eps) >= 2)
    assert sub.buffer._storage.keys() == inp.buffer._storage.keys()
    for k in sub.buffer._storage:      # NaN where a row has no action or reward
        np.testing.assert_array_equal(sub.buffer._storage[k].numpy(),
                                      inp.buffer._storage[k].numpy(), err_msg=k)
    assert torch.equal(sub.buffer._ep_rows, inp.buffer._ep_rows)
    agents = (sub.agent.agents, inp.agent.agents) if fleet else ([sub.agent], [inp.agent])
    for x, y in zip(*agents):
        for a, b in zip(tree.leaves(x.state.params), tree.leaves(y.state.params)):
            assert torch.equal(a, b)
    csvs = sorted(Path(tmp_path / 'subproc').rglob('eval.csv'))
    assert len(csvs) == (len(SEEDS) if fleet else 1)
    for p in csvs:
        q = tmp_path / 'inproc' / p.relative_to(tmp_path / 'subproc')
        assert p.read_text() == q.read_text()
