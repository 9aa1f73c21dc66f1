"""PyTorch port vs the JAX package: multi-task offline training (CPU, small
widths, f32).

On a synthetic two-task toy dataset (the geometry of tests/test_offline.py):

- `Buffer.reserve` and `Buffer.load` against the JAX buffer's: capacity,
  episode count, and the same draws giving the same slices and task ids;
- `OfflineTrainer.train` against the JAX trainer: the same schedule of
  `update_many` chunks, and, fed the JAX run's batches and draws, the same
  losses at each call (1e-4); then the lockstep eval over both tasks, the
  per-domain report and the checkpoint at the eval iteration;
- `evaluate` on a multi-task config (the lockstep branch), and a
  checkpoint that the JAX agent reads with its `task_emb` and task count,
  while a checkpoint of another task count is refused;
- `train` and `evaluate` raise on save_video=true before any work.
"""

import jax
import numpy as np
import pytest
import torch

from tdmpc2_tpu.config import Config as JConfig, parse_cfg as jparse
from tdmpc2_tpu.data.buffer import Buffer as JBuffer
from tdmpc2_tpu.data.buffer import draw_slice_indices as jdraw
from tdmpc2_tpu.envs import make_env as jmake_env
from tdmpc2_tpu.tdmpc2 import TDMPC2 as JTDMPC2
from tdmpc2_tpu.trainer.offline import OfflineTrainer as JOfflineTrainer
from tdmpc2_tpu.utils.logger import Logger as JLogger
from tdmpc2_tpu_torch import evaluate as eval_mod
from tdmpc2_tpu_torch import train as train_mod
from tdmpc2_tpu_torch.config import Config, load_cfg, parse_cfg
from tdmpc2_tpu_torch.data.buffer import Buffer
from tdmpc2_tpu_torch.envs import make_env
from tdmpc2_tpu_torch.interop import state_from_jax
from tdmpc2_tpu_torch.tdmpc2 import TDMPC2, UpdateNoise
from tdmpc2_tpu_torch.trainer import offline as offline_mod
from tdmpc2_tpu_torch.utils.logger import Logger
from torch_threads import one_torch_thread  # noqa: F401

UPD = dict(rtol=1e-4, atol=1e-4)
ROWS, OBS = 51, 6


def _mt(cfg, tmp_path, **kw):
    """The JAX suite's toy multi-task config (tests/test_offline.py:19-31)."""
    for k, v in dict(batch_size=8, latent_dim=16, mlp_dim=32, enc_dim=32,
                     num_q=2, num_bins=5, num_samples=16, num_elites=4,
                     num_pi_trajs=2, iterations=1, horizon=3, save_csv=True,
                     eval_episodes=1, data_dir=str(tmp_path / 'data'),
                     **kw).items():
        setattr(cfg, k, v)
    cfg.multitask, cfg.tasks, cfg.task_dim = True, ['toy-reach', 'toy-reach'], 8
    cfg.work_dir = str(tmp_path / 'work')
    return cfg


def _cfgs(tmp_path, **kw):
    return (_mt(jparse(JConfig(task='toy-mt2')), tmp_path, save_agent=False, **kw),
            _mt(parse_cfg(Config(task='toy-mt2', device='cpu')), tmp_path, **kw))


def _write_chunks(data_dir, n_chunks=2, eps=3, act_dim=2):
    data_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    for c in range(n_chunks):
        action = rng.uniform(-1, 1, (eps, ROWS, act_dim)).astype(np.float32)
        action[:, 0] = np.nan                      # the bootstrap row
        np.savez(data_dir / f'chunk_{c}.npz',
                 obs=rng.standard_normal((eps, ROWS, OBS)).astype(np.float32),
                 action=action,
                 reward=rng.standard_normal((eps, ROWS)).astype(np.float32),
                 task=np.tile((np.arange(eps) + c) % 2, (ROWS, 1)).T.astype(np.int64))


def _noises(key, cfg, n):
    """The draws of n JAX `_update` steps from `key` on, each step's key the
    last of its split (tdmpc2.py:933-936, 1054), as UpdateNoise."""
    T, N, M, B, A = cfg.horizon, cfg.num_q, cfg.mlp_dim, cfg.batch_size, cfg.action_dim
    out = []
    for _ in range(n):
        ks = jax.random.split(key, 9)
        k_pi, k_q = jax.random.split(ks[2])

        def keep(k, rows):
            return torch.from_numpy(np.stack([np.asarray(jax.random.bernoulli(
                km, 1.0 - cfg.dropout, (rows, B, M))) for km in jax.random.split(k, N)]))

        def qpair(k):
            return torch.from_numpy(np.array(jax.random.permutation(k, N)[:2])).long()
        out.append(UpdateNoise(
            td_eps=torch.from_numpy(np.array(jax.random.normal(k_pi, (T, B, A)))),
            td_qidx=qpair(k_q), q_keep=keep(ks[4], T),
            pi_eps=torch.from_numpy(np.array(jax.random.normal(ks[5], (T + 1, B, A)))),
            pi_qidx=qpair(ks[6]), pi_keep=keep(ks[7], T + 1)))
        key = ks[8]
    return out, key


def _torch_batch(batch):
    return tuple(torch.from_numpy(np.array(x)) for x in batch)


def test_buffer_load_reserve_and_tasks_match_jax(tmp_path):
    jcfg, tcfg = _cfgs(tmp_path, buffer_size=10_000, steps=10_000)
    make_env(tcfg)
    jmake_env(jcfg)
    jcfg.buffer_device = 'device'     # no 2 GiB trial allocation on the CPU
    _write_chunks(tmp_path / 'data')
    chunks = [dict(np.load(tmp_path / 'data' / f'chunk_{c}.npz')) for c in range(2)]
    jbuf, tbuf = JBuffer(jcfg), Buffer(tcfg)
    jbuf.reserve(6)
    tbuf.reserve(6)
    for c in chunks:
        assert jbuf.load(dict(c)) == tbuf.load(dict(c))
    assert tbuf.num_eps == 6 and tbuf.capacity == jbuf.capacity == 6 * 50
    np.testing.assert_array_equal(tbuf._task_store.numpy(),
                                  np.asarray(jbuf._task_store))
    for n in (1, 3):
        jbatch = jbuf.sample_many(n)
        key = jax.random.fold_in(jbuf._key, jbuf._draws)
        ep, start = jdraw(key, jbuf._ep_rows, 6, n * 8, jcfg.horizon, 6)
        got = tbuf.gather(torch.from_numpy(np.array(ep)),
                          torch.from_numpy(np.array(start)), n)
        assert len(got) == 5
        for g, r in zip(got, jbatch):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    obs, action, reward, terminated, task = tbuf.sample()
    assert task.shape == (8,) and task.dtype == torch.int32
    assert not torch.isnan(action).any() and set(task.tolist()) <= {0, 1}
    with pytest.raises(RuntimeError):
        tbuf.reserve(3)


def test_offline_trainer_matches_jax_trainer(tmp_path, monkeypatch):
    """Both trainers run 11 iterations: update_many(8), then update_many(3).
    The port is fed the JAX run's batches and draws from the same initial
    state, and each call's info matches JAX's; then the port evaluates both
    tasks in lockstep at iteration 11 and checkpoints."""
    monkeypatch.chdir(tmp_path)
    jcfg, tcfg = _cfgs(tmp_path, steps=11)
    jcfg.eval_freq, tcfg.eval_freq = 1000, 11   # the JAX run skips its eval
    jcfg.buffer_device = 'device'
    jenv, tenv = jmake_env(jcfg), make_env(tcfg)
    _write_chunks(tmp_path / 'data')
    jag = JTDMPC2(jcfg)
    state0 = jax.tree.map(np.array, jag.state)     # the update donates it
    key0 = state0.key
    calls = []
    for name in ('_update_jit', '_update_scan_jit'):
        fn = getattr(jag, name)

        def rec(state, *batch, fn=fn):
            new, info = fn(state, *batch)
            calls.append((batch, jax.tree.map(float, info)))
            return new, info
        setattr(jag, name, rec)
    JOfflineTrainer(cfg=jcfg, env=jenv, agent=jag, buffer=JBuffer(jcfg),
                    logger=JLogger(jcfg)).train()
    assert [b[0].shape[0] if b[0].ndim == 4 else 1 for b, _ in calls] == [8, 3]

    tag = TDMPC2(tcfg)
    tag.state = state_from_jax(state0)
    batches = [_torch_batch(b) for b, _ in calls]
    noises, _ = _noises(key0, tcfg, 11)

    class Replay(Buffer):
        def sample_many(self, n):
            b = batches.pop(0)
            assert b[0].shape[0] == n
            return b
    monkeypatch.setattr(offline_mod, 'Buffer', Replay)
    monkeypatch.setattr(tag, 'draw_update_noise', lambda: noises.pop(0))
    infos = []
    many = tag.update_many
    monkeypatch.setattr(tag, 'update_many', lambda buf, n: infos.append(
        many(buf, n)) or infos[-1])
    logs = []
    logger = Logger(tcfg)
    monkeypatch.setattr(logger, 'log', lambda m, c='train': logs.append((c, m)))
    trainer = offline_mod.OfflineTrainer(cfg=tcfg, env=tenv, agent=tag,
                                         buffer=Buffer(tcfg), logger=logger)
    trainer.train()
    assert trainer.buffer.num_eps == 6 and not batches and not noises
    for got, (_, ref) in zip(infos, calls):
        for k in ref:
            np.testing.assert_allclose(float(got[k]), ref[k], **UPD, err_msg=k)
    cats = [c for c, _ in logs]
    assert cats == ['eval', 'pretrain']
    pre = logs[1][1]
    assert pre['iteration'] == 11
    assert all(np.isfinite(pre[f'episode_reward+{t}']) for t in tcfg.tasks)
    assert (tmp_path / 'work' / 'models' / '11.pkl').exists()


@pytest.mark.parametrize('mpc', [True, False], ids=['lockstep', 'pi-only'])
def test_evaluate_multitask_and_checkpoint_interop(tmp_path, monkeypatch, mpc):
    """The lockstep evaluate over both toy tasks (a pi-only agent: one task
    after another, `act(task=i)`), from a port checkpoint that the JAX
    agent reads (task embedding and task count in its architecture check);
    a checkpoint of three tasks is refused."""
    monkeypatch.chdir(tmp_path)
    jcfg, tcfg = _cfgs(tmp_path, mpc=mpc)
    jmake_env(jcfg)
    make_env(tcfg)
    tag = TDMPC2(tcfg)
    fp = tmp_path / 'agent.pkl'
    tag.save(fp)
    jag = JTDMPC2(jcfg)
    jag.load(str(fp))
    np.testing.assert_array_equal(np.asarray(jag.state.params['task_emb']['w']),
                                  tag.params['task_emb']['w'].numpy())
    tcfg.checkpoint = str(fp)
    res = eval_mod.evaluate(tcfg)
    r = res['toy-reach']
    assert r['plans'] == 50 and r['lengths'] == [50] and np.isfinite(r['reward'])
    other = _mt(parse_cfg(Config(task='toy-mt2', device='cpu')), tmp_path)
    other.tasks = ['toy-reach'] * 3
    make_env(other)
    with pytest.raises(ValueError, match='num_tasks'):
        TDMPC2(other).load(fp)


@pytest.mark.parametrize('entry', ['train', 'evaluate'])
def test_save_video_raises_before_any_work(entry, monkeypatch):
    def no_env(cfg):
        raise AssertionError('make_env reached')
    mod = train_mod if entry == 'train' else eval_mod
    monkeypatch.setattr(mod, 'make_env', no_env)
    cfg = load_cfg(overrides=['task=toy-reach', 'device=cpu', 'save_video=true'])
    with pytest.raises(NotImplementedError, match='save_video'):
        (train_mod.train if entry == 'train' else eval_mod.evaluate)(cfg)
