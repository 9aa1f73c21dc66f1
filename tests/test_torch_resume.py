"""PyTorch port vs the JAX package: resuming training (CPU, small widths).

Counterparts of tests/test_resume.py, and more:

- the update schedule of a fresh run and of its resumed continuation, step
  for step against the JAX trainers' (one env and num_envs=4), with agents
  that act at random and record each update call: the seed burst, the
  refill gate, a snapshot's credit, no burst after a resume;
- a port run saved and resumed: counters, parameters, Adam states, scale
  and both generators equal the checkpoint's bit for bit, the snapshot's
  episodes are back, no update draws inside the gated span, updates follow
  it; the same with num_envs=4;
- offline training resumed at an iteration checkpoint ends bit for bit
  where the uninterrupted run ends;
- a fresh start without a checkpoint, and the architecture-mismatch error;
- a buffer snapshot written by either package read by the other.
"""

import pickle
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tdmpc2_tpu.config import Config as JConfig, parse_cfg as jparse
from tdmpc2_tpu.data.buffer import Buffer as JBuffer
from tdmpc2_tpu.envs import make_env as jmake_env
from tdmpc2_tpu.trainer.online import OnlineTrainer as JOnlineTrainer
from tdmpc2_tpu.trainer.vec_online import VecOnlineTrainer as JVecOnlineTrainer
from tdmpc2_tpu.utils.logger import Logger as JLogger
from tdmpc2_tpu_torch.config import Config, parse_cfg
from tdmpc2_tpu_torch.data.buffer import Buffer
from tdmpc2_tpu_torch.envs import make_env
from tdmpc2_tpu_torch.interop import load_blob
from tdmpc2_tpu_torch.tdmpc2 import TDMPC2
from tdmpc2_tpu_torch.trainer.offline import OfflineTrainer
from tdmpc2_tpu_torch.trainer.online import OnlineTrainer
from tdmpc2_tpu_torch.trainer.vec_online import VecOnlineTrainer
from tdmpc2_tpu_torch.utils import tree
from tdmpc2_tpu_torch.utils.logger import Logger
from torch_threads import one_torch_thread  # noqa: F401

SEED_STEPS = 120
SMALL = dict(task='toy-reach', batch_size=8, latent_dim=16, mlp_dim=32,
             enc_dim=32, num_q=2, num_bins=5, num_samples=16, num_elites=4,
             num_pi_trajs=2, iterations=1, horizon=3, save_csv=False,
             eval_episodes=1, eval_freq=100)


def _cfg(work, jax=False, **kw):
    """tests/test_resume.py's toy config, for the port or the JAX package."""
    kw = {**SMALL, **kw}
    cfg = jparse(JConfig(**kw)) if jax else parse_cfg(Config(**kw, device='cpu'))
    cfg.work_dir = str(work)
    if jax:
        cfg.buffer_device = 'device'     # no 2 GiB trial allocation here
        cfg.fused_step = False           # act and update_many, as the port's
                                         # vec_step calls them on a recorder
    return cfg


# ---------------------------------------------------- schedules against JAX


class _Recorder:
    """An agent that acts at random and records each update call as (the
    trainer's step, updates); its checkpoint holds the trainer's `extra`."""

    def __init__(self, cfg):
        self.cfg, self.calls, self.trainer = cfg, [], None
        self.rng = np.random.default_rng(0)
        self.state = SimpleNamespace(params={'w': torch.zeros(1)})
        self.model = SimpleNamespace(total_params=lambda p: 1)

    def act(self, obs, t0=False, eval_mode=False, task=None):
        lead = np.shape(obs)[:-1]
        return self.rng.uniform(-1, 1, lead + (self.cfg.action_dim,)).astype(np.float32)

    def update(self, buffer):
        self.calls.append((self.trainer._step, 1))
        return {}

    def update_many(self, buffer, n):
        self.calls.append((self.trainer._step, n))
        return {}

    def vec_step(self, buffer, obs, t0, n):
        """The vector trainer's step: `act`, then `update_many` if n."""
        return self.act(obs), (self.update_many(buffer, n) if n else None)

    def save(self, fp, extra=None, buffer=None):
        Path(fp).parent.mkdir(parents=True, exist_ok=True)
        with open(fp, 'wb') as f:
            pickle.dump({'extra': dict(extra or {})}, f)

    def load(self, fp, buffer=None):
        with open(fp, 'rb') as f:
            return pickle.load(f)['extra']


def _recorded_run(jax, work, num_envs, **kw):
    cfg = _cfg(work, jax=jax, num_envs=num_envs, **kw)
    env = (jmake_env if jax else make_env)(cfg)
    cfg.seed_steps = SEED_STEPS                # after make_env, as the JAX tests do
    if jax:
        cls = JVecOnlineTrainer if num_envs > 1 else JOnlineTrainer
        parts = dict(buffer=JBuffer(cfg), logger=JLogger(cfg))
    else:
        cls = VecOnlineTrainer if num_envs > 1 else OnlineTrainer
        parts = dict(buffer=Buffer(cfg), logger=Logger(cfg))
    agent = _Recorder(cfg)
    trainer = cls(cfg=cfg, env=env, agent=agent, **parts)
    agent.trainer = trainer
    trainer.train()
    return trainer, agent.calls


# (eval_freq, the first run's steps, the resumed run's) by env count: the
# vector trainer discards unfinished episodes at each eval, so its evals are
# one 50-step episode per env apart (4 x 50 env steps)
SPANS = {1: (100, 200, 320), 4: (200, 400, 640)}


@pytest.mark.parametrize('num_envs', [1, 4])
@pytest.mark.parametrize('snapshot_eps,refill', [(0, 60), (3, 100), (3, 200), (0, 0)])
def test_resumed_schedule_matches_jax_trainer(tmp_path, num_envs, snapshot_eps, refill):
    """A fresh run and its resumed continuation update at the same steps, as
    often, as the JAX trainers' do."""
    eval_freq, steps1, steps2 = SPANS[num_envs]
    runs = {}
    for jax in (True, False):
        work = tmp_path / ('jax' if jax else 'port')
        first = _recorded_run(jax, work, num_envs, steps=steps1, eval_freq=eval_freq,
                              buffer_snapshot_eps=snapshot_eps)
        second = _recorded_run(jax, work, num_envs, steps=steps2, eval_freq=eval_freq,
                               resume=True, buffer_snapshot_eps=snapshot_eps,
                               resume_refill_steps=refill)
        runs[jax] = (first, second)
    (jf, jcalls_f), (js, jcalls_s) = runs[True]
    (tf, tcalls_f), (ts, tcalls_s) = runs[False]
    assert tcalls_f == jcalls_f
    first_step = tcalls_f[0][0]             # the burst, at the first update
    assert sum(n for step, n in tcalls_f if step == first_step) == SEED_STEPS
    assert tcalls_s == jcalls_s
    assert ts._resumed and ts._resume_step == js._resume_step > 0
    assert ts._refill_credit == getattr(js, '_refill_credit', 0)
    assert ts.buffer.num_eps == js.buffer.num_eps
    assert ts._step == js._step
    # no burst after a resume: one update per env step, none in the gate
    gate_open = ts._resume_step + max(0, refill - ts._refill_credit)
    assert all(n == num_envs and step >= gate_open for step, n in tcalls_s)
    assert tcalls_s and ts._resume_step == steps1


def test_resume_without_checkpoint_starts_fresh(tmp_path):
    trainer, calls = _recorded_run(False, tmp_path / 'none', 1, steps=130,
                                   resume=True)
    assert not trainer._resumed and trainer._step == 131
    assert sum(n for step, n in calls if step == SEED_STEPS) == SEED_STEPS  # the burst


# ---------------------------------------------------- the port's resumed state


def _port_trainer(work, num_envs=1, **kw):
    cfg = _cfg(work, num_envs=num_envs, **kw)
    env = make_env(cfg)
    cfg.seed_steps = SEED_STEPS
    cls = VecOnlineTrainer if num_envs > 1 else OnlineTrainer
    return cls(cfg=cfg, env=env, agent=TDMPC2(cfg), buffer=Buffer(cfg),
               logger=Logger(cfg))


def _hold_restored(trainer, blob):
    """The trainer after maybe_resume against the checkpoint it read."""
    st = trainer.agent.state
    for name, saved in (('params', blob['model']), ('target_Qs', blob['target_Qs']),
                        ('opt_state', blob['torch_opt_state']),
                        ('pi_opt_state', blob['torch_pi_opt_state'])):
        got, ref = tree.leaves(getattr(st, name)), tree.leaves(saved)
        assert len(got) == len(ref) > 0, name
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert st.scale.numpy().tobytes() == np.asarray(blob['scale']).tobytes()
    assert trainer.agent.generator.get_state().numpy().tobytes() == \
        blob['torch_rng']['state'].tobytes()
    assert trainer.buffer.generator.get_state().numpy().tobytes() == \
        blob['torch_buffer_rng']['state'].tobytes()
    assert trainer._step == blob['extra']['step']
    assert trainer._ep_idx == blob['extra']['ep_idx']


def _checkpointed(work, num_envs, step=200):
    """A trainer's 'latest' checkpoint and 3-episode snapshot at `step`,
    written by `_checkpoint` after 4 episodes and 3 updates (the train
    state, the generators and the counters off their initial values)."""
    first = _port_trainer(work, num_envs, steps=step, buffer_snapshot_eps=3)
    rng = np.random.default_rng(5)
    for _ in range(4):
        first.buffer.add(_episode(rng, 51))
    for _ in range(3):
        first.agent.update(first.buffer)
    first.agent.draw_noise()
    first._step, first._ep_idx = step, 4
    first._checkpoint()
    return first


@pytest.mark.parametrize('num_envs', [1, 4])
def test_resume_restores_state_and_gates_updates(tmp_path, monkeypatch, num_envs):
    """Resume at step 200 with a 3-episode snapshot for 60 more env steps
    behind a 200-step refill gate: the state as saved, and 150 steps of
    credit open the gate 50 steps in."""
    work = tmp_path / 'run'
    _checkpointed(work, num_envs)
    blob = load_blob(work / 'models' / 'latest.pkl')
    with np.load(work / 'models' / 'buffer.npz') as snap:
        saved_obs = snap['ep__obs']
    second = _port_trainer(work, num_envs, steps=260, eval_freq=1000, resume=True,
                           buffer_snapshot_eps=3, resume_refill_steps=200)
    second.maybe_resume()
    _hold_restored(second, blob)
    assert second.buffer.num_eps == 3 and second._refill_credit == 150
    np.testing.assert_array_equal(
        second.buffer._storage['obs'][:3].numpy(), saved_obs)
    steps = []
    update, many = TDMPC2.update, TDMPC2.update_many
    monkeypatch.setattr(TDMPC2, 'update', lambda self, buf: steps.append(
        second._step) or update(self, buf))
    monkeypatch.setattr(TDMPC2, 'update_many', lambda self, buf, n: steps.extend(
        [second._step] * n) or many(self, buf, n))
    second.train()
    gate_open = 200 + 200 - 150
    # one update per env step from the gate's opening, and none before
    assert steps == [s for s in range(200, second._step, num_envs)
                     if s >= gate_open for _ in range(num_envs)]
    assert second.buffer._draws == len(steps) // num_envs
    assert second._step > 260


def test_resume_refuses_another_architecture(tmp_path):
    work = tmp_path / 'run'
    _checkpointed(work, 1)
    other = _port_trainer(work, steps=260, resume=True, mlp_dim=64)
    with pytest.raises(ValueError, match='architecture does not match'):
        other.maybe_resume()


# ------------------------------------------------------------- offline resume

ROWS, OBS = 51, 6


def _offline_cfg(work, data, **kw):
    # a pi-only agent: the evals (the checkpoints' boundaries) skip planning
    cfg = parse_cfg(Config(**dict(SMALL, task='toy-mt2', save_csv=True, device='cpu',
                                  data_dir=str(data), eval_freq=8, mpc=False, **kw)))
    cfg.multitask, cfg.tasks, cfg.task_dim = True, ['toy-reach', 'toy-reach'], 8
    cfg.work_dir = str(work)
    return cfg


def _offline_run(work, data, **kw):
    cfg = _offline_cfg(work, data, **kw)
    env = make_env(cfg)
    trainer = OfflineTrainer(cfg=cfg, env=env, agent=TDMPC2(cfg), buffer=Buffer(cfg),
                             logger=Logger(cfg))
    trainer.train()
    return trainer


def test_offline_resume_ends_where_the_uninterrupted_run_ends(tmp_path):
    """16 iterations at once, against 8 and then a resume from the
    iteration-8 checkpoint to 16: the same train state and generators, bit
    for bit (the dataset, the buffer's and the agent's draws restored)."""
    data = tmp_path / 'data'
    data.mkdir()
    rng = np.random.default_rng(0)
    for c in range(2):
        action = rng.uniform(-1, 1, (3, ROWS, 2)).astype(np.float32)
        action[:, 0] = np.nan
        np.savez(data / f'chunk_{c}.npz',
                 obs=rng.standard_normal((3, ROWS, OBS)).astype(np.float32),
                 action=action,
                 reward=rng.standard_normal((3, ROWS)).astype(np.float32),
                 task=((np.arange(3) + c) % 2).astype(np.int32))
    whole = _offline_run(tmp_path / 'whole', data, steps=16)
    _offline_run(tmp_path / 'split', data, steps=8)
    resumed = _offline_run(tmp_path / 'split', data, steps=16, resume=True)
    for name in ('params', 'target_Qs', 'opt_state', 'pi_opt_state', 'scale'):
        for a, b in zip(tree.leaves(getattr(resumed.agent.state, name)),
                        tree.leaves(getattr(whole.agent.state, name))):
            assert torch.equal(a, b), name
    assert int(resumed.agent.state.opt_state['enc']['count']) == 16
    assert torch.equal(resumed.agent.generator.get_state(),
                       whole.agent.generator.get_state())
    assert torch.equal(resumed.buffer.generator.get_state(),
                       whole.buffer.generator.get_state())
    csv = (tmp_path / 'split' / 'eval.csv').read_text().splitlines()
    assert [r.split(',')[0] for r in csv[1:]] == ['8', '16']   # history kept


# ------------------------------------------------------ snapshots across packages


def _episode(rng, rows, task=None):
    ep = dict(obs=rng.normal(size=(rows, OBS)).astype(np.float32),
              action=rng.uniform(-1, 1, (rows, 2)).astype(np.float32),
              reward=rng.uniform(size=rows).astype(np.float32),
              terminated=np.zeros(rows, np.float32))
    for k in ('action', 'reward', 'terminated'):
        ep[k][0] = np.nan                        # the bootstrap row
    if task is not None:
        ep['task'] = task
    return ep


@pytest.mark.parametrize('writer', ['jax', 'port'])
@pytest.mark.parametrize('tasks', [False, True], ids=['single', 'multitask'])
def test_snapshot_read_across_packages(tmp_path, writer, tasks):
    """Six episodes (one short) written to a ring of five, the newest four
    snapshotted by one package and loaded by the other: the same episodes,
    rows, tasks and refill credit."""
    jcfg = _cfg(tmp_path, jax=True, buffer_size=100, steps=100)
    tcfg = _cfg(tmp_path, buffer_size=100, steps=100)
    for c in (jcfg, tcfg):
        c.obs_shape, c.action_dim, c.episode_length = {'state': (OBS,)}, 2, 20
    rng = np.random.default_rng(3)
    eps = [_episode(rng, rows, task=(i % 2 if tasks else None))
           for i, rows in enumerate((21, 21, 15, 21, 21, 21))]
    for ep in eps:
        ep['valid_rows'] = ep['reward'].shape[0]
    src = JBuffer(jcfg) if writer == 'jax' else Buffer(tcfg)
    dst = Buffer(tcfg) if writer == 'jax' else JBuffer(jcfg)
    for ep in eps:
        src.add(dict(ep))
    fp = tmp_path / 'buffer.npz'
    steps = src.save_snapshot(str(fp), 4)
    assert dst.load_snapshot(str(fp)) == steps == 14 + 20 + 20 + 20
    assert dst.num_eps == 4
    with np.load(fp) as snap:
        got = {k: snap[k] for k in snap.files}
    assert got['valid_rows'].tolist() == [15, 21, 21, 21]
    if tasks:
        assert got['task'].tolist() == [0, 1, 0, 1]
    for k in ('obs', 'action', 'reward'):
        stored = np.asarray(dst._storage[k][:4])
        np.testing.assert_array_equal(stored, got[f'ep__{k}'])
        for i, ep in enumerate(eps[2:]):
            n = ep[k].shape[0]
            np.testing.assert_array_equal(stored[i, :n], ep[k])


# ---------------------------------------------------------------- pixels


PIX = (9, 16, 16)


def _pixel_episode(rng, rows):
    """An episode of uint8 frame stacks [rows, 9, 16, 16] as PixelObs makes
    them: oldest frame first, the reset frame repeated."""
    f = rng.integers(0, 256, (rows, 3, 16, 16), dtype=np.uint8)
    idx = np.clip(np.arange(rows)[:, None] + np.arange(-2, 1)[None], 0, None)
    ep = _episode(rng, rows)
    ep['obs'] = f[idx].reshape(rows, *PIX)
    ep['valid_rows'] = rows
    return ep


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_pixel_snapshot_read_across_packages(tmp_path, writer):
    """Pixel episodes (one short) snapshotted by one package and loaded by
    the other: the flat uint8 frames, `meta_frame_shape` (3, 16, 16), rows
    and refill credit, and the reader restacks the frames it was given."""
    jcfg = _cfg(tmp_path, jax=True, buffer_size=100, steps=100, obs='rgb')
    tcfg = _cfg(tmp_path, buffer_size=100, steps=100, obs='rgb')
    for c in (jcfg, tcfg):
        c.obs_shape, c.action_dim, c.episode_length = {'rgb': PIX}, 2, 20
    rng = np.random.default_rng(4)
    eps = [_pixel_episode(rng, rows) for rows in (21, 15, 21, 21)]
    src = JBuffer(jcfg) if writer == 'jax' else Buffer(tcfg)
    dst = Buffer(tcfg) if writer == 'jax' else JBuffer(jcfg)
    for ep in eps:
        src.add(dict(ep))
    fp = tmp_path / 'buffer.npz'
    steps = src.save_snapshot(str(fp), 3)
    assert dst.load_snapshot(str(fp)) == steps == 14 + 20 + 20
    with np.load(fp) as snap:
        assert snap['meta_frame_shape'].tolist() == [3, 16, 16]
        assert snap['ep__obs'].dtype == np.uint8 and snap['ep__obs'].shape == (3, 21, 768)
        np.testing.assert_array_equal(np.asarray(dst._storage['obs'][:3]), snap['ep__obs'])
    for i, ep in enumerate(eps[1:]):
        n = ep['valid_rows']
        np.testing.assert_array_equal(
            np.asarray(dst._storage['obs'][i, :n]), ep['obs'][:, 6:].reshape(n, -1))
    if writer == 'jax':       # the port rebuilds the stacks from the frames
        got = dst.gather(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 17]))[0]
        for j, (e, s) in enumerate(((1, 0), (2, 1), (3, 17))):
            np.testing.assert_array_equal(got[:, j].numpy(), eps[e]['obs'][s:s + 4])


class _PixelRecorder(_Recorder):
    """`_Recorder` for [C, H, W] frame stacks (one env)."""

    def act(self, obs, t0=False, eval_mode=False, task=None):
        return self.rng.uniform(-1, 1, self.cfg.action_dim).astype(np.float32)


def _pixel_run(jax, work, **kw):
    """A recorded run on NormalizeInfo(Timeout(PixelObs(point mass))), the
    env given to the trainer as the JAX pixel loop gives it."""
    from tdmpc2_tpu.envs import base as jbase, dmcontrol as jdmc, toy as jtoy
    from tdmpc2_tpu_torch.envs import base as tbase, dmcontrol as tdmc, toy as ttoy
    cfg = _cfg(work, jax=jax, obs='rgb', **kw)
    cfg.obs_shape, cfg.action_dim, cfg.episode_length = {'rgb': (9, 64, 64)}, 2, 50
    cfg.seed_steps = SEED_STEPS
    base, dmc, toy = (jbase, jdmc, jtoy) if jax else (tbase, tdmc, ttoy)
    env = base.NormalizeInfo(base.Timeout(dmc.PixelObs(toy.PointMassEnv(cfg.seed)), 50))
    parts = (dict(buffer=JBuffer(cfg), logger=JLogger(cfg)) if jax else
             dict(buffer=Buffer(cfg), logger=Logger(cfg)))
    agent = _PixelRecorder(cfg)
    trainer = (JOnlineTrainer if jax else OnlineTrainer)(cfg=cfg, env=env, agent=agent,
                                                         **parts)
    agent.trainer = trainer
    trainer.train()
    return trainer, agent.calls


def test_resumed_pixel_schedule_matches_jax_trainer(tmp_path):
    """A pixel run and its resumed continuation (a 3-episode snapshot of
    uint8 frames, a 100-step refill gate): the JAX trainer's update steps,
    and the same frames back in both rings."""
    eval_freq, steps1, steps2 = SPANS[1]
    runs = {}
    for jax in (True, False):
        work = tmp_path / ('jax' if jax else 'port')
        kw = dict(eval_freq=eval_freq, buffer_snapshot_eps=3)
        first = _pixel_run(jax, work, steps=steps1, **kw)
        second = _pixel_run(jax, work, steps=steps2, resume=True, resume_refill_steps=100,
                            **kw)
        runs[jax] = (first, second)
    (_, jcalls_f), (js, jcalls_s) = runs[True]
    (_, tcalls_f), (ts, tcalls_s) = runs[False]
    assert tcalls_f == jcalls_f and tcalls_s == jcalls_s and tcalls_s
    assert ts._refill_credit == js._refill_credit == 150
    n = ts.buffer.num_eps
    assert n == js.buffer.num_eps
    st = ts.buffer._storage['obs']
    assert st.dtype == torch.uint8 and st.shape[2] == 3 * 64 * 64
    np.testing.assert_array_equal(st[:n].numpy(), np.asarray(js.buffer._storage['obs'])[:n])
