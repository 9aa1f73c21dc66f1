"""PyTorch port vs the JAX package: the seed fleet, K seeds of one task in
one process (CPU, the JAX fleet tests' tiny widths, tests/test_fleet.py:19-38).

- `FleetAgent` against the JAX `FleetAgent` (whose plans are JAX's XLA
  planner), its seed-stacked state carried across by
  `interop.fleet_states_from_jax`: `act` with each seed's env fed the draws
  JAX made from its key (actions 1e-3, warm starts 1e-4), and the updates
  of `_update_scan` with JAX's draws (states and infos 1e-4);
- seed k against the port's single agent of seed k, bit for bit: init,
  `act` on their own draws, `update_many` on one fleet draw;
- `FleetBuffer` against the JAX `FleetBuffer` on the same episodes, bit for
  bit: per-seed isolation and `gather` on JAX's draws, the strict-length
  drop and the wrap, the padded partial flush, snapshots across packages;
- `FleetOnlineTrainer` against the JAX trainer with recording agents: the
  same calls, updates and flushes on the same envs, state and episodic
  (the owed updates drained); the port fleet end to end at a tiny width:
  per-seed artifacts, the update ratio, resume with the snapshot;
- checkpoints: a JAX `save_seed` through the port's `load_seeds`, a port
  `save_seed` through `TDMPC2.load`; `train` with `seeds=`.

Tolerances are the JAX suite's: 1e-4 for values and the update, 1e-3 for
actions."""

from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_planner import _jax_plan_noise, _perturb
from test_torch_train import _hold_states, _noise_from_jax
from test_torch_vec import _stack
from tdmpc2_tpu.config import Config as JConfig, parse_cfg as jparse
from tdmpc2_tpu.data.buffer import draw_slice_indices as jdraw
from tdmpc2_tpu.data.fleet_buffer import FleetBuffer as JFleetBuffer
from tdmpc2_tpu.envs import make_env as jmake_env
from tdmpc2_tpu.envs import make_fleet_env as jmake_fleet_env
from tdmpc2_tpu.fleet import FleetAgent as JFleetAgent
from tdmpc2_tpu.tdmpc2 import TDMPC2 as JTDMPC2
from tdmpc2_tpu.trainer.fleet_online import FleetOnlineTrainer as JFleetTrainer
from tdmpc2_tpu.utils.logger import Logger as JLogger
from tdmpc2_tpu_torch import train as train_mod
from tdmpc2_tpu_torch.config import Config, load_cfg, parse_cfg
from tdmpc2_tpu_torch.data.fleet_buffer import FleetBuffer
from tdmpc2_tpu_torch.envs import make_fleet_env
from tdmpc2_tpu_torch.fleet import FleetAgent
from tdmpc2_tpu_torch.interop import fleet_states_from_jax, state_from_jax
from tdmpc2_tpu_torch.tdmpc2 import TDMPC2
from tdmpc2_tpu_torch.trainer.fleet_online import FleetOnlineTrainer
from tdmpc2_tpu_torch.utils.logger import Logger
from torch_threads import one_torch_thread  # noqa: F401

OBS_DIM, ACT_DIM, EP_LEN = 6, 2, 20
SEEDS = [3, 7]
VTOL = dict(rtol=1e-4, atol=1e-4)
ATOL = dict(rtol=1e-3, atol=1e-3)
EXACT = dict(rtol=0, atol=0)


def _sizes(cfg, **kw):
    """JAX tests/test_fleet.py's `make_cfg`, for either package."""
    cfg.obs_shape = {'state': (OBS_DIM,)}
    cfg.action_dim, cfg.episode_length, cfg.seed_steps = ACT_DIM, EP_LEN, 40
    cfg.enc_dim = cfg.mlp_dim = 32
    cfg.latent_dim, cfg.num_samples, cfg.num_elites = 16, 32, 4
    cfg.num_pi_trajs, cfg.iterations, cfg.batch_size = 4, 1, 8
    cfg.num_q, cfg.num_envs = 2, 2
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _cfgs(**kw):
    return (_sizes(jparse(JConfig(task='toy')), **kw),
            _sizes(parse_cfg(Config(task='toy', device='cpu')), **kw))


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


def _fleets(**kw):
    """A JAX fleet and a port fleet holding the JAX fleet's states, the
    weights perturbed: at init the reward and Q heads are zero, every
    sample's value ties, and the two packages' top-k break ties apart."""
    jcfg, tcfg = _cfgs(**kw)
    jfleet = JFleetAgent(jcfg, SEEDS)
    jfleet.state = jfleet.state.replace(params=_perturb(jfleet.state.params))
    tfleet = FleetAgent(tcfg, SEEDS)
    tfleet.load_states(fleet_states_from_jax(_np(jfleet.state)))
    return jfleet, tfleet


# ----------------------------------------------------------------- agent


def test_fleet_states_from_jax_are_the_single_states():
    """Seed k of a JAX fleet is JAX's single agent of seed k (the JAX
    fleet's own test); carried across, it is `state_from_jax` of that
    single agent's state, bit for bit."""
    jcfg, _ = _cfgs()
    states = fleet_states_from_jax(_np(JFleetAgent(jcfg, SEEDS).state))
    for k, s in enumerate(SEEDS):
        single = JTDMPC2(jcfg.replace(seed=s, use_pallas=False))
        _hold_states(states[k], state_from_jax(single.state), EXACT)


def test_fleet_act_matches_jax_fleet():
    """Each seed's N envs plan with the draws the JAX fleet's vmapped
    `_plan_vec` made from that seed's key (env i: split(key, N + 1)[i]),
    from t0 and then from the warm starts."""
    jfleet, tfleet = _fleets()
    cfg = jfleet.cfg
    N = cfg.num_envs
    obs = np.random.default_rng(0).standard_normal(
        (len(SEEDS), N, OBS_DIM)).astype(np.float32)
    for t0 in (True, False):
        keys = np.asarray(jfleet.state.key)
        noise = [_stack([_jax_plan_noise(jax.random.split(keys[k], N + 1)[i],
                                         cfg, jfleet.agent.iterations)
                         for i in range(N)]) for k in range(len(SEEDS))]
        a_ref = jfleet.act(obs, t0=t0)
        a = tfleet.act(obs, t0=t0, noise=noise)
        assert a.shape == (len(SEEDS), N, ACT_DIM)
        _close(a, a_ref, ATOL)
        for k in range(len(SEEDS)):
            _close(tfleet.seed_state(k).prev_mean,
                   np.asarray(jfleet.state.prev_mean)[k], VTOL)


def test_fleet_update_matches_jax_fleet():
    """n = 2 updates a seed on per-seed batches: the JAX fleet's vmapped
    `_update_scan` against the port's steps with JAX's draws (each step's
    key the last of the previous one's nine splits); the seed-averaged
    info too."""
    jfleet, tfleet = _fleets()
    cfg = jfleet.cfg
    T, B, n, K = cfg.horizon, cfg.batch_size, 2, len(SEEDS)
    rng = np.random.default_rng(1)
    batch = (rng.standard_normal((K, n, T + 1, B, OBS_DIM)),
             rng.uniform(-1, 1, (K, n, T, B, ACT_DIM)),
             rng.standard_normal((K, n, T, B, 1)), np.zeros((K, n, T, B, 1)))
    batch = tuple(x.astype(np.float32) for x in batch)
    noise = []
    for key in np.asarray(jfleet.state.key):
        seq = []
        for _ in range(n):
            seq.append(_noise_from_jax(key, cfg))
            key = jax.random.split(key, 9)[-1]
        noise.append(seq)
    jfleet.state, jinfo = jfleet._update_scan_jit(jfleet.state, *batch)
    tinfo = tfleet._update_batches(tuple(torch.from_numpy(x) for x in batch),
                                   n, noise)
    assert set(tinfo) == set(jinfo)
    for k in tinfo:
        _close(float(tinfo[k]), float(jinfo[k]), VTOL)
    for k, st in enumerate(fleet_states_from_jax(_np(jfleet.state))):
        _hold_states(tfleet.seed_state(k), st)


def _singles(tcfg):
    return [TDMPC2(tcfg.replace(seed=s)) for s in SEEDS]


def test_fleet_seed_is_the_single_agent_bit_for_bit():
    """Seed k's init, plans on its own draws, and updates on the fleet's
    batches equal the port's single agent of seed k bit for bit."""
    _, tcfg = _cfgs()
    fleet, singles = FleetAgent(tcfg, SEEDS), _singles(tcfg)
    for k, single in enumerate(singles):
        _hold_states(fleet.seed_state(k), single.state, EXACT)
        assert torch.equal(fleet.agents[k].generator.get_state(),
                           single.generator.get_state())
    obs = np.random.default_rng(2).standard_normal(
        (len(SEEDS), tcfg.num_envs, OBS_DIM)).astype(np.float32)
    for t0 in (True, False):
        a = fleet.act(obs, t0=t0)
        for k, single in enumerate(singles):
            np.testing.assert_array_equal(a[k], single.act(obs[k], t0=t0))
    buf = FleetBuffer(tcfg, len(SEEDS))
    rng = np.random.default_rng(3)
    for k in range(len(SEEDS)):
        buf.add(k, _episodes(rng, 3))
    batch = buf.sample_many(2)
    fleet._update_batches(batch, 2)
    for k, single in enumerate(singles):
        for i in range(2):
            single._step(tuple(x[k, i] for x in batch))
        _hold_states(fleet.seed_state(k), single.state, EXACT)


# ----------------------------------------------------------------- buffer


def _episodes(rng, m, rows=EP_LEN + 1, **kw):
    ep = dict(obs=rng.standard_normal((m, rows, OBS_DIM)).astype(np.float32),
              action=rng.uniform(-1, 1, (m, rows, ACT_DIM)).astype(np.float32),
              reward=rng.standard_normal((m, rows)).astype(np.float32),
              terminated=np.zeros((m, rows), np.float32))
    ep.update(kw)
    return ep


def _jax_draw(jbuf, n):
    """The (episode, start) pairs the JAX buffer's next `sample_many(n)`
    draws (fleet_buffer.py:231-244)."""
    key = jax.random.fold_in(jbuf._key, jbuf._draws + 1)
    n_filled = np.minimum(jbuf._num_eps, jbuf._capacity_eps).astype(np.int32)
    ep, start = jax.vmap(lambda k, r, f: jdraw(
        k, r, f, n * jbuf._batch_size, jbuf._horizon, jbuf._capacity_eps))(
        jax.random.split(key, jbuf.K), jbuf._ep_rows, n_filled)
    return torch.from_numpy(np.array(ep)).long(), torch.from_numpy(np.array(start)).long()


def _hold_buffers(tbuf, jbuf):
    np.testing.assert_array_equal(tbuf._num_eps, jbuf._num_eps)
    np.testing.assert_array_equal(tbuf._ep_rows.numpy(), np.asarray(jbuf._ep_rows))
    for k, v in tbuf._storage.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jbuf._storage[k]))


def _buffers(**kw):
    jcfg, tcfg = _cfgs(**kw)
    return JFleetBuffer(jcfg, len(SEEDS)), FleetBuffer(tcfg, len(SEEDS))


def test_fleet_buffer_per_seed_isolation_and_layout():
    """Each seed samples from its own ring (the JAX test's constants), in
    the JAX layout; on JAX's draws `gather` gives the JAX batch bit for
    bit."""
    jbuf, tbuf = _buffers()
    rows = EP_LEN + 1
    for k, const in ((0, 1.0), (1, -1.0)):
        eps = dict(obs=np.full((3, rows, OBS_DIM), const, np.float32),
                   action=np.zeros((3, rows, ACT_DIM), np.float32),
                   reward=np.full((3, rows), const, np.float32),
                   terminated=np.zeros((3, rows), np.float32))
        assert tbuf.add(k, eps) == jbuf.add(k, eps) == 3
    assert tbuf.num_eps == 3
    obs, action, reward, term = tbuf.sample_many(2)
    T, B = tbuf._horizon, tbuf._batch_size
    assert obs.shape == (2, 2, T + 1, B, OBS_DIM)
    assert action.shape == (2, 2, T, B, ACT_DIM)
    assert reward.shape == term.shape == (2, 2, T, B, 1)
    assert bool((obs[0] == 1).all() and (obs[1] == -1).all())
    assert bool((reward[0] == 1).all() and (reward[1] == -1).all())
    rng = np.random.default_rng(4)
    for k in range(2):
        eps = _episodes(rng, 2)
        assert tbuf.add(k, eps) == jbuf.add(k, eps) == 5
    _hold_buffers(tbuf, jbuf)
    for n in (1, 3):
        draws = _jax_draw(jbuf, n)
        ref = jbuf.sample_many(n)
        for got, want in zip(tbuf.gather(*draws, n), ref[:4]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fleet_buffer_strict_length_and_wraparound():
    """A 4-episode ring: an episode too short for a slice is dropped and
    the oldest wraps out; the rings equal the JAX buffer's."""
    jbuf, tbuf = _buffers(buffer_size=4 * EP_LEN, steps=10 ** 6)
    rows = EP_LEN + 1
    eps = _episodes(np.random.default_rng(5), 6,
                    reward=np.arange(6, dtype=np.float32)[:, None].repeat(rows, 1),
                    valid_rows=np.asarray([rows, 2, rows, rows, rows, rows],
                                          np.int32))
    assert tbuf.add(0, eps) == jbuf.add(0, eps) == 5
    assert tbuf.add(1, eps) == jbuf.add(1, eps) == 5
    _hold_buffers(tbuf, jbuf)
    seen = set(np.unique(tbuf.sample_many(1)[2].numpy()).tolist())
    assert seen <= {2.0, 3.0, 4.0, 5.0}


def test_fleet_buffer_partial_flush_padded_block():
    """A flush of fewer episodes than num_envs fills a padded block: the
    count moves by the real episodes, the pad slots have zero rows and are
    never sampled, the next write overwrites them; as the JAX buffer."""
    jbuf, tbuf = _buffers(num_envs=4)
    rows = EP_LEN + 1

    def eps(m, value):
        return dict(obs=np.full((m, rows, OBS_DIM), value, np.float32),
                    action=np.zeros((m, rows, ACT_DIM), np.float32),
                    reward=np.full((m, rows), value, np.float32),
                    terminated=np.zeros((m, rows), np.float32))
    for k in range(2):
        assert tbuf.add(k, eps(1, 7.0)) == jbuf.add(k, eps(1, 7.0)) == 1
    _hold_buffers(tbuf, jbuf)
    assert int(tbuf._ep_rows[0, 0]) == rows
    assert not bool(tbuf._ep_rows[0, 1:4].any())
    assert bool((tbuf.sample_many(1)[2] == 7.0).all())
    for k in range(2):
        assert tbuf.add(k, eps(3, 9.0)) == jbuf.add(k, eps(3, 9.0)) == 4
    _hold_buffers(tbuf, jbuf)
    seen = set(np.unique(tbuf.sample_many(1)[2].numpy()).tolist())
    assert seen <= {7.0, 9.0} and 9.0 in seen


def test_fleet_buffer_snapshots_across_packages(tmp_path):
    """A port snapshot restores into the JAX buffer and a JAX one into the
    port's: the same rings and the same refill credit."""
    jbuf, tbuf = _buffers()
    rng = np.random.default_rng(6)
    for k in range(2):
        eps = _episodes(rng, 3 + k, valid_rows=np.full(3 + k, EP_LEN - 3))
        tbuf.add(k, eps)
        jbuf.add(k, eps)
    credit = tbuf.save_snapshot(tmp_path / 'port.npz', 2)
    assert credit == jbuf.save_snapshot(tmp_path / 'jax.npz', 2) == 2 * (EP_LEN - 4)
    jback, tback = _buffers()
    assert jback.load_snapshot(tmp_path / 'port.npz') == credit
    assert tback.load_snapshot(tmp_path / 'jax.npz') == credit
    _hold_buffers(tback, jback)


# ----------------------------------------------------------------- trainer


class _StubFleet:
    """Records the trainer's calls; actions are a fixed function of obs."""

    def __init__(self, log, cfg, work):
        self.log, self.cfg, self.work = log, cfg, work
        self.seeds, self.K = list(SEEDS), len(SEEDS)
        self.agent = SimpleNamespace(model=SimpleNamespace(total_params=lambda p: 0),
                                     state=SimpleNamespace(params={}))
        self.agents = [SimpleNamespace(state=SimpleNamespace(params={}))]

    @staticmethod
    def _a(obs):
        return np.tanh(np.asarray(obs, np.float32)[..., :2])

    def act(self, obs, t0=False, eval_mode=False):
        self.log.append(('act', bool(eval_mode), np.asarray(t0).tolist()))
        return self._a(obs)

    def update_many(self, buffer, n):
        self.log.append(('update_many', n))
        return {'total_loss': 0.0}

    def update_many_fused(self, buffer, n):
        self.log.append(('update_many_fused', n))
        return {'total_loss': 0.0}

    def step(self, buffer, obs, t0, n):
        self.log.append(('step', np.asarray(t0).tolist(), n))
        return self._a(obs), {'total_loss': 0.0}

    def save_seed(self, k, fp, extra=None):
        self.log.append(('save', k, extra['step']))

    def work_dir(self, k):
        return Path(self.work) / str(SEEDS[k])


class _StubBuffer:
    def __init__(self, log, rows):
        self.log, self._rows = log, rows
        self._num_eps = np.zeros(len(SEEDS), np.int64)

    @property
    def num_eps(self):
        return int(self._num_eps.min())

    def add(self, k, block):
        self.log.append(('add', k, block['valid_rows'].tolist(),
                         float(block['obs'].sum()),
                         float(np.nansum(block['reward']))))
        self._num_eps[k] += len(block['valid_rows'])
        return int(self._num_eps[k])


def _as_port_steps(log):
    """The JAX trainer's pipelined planned vector step after the burst
    (`act` then `update_many_fused(N)`, and a second one while updates are
    owed) written as the port's `step` call (and `update_many`)."""
    out, i = [], 0
    while i < len(log):
        e = log[i]
        nxt = log[i + 1] if i + 1 < len(log) else ()
        if e[:2] == ('act', False) and nxt[:1] == ('update_many_fused',):
            out.append(('step', e[2], nxt[1]))
            i += 2
        elif e[0] == 'update_many_fused':
            out.append(('update_many', e[1]))
            i += 1
        else:
            out.append(e)
            i += 1
    return out


@pytest.mark.parametrize('task', ['toy-reach', 'toy-reach-episodic'])
def test_fleet_trainer_schedule_matches_jax_trainer(tmp_path, task):
    """The same K x N env copies and recording agents under both trainers:
    the same calls in the same order (random actions, the seed burst with
    the owed updates folded in, `step` a planned vector step, the drain of
    owed updates at twice the rate) and the same per-seed flushes. The
    episodic task's goal-reaching episodes end at different steps across
    slots, so the slowest seed's first flush closes the gate for a while."""
    logs = {}
    for name, (C, P, mk, Trainer, Log) in {
            'jax': (JConfig, jparse, jmake_fleet_env, JFleetTrainer, JLogger),
            'port': (Config, parse_cfg, make_fleet_env, FleetOnlineTrainer,
                     Logger)}.items():
        kw = dict(task=task, num_envs=2, steps=240, eval_freq=120,
                  eval_episodes=1, save_csv=False, save_agent=True,
                  episodic=task.endswith('episodic'))
        if name == 'port':
            kw['device'] = 'cpu'
        cfg = P(C(**kw))
        cfg.work_dir = str(tmp_path / name / 'x' / 'default')
        env = mk(cfg, SEEDS)
        cfg.seed_steps = 20
        log = []
        tr = Trainer(cfg=cfg, env=env, agent=_StubFleet(log, cfg, tmp_path / name),
                     buffer=_StubBuffer(log, cfg.episode_length + 1),
                     loggers=[Log(cfg.replace(work_dir=str(tmp_path / name / str(s))))
                              for s in SEEDS])
        tr.train()
        logs[name] = (log, tr._n_updates, tr._step, tr._update_deficit)
    assert logs['port'][0] == _as_port_steps(logs['jax'][0])
    assert logs['port'][1:] == logs['jax'][1:]
    calls = {e[0] for e in logs['port'][0]}
    assert {'act', 'update_many', 'add', 'step', 'save'} <= calls
    n_upd, step, deficit = logs['port'][1:]
    assert deficit == 0 and abs(n_upd - step) <= 2
    log = logs['port'][0]
    first = next(i for i, e in enumerate(log) if e[0] == 'step')
    burst = sum(e[1] for e in log[:first] if e[0] == 'update_many')
    # the gate opened at the first flushes, after the 20 seed steps: the
    # updates owed since joined the burst
    assert burst > 20 and burst % 2 == 0


def _tiny(tmp_path, task='toy-reach', **kw):
    cfg = parse_cfg(Config(task=task, device='cpu', batch_size=8, enc_dim=32,
                           mlp_dim=32, latent_dim=16, num_q=2, num_samples=16,
                           num_elites=4, num_pi_trajs=2, iterations=1,
                           num_envs=2, eval_episodes=1, **kw))
    cfg.work_dir = str(tmp_path / 'logs' / task / str(cfg.seed) / cfg.exp_name)
    return cfg


def _fleet_trainer(cfg, seed_steps):
    env = make_fleet_env(cfg, SEEDS)
    cfg.seed_steps = seed_steps
    agent = FleetAgent(cfg, SEEDS)
    loggers = [Logger(cfg.replace(seed=s, work_dir=str(agent.work_dir(k))))
               for k, s in enumerate(SEEDS)]
    return FleetOnlineTrainer(cfg=cfg, env=env, agent=agent,
                              buffer=FleetBuffer(cfg, len(SEEDS)), loggers=loggers)


@pytest.fixture(scope='module')
def fleet_run(tmp_path_factory):
    """A two-seed toy-reach fleet for 220 steps (JAX
    test_fleet_train_loop_end_to_end): collection, the burst, the planned
    steps, the evals at 0 and 200 with checkpoints and snapshots."""
    tmp = tmp_path_factory.mktemp('fleet')
    cfg = _tiny(tmp, steps=220, eval_freq=200, buffer_snapshot_eps=2)
    tr = _fleet_trainer(cfg, 60)
    tr.train()
    return tmp, cfg, tr


def test_fleet_train_loop_end_to_end(fleet_run):
    """Per-seed eval.csv and checkpoints in the single-seed layout; the
    checkpoint loads into the port's single agent and the JAX agent."""
    tmp, cfg, tr = fleet_run
    assert tr._step >= cfg.steps and tr.buffer.num_eps >= 2
    assert tr._n_updates == 60 + 2 * len(range(62, 221, 2))
    for s in SEEDS:
        d = tmp / 'logs' / 'toy-reach' / str(s) / 'default'
        csv = (d / 'eval.csv').read_text().splitlines()
        assert csv[0] == 'step,episode_reward,episode_success' and len(csv) == 3
        assert (d / 'models' / 'latest.pkl').exists()
    fp = tmp / 'logs' / 'toy-reach' / str(SEEDS[0]) / 'default' / 'models' / 'latest.pkl'
    single = TDMPC2(cfg.replace(seed=SEEDS[0]))
    assert single.load(fp)['step'] == tr._step
    _hold_states(single.state, tr.agent.seed_state(0), EXACT)
    jcfg = jparse(JConfig(task='toy-reach', batch_size=8, enc_dim=32, mlp_dim=32,
                          latent_dim=16, num_q=2, num_samples=16, num_elites=4,
                          num_pi_trajs=2, iterations=1, use_pallas=False))
    jmake_env(jcfg)
    jag = JTDMPC2(jcfg)
    assert int(jag.load(str(fp))['step']) == tr._step
    np.testing.assert_array_equal(np.asarray(jag.state.params['pi'][0]['w']),
                                  single.state.params['pi'][0]['w'].numpy())


def test_fleet_resume_restores_buffer_snapshot(fleet_run):
    """A fresh fleet with resume=true takes every seed's checkpoint and
    step and the fleet snapshot next to seed 0's, with its refill credit
    (JAX test_fleet_resume_restores_buffer_snapshot)."""
    tmp, cfg, tr = fleet_run
    assert (tr.agent.work_dir(0) / 'models' / 'fleet_buffer.npz').exists()
    cfg2 = _tiny(tmp, steps=400, eval_freq=200, buffer_snapshot_eps=2,
                 resume=True, resume_refill_steps=30)
    tr2 = _fleet_trainer(cfg2, 60)
    tr2.maybe_resume()
    assert tr2._step == tr._step
    assert tr2._refill_credit >= 30 and tr2.buffer.num_eps >= 2 and tr2._refill_done()
    for k in range(len(SEEDS)):
        _hold_states(tr2.agent.seed_state(k), tr.agent.seed_state(k), EXACT)


def test_fleet_episodic_update_step_ratio(tmp_path):
    """An episodic fleet owes no updates by the end: the stall until the
    slowest seed's first episode is drained, one update per env step a
    seed (JAX test_fleet_episodic_update_step_ratio)."""
    cfg = _tiny(tmp_path, task='toy-reach-episodic', episodic=True, steps=200,
                eval_freq=10 ** 9, save_agent=False)
    tr = _fleet_trainer(cfg, 20)
    tr.train()
    assert tr._update_deficit == 0, 'owed updates were never made up'
    assert abs(tr._n_updates - tr._step) <= cfg.num_envs


# ------------------------------------------------------------ checkpoints


def test_jax_save_seed_loads_through_port_load_seeds(tmp_path):
    """A JAX fleet's `save_seed` files load through the port's `load_seeds`
    as `fleet_states_from_jax` gives them; a port `save_seed` loads into
    the port's single agent bit for bit."""
    jfleet, tfleet = _fleets()
    fps = [tmp_path / f'jax{k}.pkl' for k in range(len(SEEDS))]
    for k, fp in enumerate(fps):
        jfleet.save_seed(k, str(fp), extra=dict(step=10 + k))
    _, tcfg = _cfgs()
    other = FleetAgent(tcfg, SEEDS)
    assert [e['step'] for e in other.load_seeds(fps)] == [10, 11]
    for k, st in enumerate(fleet_states_from_jax(_np(jfleet.state))):
        _hold_states(other.seed_state(k), st, EXACT)
    tfleet.save_seed(1, tmp_path / 'port1.pkl', extra=dict(step=5))
    single = TDMPC2(tcfg.replace(seed=SEEDS[1]))
    assert single.load(tmp_path / 'port1.pkl') == {'step': 5}
    _hold_states(single.state, tfleet.seed_state(1), EXACT)


def test_train_takes_seeds(tmp_path, monkeypatch):
    """`seeds=3,7` trains a fleet with a logger a seed in the single-seed
    layout; `seeds=5` is a plain run of seed 5 with its work dir; a fleet
    over a mesh waits on A10."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(FleetOnlineTrainer, 'train', lambda self: None)
    monkeypatch.setattr(train_mod.OnlineTrainer, 'train', lambda self: None)
    argv = ['task=toy-reach', 'device=cpu', 'steps=100', 'mlp_dim=32',
            'latent_dim=16', 'enc_dim=32']
    tr = train_mod.main(argv + ['seeds=3,7', 'num_envs=2'])
    assert isinstance(tr, FleetOnlineTrainer) and tr.agent.seeds == [3, 7]
    assert [lg.cfg.work_dir for lg in tr.loggers] == [
        str(tmp_path / 'logs' / 'toy-reach' / s / 'default') for s in ('3', '7')]
    assert tr.env.num_envs == 4 and tr.N == 2
    tr = train_mod.main(argv + ['seeds=5'])
    assert type(tr).__name__ == 'OnlineTrainer' and tr.cfg.seed == 5
    assert tr.cfg.work_dir == str(tmp_path / 'logs' / 'toy-reach' / '5' / 'default')
    with pytest.raises(ValueError, match='A10'):
        load_cfg(overrides=argv + ['seeds=3,7', 'mesh_shape=2x1'])
    with pytest.raises(ValueError, match='state observations'):
        FleetBuffer(parse_cfg(Config(task='toy-reach', obs='rgb', device='cpu',
                                     episode_length=50)), 2)
