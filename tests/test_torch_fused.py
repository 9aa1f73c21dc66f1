"""PyTorch port vs the JAX package: the collection step built on the
update (CPU, small widths, f32).

- `vec_step` against `act` + `update_many` on the same draws, bit for bit:
  actions, infos, the train state, the warm starts and both generators
  (the port's case of JAX tests/test_fused_step.py), with no update owed
  too, and a ring in host RAM taking `act` + `update_many`, as the JAX
  agent's does;
- the update-chunk cap: `sample_batch_bytes` and the ring's bytes against
  the JAX buffer's, `_auto_update_chunk` against the JAX agent's on the
  same free-bytes number (no cap without one), and a capped `update_many`
  and `vec_step` drawing their batches chunk by chunk as JAX's
  `update_many` does;
- `buffer_device` placement against the JAX buffer's;
- the new keys' defaults against JAX's `Config`, `profiler_port` refused;
- `profile_dir`: ten updates in place of one, their trace written;
- `VecOnlineTrainer` end to end under each JAX schedule's keys, and with
  `vec_step` replaced by `act` + `update_many`: the same run bit for bit
  (JAX tests/test_fused_step.py::test_vec_trainer_fused_equals_unfused).
"""

import json
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tdmpc2_tpu.data.buffer as jbuffer_mod
import tdmpc2_tpu.tdmpc2 as jagent_mod
from tdmpc2_tpu.config import Config as JConfig, parse_cfg as jparse
from tdmpc2_tpu.data.buffer import Buffer as JBuffer
from tdmpc2_tpu.tdmpc2 import TDMPC2 as JTDMPC2
from test_torch_train import _episode
import tdmpc2_tpu_torch.tdmpc2 as agent_mod
from tdmpc2_tpu_torch.config import Config, load_cfg, parse_cfg
from tdmpc2_tpu_torch.data.buffer import Buffer
from tdmpc2_tpu_torch.envs import make_env
from tdmpc2_tpu_torch.tdmpc2 import TDMPC2
from tdmpc2_tpu_torch.trainer.online import OnlineTrainer
from tdmpc2_tpu_torch.trainer.vec_online import VecOnlineTrainer
from tdmpc2_tpu_torch.utils import tree
from tdmpc2_tpu_torch.utils.logger import Logger

OBS, ACT, EP_LEN, N = 6, 2, 20, 2
SMALL = dict(enc_dim=32, mlp_dim=32, latent_dim=16, num_samples=32,
             num_elites=4, num_pi_trajs=4, iterations=1, batch_size=8, num_q=2,
             num_envs=N)


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in this module: the trainer runs' many
    small ops spin in oversubscribed parallel regions when the suite runs
    several workers (a vectorised run took 45x its time alone), and the
    comparisons here are of runs in one process, bit for bit either way."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(pkg=None, **kw):
    """JAX tests/test_fused_step.py's `make_cfg`, for either package."""
    if pkg == 'jax':
        cfg = jparse(JConfig(task='toy'))
        cfg.use_pallas = False
    else:
        cfg = parse_cfg(Config(task='toy', device='cpu'))
    cfg.obs_shape, cfg.action_dim, cfg.episode_length = {'state': (OBS,)}, ACT, EP_LEN
    cfg.seed_steps, cfg.buffer_device = 40, 'device'
    for k, v in {**SMALL, **kw}.items():
        setattr(cfg, k, v)
    return cfg


def _filled(cfg, cls=Buffer, n_eps=3, seed=0):
    buf = cls(cfg)
    rng = np.random.default_rng(seed)
    for _ in range(n_eps):
        buf.add(_episode(rng, EP_LEN + 1, OBS, ACT))
    return buf


def _same(a, b):
    """Two agents' and buffers' whole state, bit for bit."""
    (ag_a, buf_a), (ag_b, buf_b) = a, b
    for name in ('params', 'target_Qs', 'opt_state', 'pi_opt_state', 'scale',
                 'prev_mean'):
        for x, y in zip(tree.leaves(getattr(ag_a.state, name)),
                        tree.leaves(getattr(ag_b.state, name))):
            assert torch.equal(x, y), name
    assert torch.equal(ag_a.generator.get_state(), ag_b.generator.get_state())
    assert torch.equal(buf_a.generator.get_state(), buf_b.generator.get_state())
    assert buf_a._draws == buf_b._draws


def _equal_infos(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize('k', [N, 0], ids=['vec_step', 'no-updates'])
def test_fused_schedule_matches_act_then_update_many(k, monkeypatch):
    """vec_step (JAX ::test_vec_step_matches_act_then_update_many) equals
    act + update_many on the same draws, bit for bit, without calling act;
    with no update owed (k = 0, a step under update_ratio < 1) it is the
    plan alone."""
    cfg = _cfg()
    seq, fused = (TDMPC2(cfg), _filled(cfg)), (TDMPC2(cfg), _filled(cfg))
    assert fused[1].on_device
    monkeypatch.setattr(fused[0], 'act', lambda *a, **kw: pytest.fail(
        'vec_step took the host ring\'s calls'))
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((N, OBS)).astype(np.float32)
    t0 = np.array([True, False])
    for _ in range(3):
        a_seq = seq[0].act(obs, t0=t0)
        info_seq = seq[0].update_many(seq[1], k) if k else None
        a_f, info_f = fused[0].vec_step(fused[1], obs, t0, k)
        np.testing.assert_array_equal(a_seq, a_f)
        if k:
            _equal_infos(info_seq, info_f)
        else:
            assert info_f is None
        t0 = np.array([False, False])
        obs = rng.standard_normal((N, OBS)).astype(np.float32)
    _same(seq, fused)
    # one update a step: the unbatched sample
    a_seq = seq[0].act(obs[:1], t0=True)
    seq[0].update_many(seq[1], 1)
    a_f, _ = fused[0].vec_step(fused[1], obs[:1], np.array([True]), 1)
    np.testing.assert_array_equal(a_seq, a_f)
    _same(seq, fused)


def test_vec_step_host_buffer_fallback(monkeypatch):
    """A ring in host RAM takes act + update_many in vec_step (JAX
    ::test_vec_step_host_buffer_fallback), with the same numbers as the
    one-call path on a device ring."""
    cfg = _cfg(buffer_device='host')
    agent, buf = TDMPC2(cfg), _filled(cfg)
    ref = (TDMPC2(cfg), _filled(_cfg()))
    assert not buf.on_device and ref[1].on_device
    calls = []
    for name in ('act', 'update_many'):
        fn = getattr(agent, name)
        monkeypatch.setattr(agent, name, lambda *a, fn=fn, name=name, **k: (
            calls.append(name), fn(*a, **k))[1])
    obs = np.zeros((N, OBS), np.float32)
    t0 = np.array([True, True])
    a, info = agent.vec_step(buf, obs, t0, N)
    assert calls == ['act', 'update_many'] and a.shape == (N, ACT)
    assert np.isfinite(float(info['total_loss']))
    a_ref, info_ref = ref[0].vec_step(ref[1], obs, t0, N)
    np.testing.assert_array_equal(a, a_ref)
    _equal_infos(info_ref, info)
    _same((agent, buf), ref)


# ------------------------------------------------------- the update-chunk cap


def _rgb_episode(rng, rows):
    ep = _episode(rng, rows, 1, ACT)
    ep['obs'] = rng.integers(0, 256, (rows, 9, 16, 16), dtype=np.uint8)
    return ep


@pytest.mark.parametrize('obs', ['state', 'rgb'])
def test_batch_and_ring_bytes_match_jax_buffer(obs):
    rng = np.random.default_rng(2)
    eps = [(_rgb_episode if obs == 'rgb' else
            lambda r, n: _episode(r, n, OBS, ACT))(rng, EP_LEN + 1) for _ in range(2)]
    got = {}
    for pkg, cls in (('jax', JBuffer), ('port', Buffer)):
        cfg = _cfg(pkg, obs=obs)
        buf = cls(cfg)
        assert buf.sample_batch_bytes() is None
        for ep in eps:
            buf.add({k: v.copy() for k, v in ep.items()})
        got[pkg] = (buf.sample_batch_bytes(), buf.device_ring_bytes() if pkg == 'jax'
                    else sum(v.numel() * v.element_size()
                             for v in buf._storage.values()))
    assert got['port'] == got['jax'] and got['port'][0] > 0 and got['port'][1] > 0


def _jax_agent(cfg, **attrs):
    """The JAX agent's update-chunk methods on `cfg`, without its train
    state: a namespace that JAX's own methods run on."""
    ns = SimpleNamespace(cfg=cfg, mesh=None, state=None, **attrs)
    for name in ('_auto_update_chunk', '_update_chunk', 'update_many'):
        setattr(ns, name, partial(getattr(JTDMPC2, name), ns))
    return ns


@pytest.mark.parametrize('free_mb', [1, 2250, 4000])
def test_auto_update_chunk_matches_jax(free_mb, monkeypatch):
    """The same free-bytes number gives the same cap in both agents (the
    port's reserve set to JAX's, whose v5e number the port replaces)."""
    free = free_mb * 1_000_000
    monkeypatch.setattr(jagent_mod, '_device_free_bytes', lambda: free)
    monkeypatch.setattr(agent_mod, 'device_free_bytes', lambda dev: free)
    monkeypatch.setattr(TDMPC2, '_MEM_RESERVE_BYTES', JTDMPC2._HBM_RESERVE_BYTES)
    jcfg, tcfg = _cfg('jax'), _cfg()
    jag = _jax_agent(jcfg, _HBM_RESERVE_BYTES=JTDMPC2._HBM_RESERVE_BYTES)
    tag = TDMPC2(tcfg)
    jbuf, tbuf = _filled(jcfg, JBuffer), _filled(tcfg)
    want = jag._auto_update_chunk(jbuf)
    assert tag._auto_update_chunk(tbuf) == want >= 1
    assert tag._update_chunk(tbuf) == jag._update_chunk(jbuf) == want
    assert TDMPC2(_cfg(update_chunk=3))._update_chunk(tbuf) == 3


def test_auto_update_chunk_without_free_bytes_is_no_cap(monkeypatch):
    """Where the device reports no free bytes (the CPU) the auto cap is 0,
    no cap, whatever the batch; so is a ring not yet written."""
    monkeypatch.setattr(agent_mod, 'device_free_bytes', lambda dev: None)
    cfg = _cfg()
    tag = TDMPC2(cfg)
    assert tag._update_chunk(Buffer(cfg)) == 0
    buf = _filled(cfg)
    assert buf.sample_batch_bytes() > 0
    assert tag._auto_update_chunk(buf) == tag._update_chunk(buf) == 0
    monkeypatch.setattr(agent_mod, 'device_free_bytes', lambda dev: 10**12)
    assert tag._auto_update_chunk(Buffer(cfg)) == 0       # no batch bytes yet
    assert tag._auto_update_chunk(buf) > 0


def test_chunked_update_many_draws_as_jax(monkeypatch):
    """update_chunk=3: update_many(8) draws 3, 3 and 2 batches, as the JAX
    agent's does, and so do vec_step's 8 updates; both equal update_many
    calls of those sizes bit for bit."""
    sizes = {}
    for pkg, cls in (('jax', JBuffer), ('port', Buffer)):
        many = cls.sample_many
        monkeypatch.setattr(cls, 'sample_many', lambda self, n, many=many, pkg=pkg: (
            sizes.setdefault(pkg, []).append(n), many(self, n))[1])
    jcfg = _cfg('jax', update_chunk=3)
    jag = _jax_agent(jcfg, _update_scan_jit=lambda state, *batch: (state, {}))
    jag.update_many(_filled(jcfg, JBuffer), 8)      # its draws, no update
    cfg = _cfg(update_chunk=3)
    capped, plain = (TDMPC2(cfg), _filled(cfg)), (TDMPC2(_cfg()), _filled(_cfg()))
    obs, t0 = np.ones((N, OBS), np.float32), np.array([True, False])
    capped[0].update_many(capped[1], 8)
    a_capped, _ = capped[0].vec_step(capped[1], obs, t0, 8)
    assert sizes['jax'] == [3, 3, 2] and sizes['port'] == sizes['jax'] * 2
    for n in (3, 3, 2):
        plain[0].update_many(plain[1], n)
    a_plain = plain[0].act(obs, t0=t0)
    for n in (3, 3, 2):
        plain[0].update_many(plain[1], n)
    np.testing.assert_array_equal(a_capped, a_plain)
    _same(capped, plain)


# ----------------------------------------------------------- placement, keys


@pytest.mark.parametrize('mode', ['auto', 'device', 'host'])
@pytest.mark.parametrize('free', [None, 10_000, 10**9])
def test_buffer_device_placement_matches_jax(mode, free, monkeypatch):
    """Each mode under a card's free-bytes number (None: no number, the
    CPU) places the ring where the JAX buffer does."""
    monkeypatch.setattr(jbuffer_mod, '_device_free_bytes', lambda: free)
    monkeypatch.setattr(JBuffer, '_TRIAL_HEADROOM', 1 << 10)
    import tdmpc2_tpu_torch.data.buffer as buffer_mod
    monkeypatch.setattr(buffer_mod, 'device_free_bytes', lambda dev: free)
    jbuf = _filled(_cfg('jax', buffer_device=mode), JBuffer, n_eps=1)
    buf = _filled(_cfg(buffer_device=mode), n_eps=1)
    assert buf.on_device == jbuf._on_device
    with pytest.raises(AssertionError):
        _filled(_cfg('jax', buffer_device='hbm'), JBuffer, n_eps=1)
    with pytest.raises(ValueError, match='buffer_device'):
        Buffer(_cfg(buffer_device='hbm'))


KEYS = ('update_chunk', 'fused_step', 'overlap_update', 'buffer_device',
        'profile_dir')


def test_new_keys_take_jax_defaults_and_profiler_port_is_refused():
    jcfg, cfg = JConfig(), Config()
    for k in KEYS:
        assert getattr(cfg, k) == getattr(jcfg, k), k
    over = ['task=toy-reach', 'update_chunk=4', 'fused_step=false',
            'overlap_update=false', 'buffer_device=host', 'profile_dir=/x',
            'profiler_port=null']
    cfg = load_cfg(overrides=over)
    assert [getattr(cfg, k) for k in KEYS] == [4, False, False, 'host', '/x']
    assert jcfg.profiler_port is None
    with pytest.raises(ValueError, match='torch has no counterpart'):
        load_cfg(overrides=['task=toy-reach', 'profiler_port=9012'])


# ----------------------------------------------------------------- trainers


def _tiny_train_cfg(tmp_path, **kw):
    cfg = parse_cfg(Config(**{**dict(
        task='toy-reach', device='cpu', batch_size=8, latent_dim=16, mlp_dim=32,
        enc_dim=32, num_q=2, num_bins=5, num_samples=16, num_elites=4,
        num_pi_trajs=2, iterations=1, eval_episodes=1, eval_freq=1000,
        save_agent=False, save_csv=False), **kw}))
    cfg.work_dir = str(tmp_path)
    return cfg


def _trainer(cls, cfg, seed_steps):
    """`cls` on a fresh agent, its buffer holding two random episodes, so
    that the burst comes at `seed_steps` before any episode has ended."""
    env = make_env(cfg)
    cfg.seed_steps = seed_steps
    buf = Buffer(cfg)
    rng = np.random.default_rng(3)
    for _ in range(2):
        buf.add(_episode(rng, cfg.episode_length + 1, cfg.obs_shape['state'][0],
                         cfg.action_dim))
    return cls(cfg=cfg, env=env, agent=TDMPC2(cfg), buffer=buf, logger=Logger(cfg))


def test_profile_dir_traces_ten_updates(tmp_path, monkeypatch):
    """At the first step that owes one update, ten updates under the
    profiler in its place (JAX online.py:203-210); the trace is written."""
    steps = []
    update = TDMPC2.update
    monkeypatch.setattr(TDMPC2, 'update', lambda self, buf: (
        steps.append(trainer._step), update(self, buf))[1])
    cfg = _tiny_train_cfg(tmp_path, steps=6, profile_dir=str(tmp_path / 'prof'))
    trainer = _trainer(OnlineTrainer, cfg, 2)
    trainer.train()
    assert steps == [2, 2] + [3] * 10 + [4, 5, 6]
    trace = json.loads((tmp_path / 'prof' / 'updates.trace.json').read_text())
    assert trace['traceEvents']


def test_vec_trainer_schedules_give_the_same_run(tmp_path):
    """A vectorised run under the keys of the JAX trainer's pipelined, one-call
    and unfused schedules, each a `vec_step` a planned vector step, and one
    whose `vec_step` is replaced by `act` + `update_many`: the same final
    train state, warm starts and generators bit for bit (JAX
    ::test_vec_trainer_fused_equals_unfused)."""
    runs = {}
    for name, fused, overlap in (('pipe', True, True), ('one', True, False),
                                 ('unfused', False, True), ('plain', True, True)):
        cfg = _tiny_train_cfg(tmp_path / name, steps=20, num_envs=N,
                              fused_step=fused, overlap_update=overlap)
        trainer = _trainer(VecOnlineTrainer, cfg, 4)
        agent, buf = trainer.agent, trainer.buffer
        calls = []
        if name == 'plain':
            agent.vec_step = lambda buf, obs, t0, k: (
                calls.append('act'), agent.act(obs, t0=t0),
                agent.update_many(buf, k) if k else None)[1:]
        else:
            vec_step = agent.vec_step
            agent.vec_step = lambda *a: (calls.append('vec_step'), vec_step(*a))[1]
        trainer.train()
        assert calls and set(calls) == {'act' if name == 'plain' else 'vec_step'}
        runs[name] = (agent, buf)
    for name in ('pipe', 'one', 'unfused'):
        _same(runs[name], runs['plain'])
