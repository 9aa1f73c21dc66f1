"""PyTorch port vs the JAX package: batched acting and vectorised online
training, num_envs > 1 (CPU, small widths, f32).

- the value step and the CEM loop for N envs at once (plain versions)
  against the JAX Pallas kernels' env axis, run interpreted with f32 dots
  through `jax.vmap` (their custom_vmap rules), with per-env Q heads and
  discounts, and a sample count that is not a multiple of the row block;
- `plan_vec` against the JAX agent's `_plan_vec`, each env fed the draws
  JAX made from its own key;
- n `_step`s, the steps `update_many` takes, against n sequential
  `_update`s (exact) and against JAX `_update_scan` from
  `interop.state_from_jax` (1e-4);
- `Buffer.sample_many`'s layout against the JAX buffer's;
- `VecEnv` against the JAX `VecEnv` (exact);
- `VecOnlineTrainer`: its call schedule and episode flushes against each
  of the JAX trainer's schedules (the pipelined `act_collect` +
  `update_many_fused`, the one-call `vec_step`, and `fused_step=false`),
  each of whose planned vector steps the port takes as one `vec_step`, a
  run end to end, the final-boundary eval and the checkpoint at eval.

Tolerances are the JAX suite's: 1e-4 for values, plan means and the
update, 1e-3 for actions."""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_planner import _jax_plan_noise, _perturb, _small
from test_torch_train import _cfgs, _episode, _hold_states, _noise_from_jax
from tdmpc2_tpu.config import Config as JConfig, parse_cfg as jparse
from tdmpc2_tpu.data.buffer import Buffer as JBuffer
from tdmpc2_tpu.data.buffer import draw_slice_indices as jdraw
from tdmpc2_tpu.envs import make_env as jmake_env
from tdmpc2_tpu.models import layers as jl
from tdmpc2_tpu.ops.pallas_cem import cem_prepared
from tdmpc2_tpu.ops.pallas_rollout import (prepare_value_params as jprepare,
                                           value_prepared)
from tdmpc2_tpu.tdmpc2 import TDMPC2 as JTDMPC2
from tdmpc2_tpu.trainer.vec_online import VecOnlineTrainer as JVecTrainer
from tdmpc2_tpu.utils.logger import Logger as JLogger
from tdmpc2_tpu_torch.config import Config, load_cfg, parse_cfg
from tdmpc2_tpu_torch.data.buffer import Buffer
from tdmpc2_tpu_torch.envs import make_env
from tdmpc2_tpu_torch.interop import params_from_jax, state_from_jax
from tdmpc2_tpu_torch.ops import cem
from tdmpc2_tpu_torch.ops.value import (prepare_value_params, value_estimate,
                                        value_estimate_plain)
from tdmpc2_tpu_torch.tdmpc2 import TDMPC2, PlanNoise
from tdmpc2_tpu_torch.trainer.vec_online import VecOnlineTrainer
from tdmpc2_tpu_torch.utils.logger import Logger
from torch_threads import one_torch_thread  # noqa: F401

VTOL = dict(rtol=1e-4, atol=1e-4)
ATOL = dict(rtol=1e-3, atol=1e-3)
EXACT = dict(rtol=0, atol=0)
N = 3


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **tol)


@pytest.fixture(scope='module')
def agents():
    jagent = JTDMPC2(_small(jparse(JConfig(task='toy'))))
    jp = _perturb(jagent.state.params)
    tagent = TDMPC2(_small(parse_cfg(Config(task='toy', device='cpu',
                                            num_envs=N))))
    tagent.load_params(params_from_jax(jax.tree.map(np.asarray, jp)))
    return jagent, jp, tagent


def _heads(agent):
    return dict(log_std_min=agent.model.log_std_min,
                log_std_dif=agent.model.log_std_dif)


# ----------------------------------------------------------------- value


@pytest.mark.parametrize('S,block_s,zrows', [(32, 16, 'rows'), (20, 128, 'rows'),
                                             (32, 16, 'broadcast')],
                         ids=['two-blocks-per-env', 'ragged', 'broadcast-z'])
def test_value_estimate_plain_n_envs_matches_vmapped_pallas(agents, S, block_s,
                                                            zrows):
    """N envs in one call, each with its own Q heads and discounts, against
    JAX `value_prepared` under vmap (one flat pallas_call over N*S rows,
    blocks_per_env = S / block_s; S=20 is not a multiple of 8)."""
    jagent, jp, tagent = agents
    cfg = jagent.cfg
    H, A, L = cfg.horizon, cfg.action_dim, cfg.latent_dim
    rng = np.random.default_rng(S)
    z0 = np.asarray(jl.simnorm(rng.normal(size=(N, S, L)).astype(np.float32), 8))
    if zrows == 'broadcast':
        z0 = np.broadcast_to(z0[:, :1], (N, S, L))
    actions = rng.uniform(-1, 1, (N, H, S, A)).astype(np.float32)
    eps = rng.normal(size=(N, S, A)).astype(np.float32)
    qidx = np.asarray([[0, 2], [1, 1], [2, 0]], np.int32)
    discs = np.stack([g ** np.arange(H + 1) for g in (0.95, 0.9, 0.99)]
                     ).astype(np.float32)
    ref = jax.vmap(lambda z, a, e, q, d: value_prepared(
        jprepare(jp, cfg, dot_dtype=jnp.float32), z, a, e, q, d, horizon=H,
        episodic=False, dot_dtype=jnp.float32, interpret=True, block_s=block_s,
        **_heads(jagent)))(z0, actions, eps, qidx, discs)
    prep = prepare_value_params(tagent.params, tagent.cfg, torch.float32)
    args = (_t(z0), _t(actions), _t(eps), _t(qidx), _t(discs))
    if zrows == 'broadcast':          # as the planner passes it: stride 0
        args = (args[0][:, :1].expand(N, S, L),) + args[1:]
    got = value_estimate(prep, *args, **_heads(tagent))
    assert got.shape == (N, S, 1)
    _close(got, ref, VTOL)
    for i in range(N):                # the N-env call is N one-env calls
        one = value_estimate_plain(prep, *(x[i:i + 1] for x in args),
                                   **_heads(tagent))
        torch.testing.assert_close(got[i:i + 1], one, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- CEM


@pytest.mark.parametrize('n_pi', [8, 0])
def test_cem_plan_plain_n_envs_matches_vmapped_pallas_cem(agents, n_pi):
    jagent, jp, tagent = agents
    cfg = jagent.cfg
    H, S, A, L = cfg.horizon, cfg.num_samples, cfg.action_dim, cfg.latent_dim
    I, HA = jagent.iterations, H * A
    rng = np.random.default_rng(10 + n_pi)
    f = np.float32
    z0 = np.asarray(jagent.model.encode(jp, rng.normal(size=(N, 10)).astype(f)))[:, None]
    pi_eps = rng.normal(size=(N, max(n_pi, 1), HA)).astype(f)
    noise = rng.normal(size=(N, I, S, HA)).astype(f)
    noise[:, :, :n_pi] = 0.0
    eps = rng.normal(size=(N, I, S, A)).astype(f)
    qidx = np.stack([[rng.permutation(cfg.num_q)[:2] for _ in range(I)]
                     for _ in range(N)]).astype(np.int32)
    discs = np.stack([g ** np.arange(H + 1) for g in (0.95, 0.9, 0.99)]).astype(f)
    mean0 = (0.1 * rng.normal(size=(N, 1, HA))).astype(f)
    std0 = np.full((N, 1, HA), cfg.max_std, f)
    kw = dict(iterations=I, n_pi=n_pi, num_elites=cfg.num_elites,
              temperature=cfg.temperature, min_std=cfg.min_std,
              max_std=cfg.max_std)
    jprep = jprepare(jp, cfg, dot_dtype=jnp.float32)
    ref = jax.vmap(lambda *x: cem_prepared(
        jprep, *x, jnp.ones((1, A), jnp.float32), horizon=H, episodic=False,
        dot_dtype=jnp.float32, interpret=True, **kw, **_heads(jagent)))(
        z0, pi_eps, noise, eps, qidx, discs, mean0, std0)
    prep = prepare_value_params(tagent.params, tagent.cfg, torch.float32)
    args = (prep, _t(z0), _t(pi_eps), _t(noise), _t(eps), _t(qidx), _t(discs),
            _t(mean0)[:, 0], _t(std0)[:, 0], torch.ones(A))
    got = cem.cem_plan_plain(*args, simnorm_dim=8, **kw, **_heads(tagent))
    for g, r, shape in zip(got, ref, [(N, HA), (N, HA), (N, S, 1), (N, S, HA)]):
        assert g.shape == shape and torch.isfinite(g).all()
        _close(g, r, VTOL)
    wrapped = cem.cem_plan(*args, simnorm_dim=8, **kw, **_heads(tagent))
    for g, w in zip(got, wrapped):
        torch.testing.assert_close(w, g, **EXACT)


# ----------------------------------------------------------------- plan


def _stack(noises) -> PlanNoise:
    return PlanNoise(**{k: None if v is None else torch.cat([getattr(x, k) for x in noises])
                        for k, v in vars(noises[0]).items()})


@pytest.mark.parametrize('eval_mode,num_envs', [(True, N), (False, N + 1)],
                         ids=['eval-n-of-n', 'explore-n-of-n+1'])
def test_plan_vec_matches_jax_plan_vec(eval_mode, num_envs):
    """The JAX planner runs its whole-CEM Pallas kernel interpreted with f32
    dots, vmapped over the env axis (tests/test_pallas_cem.py:84); env i
    of the port gets the draws JAX made from keys[i]. With more warm starts
    than envs, only the first n are written (tdmpc2.py:389-393)."""
    jagent = JTDMPC2(_small(jparse(JConfig(task='toy'))))
    jagent._fused_cem = True
    jagent._cem_interpret = True
    jagent._pallas_dot_dtype = jnp.float32
    jp = _perturb(jagent.state.params)
    tagent = TDMPC2(_small(parse_cfg(Config(task='toy', device='cpu',
                                            num_envs=num_envs))))
    tagent.load_params(params_from_jax(jax.tree.map(np.asarray, jp)))
    cfg = jagent.cfg
    ko, kp, key = jax.random.split(jax.random.PRNGKey(11), 3)
    obs = jax.random.normal(ko, (N, 10))
    prev_mean = 0.1 * jax.random.normal(
        kp, (num_envs, cfg.horizon, cfg.action_dim))
    t0 = np.array([True, False, False])
    # JAX returns the whole warm-start state, rows past n untouched
    acts, new_prev_mean, _ = jagent._plan_vec(
        jp, obs, prev_mean, jnp.asarray(t0), key, None, eval_mode=eval_mode)
    keys = jax.random.split(key, N + 1)
    noise = _stack([_jax_plan_noise(keys[i], cfg, jagent.iterations)
                    for i in range(N)])
    tagent.prev_mean = _t(prev_mean)
    a, m = tagent.plan_vec(_t(obs), t0, eval_mode=eval_mode, noise=noise)
    assert a.shape == (N, cfg.action_dim) and m.shape == (N, cfg.horizon,
                                                           cfg.action_dim)
    _close(m, new_prev_mean[:N], VTOL)
    _close(a, acts, ATOL)
    _close(tagent.prev_mean, new_prev_mean, VTOL)
    _close(tagent.prev_mean[N:], prev_mean[N:], EXACT)


def test_act_batched_and_single(agents):
    """`act` takes one observation or a stack (the rank test), plans every
    env with its own draws, and keeps one warm start per env."""
    _, _, tagent = agents
    obs = np.random.default_rng(3).normal(size=(N, 10)).astype(np.float32)
    tagent.generator.manual_seed(0)
    a = tagent.act(obs, t0=True)
    assert a.shape == (N, 4) and np.all(np.abs(a) <= 1.0)
    assert not np.allclose(a[0], a[1])
    assert tagent.prev_mean.shape == (N, 3, 4)
    tagent.generator.manual_seed(0)
    np.testing.assert_array_equal(tagent.act(obs, t0=[True] * N), a)
    a1 = tagent.act(obs[0], t0=False, eval_mode=True)
    assert a1.shape == (4,)


# ----------------------------------------------------------------- update


def _batches(rng, n, T, obs=10, act=4, B=8):
    f = np.float32
    return (rng.normal(size=(n, T + 1, B, obs)).astype(f),
            rng.uniform(-1, 1, (n, T, B, act)).astype(f),
            rng.uniform(0, 1, (n, T, B, 1)).astype(f),
            np.zeros((n, T, B, 1), f))


def test_update_scan_matches_jax_update_scan_and_sequential_updates():
    jcfg, tcfg = _cfgs(dropout=0.01, num_envs=2)
    jag, tag = JTDMPC2(jcfg), TDMPC2(tcfg)
    jstate = jag.state.replace(prev_mean=0.1 * jax.random.normal(
        jax.random.PRNGKey(2), jag.state.prev_mean.shape))
    n = 3
    batch = _batches(np.random.default_rng(12), n, jcfg.horizon)
    noises, key = [], jstate.key
    for _ in range(n):                # the key each scan step starts from
        noises.append(_noise_from_jax(key, jcfg))
        key = jax.random.split(key, 9)[8]
    tstate, seq = state_from_jax(jstate), state_from_jax(jstate)
    assert tstate.prev_mean.shape == (2, jcfg.horizon, 4)   # one per env
    _close(tstate.prev_mean, jstate.prev_mean, EXACT)
    jstate, jinfo = jax.jit(jag._update_scan)(jstate, *batch)
    tb = [torch.from_numpy(x) for x in batch]
    tag.state = tstate
    for i in range(n):                # update_many's steps, on these draws
        tinfo = tag._step(tuple(x[i] for x in tb), noises[i])
    for i in range(n):
        sinfo = tag._update(seq, *(x[i] for x in tb), noises[i])
    assert set(tinfo) == set(jinfo)
    for k in tinfo:
        np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]), **VTOL,
                                   err_msg=k)
        assert float(tinfo[k]) == float(sinfo[k]), k
    _hold_states(tstate, state_from_jax(jstate), VTOL)
    _hold_states(tstate, seq, EXACT)
    assert int(tstate.opt_state['enc']['count']) == n


@pytest.mark.parametrize('n', [1, 3])
def test_update_many_is_sample_many_then_updates(n):
    """update_many(n) = one sample_many(n) and n updates with the agent's
    next n update draws (n=1: one `update`, the unbatched layout)."""
    _, tcfg = _cfgs(buffer_size=200)
    a, b = TDMPC2(tcfg), TDMPC2(tcfg)
    bufs = Buffer(tcfg), Buffer(tcfg)
    for buf in bufs:
        rng = np.random.default_rng(13)
        for _ in range(4):
            buf.add(_episode(rng, 21))
    info = a.update_many(bufs[0], n)
    batch = bufs[1].sample_many(n)
    if n == 1:
        batch = tuple(x[None] for x in batch)
    for i in range(n):
        ref = b._update(b.state, *(x[i] for x in batch), b.draw_update_noise())
    for k in info:
        assert float(info[k]) == float(ref[k]), k
    _hold_states(a.state, b.state, EXACT)
    assert a._prep is None


# ----------------------------------------------------------------- buffer


@pytest.mark.parametrize('n', [1, 3])
def test_sample_many_layout_matches_jax_buffer(n):
    jcfg, tcfg = _cfgs(buffer_size=100, steps=100)
    jcfg.buffer_device = 'device'
    rng = np.random.default_rng(14)
    jbuf, tbuf = JBuffer(jcfg), Buffer(tcfg)
    for rows in (21, 21, 21, 21, 21, 21, 2):
        ep = _episode(rng, rows)
        assert jbuf.add(ep) == tbuf.add(ep)
    jbatch = jbuf.sample_many(n)
    key = jax.random.fold_in(jbuf._key, 1)
    B, T = jcfg.batch_size, jcfg.horizon
    ep, start = jdraw(key, jbuf._ep_rows, 5, n * B, T, 5)
    got = tbuf.gather(_t(ep), _t(start), n)
    lead = (n,) if n > 1 else ()
    shapes = [(T + 1, B, 10), (T, B, 4), (T, B, 1), (T, B, 1)]
    for g, r, shp in zip(got, jbatch[:4], shapes):
        assert tuple(g.shape) == lead + shp
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert tuple(tbuf.sample_many(n)[0].shape) == lead + shapes[0]


# ----------------------------------------------------------------- envs


def test_vec_env_matches_jax_vec_env():
    cfg = parse_cfg(Config(task='toy-reach', num_envs=N, seed=5, device='cpu'))
    jcfg = jparse(JConfig(task='toy-reach', num_envs=N, seed=5))
    env, jenv = make_env(cfg), jmake_env(jcfg)
    assert env.num_envs == jenv.num_envs == N
    assert cfg.obs_shape == jcfg.obs_shape and cfg.seed_steps == jcfg.seed_steps
    np.testing.assert_array_equal(env.reset(), jenv.reset())
    rng = np.random.default_rng(0)
    for t in range(120):
        a = env.rand_act() if t % 2 else rng.uniform(-1, 1, (N, 2)).astype(np.float32)
        if t % 2:
            np.testing.assert_array_equal(a, jenv.rand_act())
        out, jout = env.step(a), jenv.step(a)
        for x, y in zip(out[:3], jout[:3]):
            np.testing.assert_array_equal(x, y)
        assert out[3] == jout[3]
        for i in np.flatnonzero(out[2]):
            np.testing.assert_array_equal(env.reset_at(i), jenv.reset_at(i))
    assert not np.allclose(env.reset()[0], env.reset()[1])


@pytest.mark.parametrize('num_envs', [2, 1])
def test_vec_mode_subproc_is_refused(num_envs):
    """vec_mode=subproc is taken (the worker-process copies came with the
    dm_control rgb tasks, ROADMAP A11): with num_envs > 1 the copies step in
    worker processes, equal to the in-process copies, and one env is one
    env in this process, as in the JAX factory. rgb observations on a toy
    task stay refused: it has no rgb mode (a pixel env is given to the
    trainer)."""
    from tdmpc2_tpu_torch.envs.subproc import SubprocVecEnv
    cfg = load_cfg(overrides=['task=toy-reach', f'num_envs={num_envs}',
                              'vec_mode=subproc', 'device=cpu'])
    icfg = load_cfg(overrides=['task=toy-reach', f'num_envs={num_envs}',
                               'vec_mode=inproc', 'device=cpu'])
    env, ienv = make_env(cfg), make_env(icfg)
    try:
        assert isinstance(env, SubprocVecEnv) == (num_envs > 1)
        assert (cfg.obs_shape, cfg.action_dim) == (icfg.obs_shape, icfg.action_dim)
        np.testing.assert_array_equal(env.reset(), ienv.reset())
        shape = (num_envs, 2) if num_envs > 1 else (2,)
        a = np.random.default_rng(0).uniform(-1, 1, shape).astype(np.float32)
        out, iout = env.step(a), ienv.step(a)
        for x, y in zip(out[:3], iout[:3]):
            np.testing.assert_array_equal(x, y)
        assert out[3] == iout[3]
    finally:
        if num_envs > 1:
            env.close()
            assert all(p.poll() is not None for p in env.procs)
    cfg = parse_cfg(Config(task='toy-reach', num_envs=num_envs, obs='rgb',
                           device='cpu', vec_mode='subproc'))
    with pytest.raises(ValueError, match='no rgb mode'):
        make_env(cfg)


# ----------------------------------------------------------------- trainer


class _StubAgent:
    """Records the trainer's calls, each under its own name; actions are a
    fixed function of obs."""

    def __init__(self, log):
        self.log = log
        self.state = SimpleNamespace(params={})
        self.model = SimpleNamespace(total_params=lambda p: 0)

    @staticmethod
    def _a(obs):
        return np.tanh(np.asarray(obs, np.float32)[..., :2])

    def act(self, obs, t0=False, eval_mode=False):
        self.log.append(('act', bool(eval_mode), tuple(np.atleast_1d(t0))))
        return self._a(obs)

    def act_collect(self, obs, t0):
        self.log.append(('act_collect', tuple(np.atleast_1d(t0))))
        return self._a(obs)

    def update(self, buffer):
        self.log.append(('update', 1))
        return {'total_loss': 0.0}

    def update_many(self, buffer, n):
        self.log.append(('update_many', n))
        return {'total_loss': 0.0}

    def update_many_fused(self, buffer, n):
        self.log.append(('update_many_fused', n))
        return {'total_loss': 0.0}

    def vec_step(self, buffer, obs, t0, n):
        self.log.append(('vec_step', tuple(np.atleast_1d(t0)), n))
        return self._a(obs), {'total_loss': 0.0}

    def save(self, fp, extra=None):
        self.log.append(('save',))


class _StubBuffer:
    def __init__(self, log):
        self.log, self.num_eps = log, 0

    def add(self, ep):
        self.log.append(('add', int(ep['valid_rows']), float(ep['obs'].sum()),
                         float(np.nansum(ep['reward']))))
        self.num_eps += 1
        return self.num_eps

    def close(self):
        pass


def _vec_cfg(pkg_cfg, pkg_parse, tmp_path, **kw):
    cfg = pkg_parse(pkg_cfg(task='toy-reach', num_envs=N, steps=330,
                            eval_freq=165, eval_episodes=2, save_csv=False,
                            save_agent=False, **kw))
    cfg.work_dir = str(tmp_path)
    return cfg


# (update_ratio, fused_step, overlap_update) -> the JAX trainer's call that
# takes a planned vector step's updates after the burst
SCHEDULES = {'ratio1-pipelined': (1.0, True, True, 'update_many_fused'),
             'ratio0.5-pipelined': (0.5, True, True, 'update_many_fused'),
             'ratio1-one-call': (1.0, True, False, 'vec_step'),
             'ratio1-unfused': (1.0, False, True, 'update_many')}


def _as_vec_steps(log):
    """The JAX trainer's calls with each planned vector step after the seed
    burst (its last call a single `update`) written as the port's one
    `vec_step` call: `act_collect` [+ `update_many_fused`], `act` [+
    `update_many`] or `vec_step`, with the updates it queued (0 for none)."""
    i = max(j for j, e in enumerate(log) if e[0] == 'update') + 1
    out, rest, i = log[:i], log[i:], 0
    while i < len(rest):
        e = rest[i]
        if e[0] == 'act_collect' or e[:2] == ('act', False):
            t0 = e[-1]
            nxt = rest[i + 1] if i + 1 < len(rest) else ()
            k = nxt[1] if nxt[:1] in (('update_many_fused',), ('update_many',)) else 0
            out.append(('vec_step', t0, k))
            i += 2 if k else 1
        else:
            out.append(e)
            i += 1
    return out


@pytest.mark.parametrize('schedule', list(SCHEDULES), ids=list(SCHEDULES))
def test_vec_trainer_schedule_matches_jax_trainer(tmp_path, schedule):
    """The same env copies and the same (stub) agent under both trainers,
    given the same fused_step and overlap_update, give the same calls in
    the same order (`act`, the seed burst, the update calls with their
    counts) and the same episode flushes: each planned vector step of the
    JAX trainer's pipelined, one-call and unfused schedules alike is the
    port's one `vec_step` call with the same updates."""
    ratio, fused, overlap, later = SCHEDULES[schedule]
    logs = {}
    for name, (C, P, mk, Trainer, Log) in {
            'jax': (JConfig, jparse, jmake_env, JVecTrainer, JLogger),
            'port': (Config, parse_cfg, make_env, VecOnlineTrainer, Logger)}.items():
        kw = {'fused_step': fused, 'overlap_update': overlap}
        if name == 'port':
            kw['device'] = 'cpu'
        cfg = _vec_cfg(C, P, tmp_path / name, update_ratio=ratio, **kw)
        env = mk(cfg)
        cfg.seed_steps = 61            # a burst of 20 x update_many(3) + 1
        log = []
        Trainer(cfg=cfg, env=env, agent=_StubAgent(log), buffer=_StubBuffer(log),
                logger=Log(cfg)).train()
        logs[name] = log
    assert later in {e[0] for e in logs['jax'][-50:]}    # JAX took its schedule
    assert logs['port'] == _as_vec_steps(logs['jax'])
    calls = {e[0] for e in logs['port']}
    assert {'act', 'update_many', 'update', 'add', 'vec_step'} <= calls
    assert not calls & {'act_collect', 'update_many_fused'}
    burst = [e[1] for e in logs['port'] if e[0] == 'update_many']
    # the burst, then the updates each planned vector step owes
    assert burst == [N] * 20
    owed = [e[-1] for e in logs['port'] if e[0] == 'vec_step']
    assert owed and set(owed) == ({N} if ratio == 1.0 else {1, 2})


def _tiny_vec_cfg(tmp_path, **kw):
    kw = dict(dict(task='toy-reach', device='cpu', num_envs=N, batch_size=8,
                   latent_dim=16, mlp_dim=32, enc_dim=32, num_q=2, num_bins=5,
                   num_samples=16, num_elites=4, num_pi_trajs=2, iterations=1,
                   save_agent=False, save_csv=False), **kw)
    cfg = parse_cfg(Config(**kw))
    cfg.work_dir = str(tmp_path)
    return cfg


def _run(cfg, seed_steps):
    env = make_env(cfg)
    cfg.seed_steps = seed_steps
    agent = TDMPC2(cfg)
    trainer = VecOnlineTrainer(cfg=cfg, env=env, agent=agent,
                               buffer=Buffer(cfg), logger=Logger(cfg))
    trainer.train()
    return trainer


def test_vec_trainer_end_to_end(tmp_path, monkeypatch):
    infos = []
    upd = TDMPC2._update
    monkeypatch.setattr(TDMPC2, '_update', lambda self, *a: infos.append(
        upd(self, *a)) or infos[-1])
    trainer = _run(_tiny_vec_cfg(tmp_path, steps=330, eval_freq=1000,
                                 eval_episodes=1), 160)
    assert trainer._step == 333
    assert trainer.buffer.num_eps >= 6
    # nothing until step 162 (> seed_steps, episodes flushed at 150), the
    # 160-update burst there, then 3 per vector step
    assert len(infos) == 160 + 3 * len(range(165, 331, 3))
    for info in infos[::25] + infos[-1:]:
        assert all(math.isfinite(float(v)) for v in info.values())
    batch = trainer.buffer.sample()
    assert batch[0].shape[:2] == (4, 8) and torch.isfinite(batch[0]).all()
    assert trainer.agent.prev_mean.shape == (N, 3, 2)


def test_vec_trainer_final_boundary_eval_and_checkpoint(tmp_path):
    """_step advances num_envs per vector step and jumps past cfg.steps
    (198 -> 201): the eval owed at the horizon still runs, and every eval
    writes the checkpoint."""
    cfg = _tiny_vec_cfg(tmp_path, steps=200, eval_freq=100, eval_episodes=1,
                        save_csv=True, save_agent=True)
    trainer = _run(cfg, 160)
    rows = (tmp_path / 'eval.csv').read_text().splitlines()[1:]
    steps = [int(r.split(',')[0]) for r in rows]
    assert steps == [0, 102, 201], steps
    assert (tmp_path / 'models' / 'latest.pkl').exists()
    warm = trainer.agent.prev_mean.clone()      # checkpoints hold no warm starts
    assert trainer.agent.load(tmp_path / 'models' / 'latest.pkl')['step'] == 201
    torch.testing.assert_close(trainer.agent.prev_mean, warm, **EXACT)
