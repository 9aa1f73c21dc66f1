"""PyTorch port vs the JAX package: the training path (CPU, small widths,
f32).

- the update's math (two_hot, soft_ce, gaussian_logprob, squash,
  percentile_range, termination_statistics, the running scale), the
  policy's entropy terms and the Q head's target/dropout options;
- the optimisers against optax (global-norm clipping on both sides of the
  threshold, Adam, the Polyak update);
- one `_update` from `interop.state_from_jax` of a JAX TrainState on one
  batch, with the draws the JAX step makes from its key fed to the port
  as an `UpdateNoise`: losses, both gradient norms, the scale, the new
  parameters, the target heads and every Adam moment at 1e-4; then four
  more steps, held at the same tolerance;
- the replay buffer: `draw_slice_indices` by distribution, and the batch
  layout against the JAX Buffer's on the same episodes and slices;
- checkpoints: save/load round trip, and the JAX agent reading the port's;
- the online trainer's update schedule against the JAX trainer's, and
  CPU runs of `train` on toy-reach at a tiny width, with one env and four."""

import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tdmpc2_tpu.config import Config as JConfig, parse_cfg as jparse
from tdmpc2_tpu.data.buffer import Buffer as JBuffer
from tdmpc2_tpu.data.buffer import draw_slice_indices as jdraw
from tdmpc2_tpu.models.world_model import WorldModel as JWorldModel
from tdmpc2_tpu.ops import math as jm
from tdmpc2_tpu.ops.scale import update_scale as jupdate_scale
from tdmpc2_tpu.tdmpc2 import TDMPC2 as JTDMPC2
from tdmpc2_tpu.trainer.online import OnlineTrainer as JOnlineTrainer
from tdmpc2_tpu_torch import train as train_mod
from tdmpc2_tpu_torch.config import Config, parse_cfg
from tdmpc2_tpu_torch.data.buffer import Buffer, draw_slice_indices
from tdmpc2_tpu_torch.envs import make_env
from tdmpc2_tpu_torch.interop import params_from_jax, state_from_jax
from tdmpc2_tpu_torch.models.world_model import WorldModel
from tdmpc2_tpu_torch.ops import math as tm
from tdmpc2_tpu_torch.ops import optim
from tdmpc2_tpu_torch.ops.scale import update_scale
from tdmpc2_tpu_torch.tdmpc2 import TDMPC2, UpdateNoise
from tdmpc2_tpu_torch.trainer.online import OnlineTrainer
from tdmpc2_tpu_torch.utils import tree
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
UPD = dict(rtol=1e-4, atol=1e-4)
OBS, ACT, B = 10, 4, 8


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **tol)


def _dims(cfg, **kw):
    cfg.obs_shape = {'state': (OBS,)}
    cfg.action_dim, cfg.episode_length = ACT, 20
    cfg.enc_dim, cfg.mlp_dim, cfg.latent_dim, cfg.num_q = 32, 32, 16, 2
    cfg.batch_size = B
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _cfgs(**kw):
    return (_dims(jparse(JConfig(task='toy')), **kw),
            _dims(parse_cfg(Config(task='toy', device='cpu')), **kw))


# ----------------------------------------------------------------- math


@pytest.mark.parametrize('num_bins', [1, 5, 101])
def test_two_hot_and_soft_ce(num_bins):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 30, (7, 3, 1)).astype(np.float32)
    x[0, 0, 0], x[1, 0, 0] = 1e6, -1e6          # clamped to vmax / vmin
    x[2, 0, 0] = np.expm1(10.0)                 # symlog(x) == vmax: wraps
    _close(tm.two_hot(_t(x), num_bins, -10.0, 10.0),
           jm.two_hot(x, num_bins, -10.0, 10.0))
    logits = rng.normal(0, 2, (7, 3, num_bins)).astype(np.float32)
    _close(tm.soft_ce(_t(logits), _t(x), num_bins, -10.0, 10.0),
           jm.soft_ce(logits, x, num_bins, -10.0, 10.0))


def test_gaussian_logprob_squash_termination_statistics():
    rng = np.random.default_rng(1)
    eps = rng.normal(size=(5, 6, 3)).astype(np.float32)
    ls = rng.uniform(-10, 2, (5, 6, 3)).astype(np.float32)
    # unsaturated tanh: near |pi| = 1, 1 - pi^2 cancels to the last bits
    mu = rng.normal(0, 0.5, (5, 6, 3)).astype(np.float32)
    _close(tm.gaussian_logprob(_t(eps), _t(ls)), jm.gaussian_logprob(eps, ls))
    lp = rng.normal(size=(5, 6, 1)).astype(np.float32)
    for got, ref in zip(tm.squash(_t(mu), _t(mu + 0.5 * eps), _t(lp)),
                        jm.squash(mu, mu + 0.5 * eps, lp)):
        _close(got, ref)
    pred = rng.uniform(size=(40, 1)).astype(np.float32)
    target = (rng.uniform(size=(40, 1)) < 0.3).astype(np.float32)
    ref = jm.termination_statistics(pred, target)
    got = tm.termination_statistics(_t(pred), _t(target))
    for k in ('termination_rate', 'termination_f1'):
        _close(got[k], ref[k])


@pytest.mark.parametrize('shape', [(1, 4), (7, 3, 1), (256, 1), (100, 2, 5)])
def test_percentile_range_and_running_scale(shape):
    x = np.random.default_rng(2).normal(0, 3, shape).astype(np.float32)
    for got, ref in zip(tm.percentile_range(_t(x)), jm.percentile_range(x)):
        _close(got, ref)
    for scale in (1.0, 4.5):
        _close(update_scale(torch.tensor(scale), _t(x), 0.01),
               jupdate_scale(jnp.float32(scale), x, 0.01))


# ------------------------------------------------------------- world model


@pytest.fixture(scope='module')
def models():
    jcfg, tcfg = _cfgs(dropout=0.25)
    jmodel = JWorldModel(jcfg)
    key = jax.random.PRNGKey(0)
    jp = jmodel.init(key)
    leaves, treedef = jax.tree.flatten(jp)
    keys = jax.random.split(key, len(leaves))
    jp = jax.tree.unflatten(treedef, [x + 0.1 * jax.random.normal(k, x.shape)
                                      for x, k in zip(leaves, keys)])
    return jcfg, jmodel, jp, WorldModel(tcfg), params_from_jax(_np(jp))


def test_pi_entropy_terms(models):
    _, jmodel, jp, tmodel, tp = models
    z = np.random.default_rng(3).normal(size=(2, 5, 16)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    a_ref, ref = jmodel.pi(jp, z, key)
    a, got = tmodel.pi(tp, _t(z), _t(jax.random.normal(key, (2, 5, ACT))))
    _close(a, a_ref)
    for k in ('mean', 'log_std', 'entropy', 'scaled_entropy'):
        _close(got[k], ref[k])


@pytest.mark.parametrize('variant', ['target', 'dropout_all', 'dropout_avg'])
def test_Q_targets_and_dropout_masks(models, variant):
    jcfg, jmodel, jp, tmodel, tp = models
    rng = np.random.default_rng(4)
    z = rng.normal(size=(3, 5, 16)).astype(np.float32)
    a = rng.uniform(-1, 1, (3, 5, ACT)).astype(np.float32)
    key, kd = jax.random.split(jax.random.PRNGKey(4))
    qidx = torch.from_numpy(np.array(jax.random.permutation(key, 2)[:2])).long()
    if variant == 'target':
        tq = jax.tree.map(lambda x: 0.5 * x, jp['Qs'])
        ref = jmodel.Q(jp, z, a, key=key, return_type='min', target_params=tq)
        got = tmodel.Q(tp, _t(z), _t(a), qidx=qidx, return_type='min',
                       target_params=params_from_jax(_np(tq)))
    else:
        rt = variant.split('_')[1]
        ref = jmodel.Q(jp, z, a, key=key, return_type=rt, dropout_key=kd,
                       detach=True)
        keep = np.stack([np.asarray(jax.random.bernoulli(k, 0.75, (3, 5, 32)))
                         for k in jax.random.split(kd, 2)])
        got = tmodel.Q(tp, _t(z), _t(a), qidx=qidx, return_type=rt,
                       detach=True, keep_mask=torch.from_numpy(keep))
    _close(got, ref)


# ----------------------------------------------------------------- optim


@pytest.mark.parametrize('max_norm', [0.5, 100.0])
def test_clip_and_adam_match_optax(max_norm):
    rng = np.random.default_rng(5)
    params = {'a': rng.normal(size=(4, 3)).astype(np.float32),
              'b': (rng.normal(size=(5,)).astype(np.float32),)}
    tx = optax.chain(optax.clip_by_global_norm(max_norm),
                     optax.adam(3e-3, eps=1e-5))
    jstate = tx.init(params)
    tp = params_from_jax(params)
    tstate = optim.adam_init(tp)
    jparams = params
    for step in range(3):
        g = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32),
                         params)
        upd, jstate = tx.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tg = tree.leaves(params_from_jax(g))
        norm = optim.clip_by_global_norm_(tg, max_norm)
        _close(norm, optax.global_norm(g))
        optim.adam_(tree.leaves(tp), tg, tstate, 3e-3, eps=1e-5)
        for got, ref in zip(tree.leaves(tp), jax.tree.leaves(jparams)):
            _close(got, ref)
        assert int(tstate['count']) == int(jstate[1][0].count) == step + 1
        for got, ref in zip(tree.leaves(tstate['nu']),
                            jax.tree.leaves(jstate[1][0].nu)):
            _close(got, ref)
    target = tree.map(torch.zeros_like, tp)
    optim.polyak_(target, tp, 0.01)
    ref = optax.incremental_update(jparams, jax.tree.map(jnp.zeros_like,
                                                         jparams), 0.01)
    for got, r in zip(tree.leaves(target), jax.tree.leaves(ref)):
        _close(got, r)


# ----------------------------------------------------------------- update


def _noise_from_jax(key, cfg):
    """The draws JAX `_update` makes from `key` (tdmpc2.py:933-949 and
    the heads it calls), as the port's UpdateNoise; on a pixel config also
    the encoder's ShiftAug shifts, from k_enc_next (one key a time step,
    world_model.py:139-143) and k_enc0 (layers.py:229)."""
    T, N, M = cfg.horizon, cfg.num_q, cfg.mlp_dim
    B, ACT = cfg.batch_size, cfg.action_dim
    (_, k_enc_next, k_td, k_enc0, k_drop, k_pi_upd, k_pi_q, k_pi_drop,
     _) = jax.random.split(key, 9)
    k_pi, k_q = jax.random.split(k_td)

    def keep(k, rows):
        if cfg.dropout <= 0.0:
            return None
        return torch.from_numpy(np.stack([
            np.asarray(jax.random.bernoulli(km, 1.0 - cfg.dropout, (rows, B, M)))
            for km in jax.random.split(k, N)]))

    def qpair(k):
        return torch.from_numpy(np.array(jax.random.permutation(k, N)[:2])).long()
    def shifts(k):
        return torch.from_numpy(np.array(jax.random.randint(k, (B, 2), 0, 7))).long()
    rgb = cfg.obs == 'rgb'
    return UpdateNoise(
        td_eps=_t(jax.random.normal(k_pi, (T, B, ACT))), td_qidx=qpair(k_q),
        q_keep=keep(k_drop, T),
        pi_eps=_t(jax.random.normal(k_pi_upd, (T + 1, B, ACT))),
        pi_qidx=qpair(k_pi_q), pi_keep=keep(k_pi_drop, T + 1),
        next_shift=(torch.stack([shifts(k) for k in jax.random.split(k_enc_next, T)])
                    if rgb else None),
        shift0=shifts(k_enc0) if rgb else None)


def _hold_states(got, ref, tol=UPD):
    for name in ('params', 'target_Qs', 'opt_state', 'pi_opt_state', 'scale'):
        g, r = tree.leaves(getattr(got, name)), tree.leaves(getattr(ref, name))
        assert len(g) == len(r), name
        for a, b in zip(g, r):
            assert a.shape == b.shape and a.dtype == b.dtype, name
            np.testing.assert_allclose(a.numpy(), b.numpy(), **tol, err_msg=name)


@pytest.mark.parametrize('case', ['dropout0', 'dropout', 'perturbed',
                                  'episodic'])
def test_update_matches_jax_update(case):
    """'episodic' adds the termination head and its loss, and sets a fifth
    of `terminated`, which the TD target's (1 - terminated) reads."""
    kw = dict(dropout=0.0) if case == 'dropout0' else dict(dropout=0.01)
    if case == 'dropout':
        kw['num_bins'] = 5
    if case == 'episodic':
        kw['episodic'] = True
    jcfg, tcfg = _cfgs(**kw)
    jag, tag = JTDMPC2(jcfg), TDMPC2(tcfg)
    jstate = jag.state
    if case == 'perturbed':
        # nonzero heads, and Q values spread past the scale's floor of 1;
        # the policy stays unsaturated, where tanh's last bits would
        # dominate the entropy's log(1 - tanh^2)
        leaves, treedef = jax.tree.flatten(jstate.params)
        keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
        params = jax.tree.unflatten(treedef, [
            x + 0.05 * jax.random.normal(k, x.shape)
            for x, k in zip(leaves, keys)])
        q_out = dict(params['Qs'][-1], w=params['Qs'][-1]['w'] * 40.0)
        params = dict(params, Qs=params['Qs'][:-1] + (q_out,))
        jstate = jstate.replace(params=params, target_Qs=jax.tree.map(
            lambda x: 0.9 * x, params['Qs']))
    rng = np.random.default_rng(6)
    T = jcfg.horizon
    terminated = np.zeros((T, B, 1))
    if case == 'episodic':
        terminated.flat[rng.permutation(terminated.size)[:terminated.size // 5]] = 1
    batch = (rng.normal(size=(T + 1, B, OBS)), rng.uniform(-1, 1, (T, B, ACT)),
             rng.uniform(0, 1, (T, B, 1)), terminated)
    batch = tuple(x.astype(np.float32) for x in batch)
    tstate = state_from_jax(jstate)
    _hold_states(tstate, state_from_jax(jstate), dict(rtol=0, atol=0))
    upd = jax.jit(jag._update)
    for step in range(5):
        noise = _noise_from_jax(jstate.key, jcfg)
        jstate, jinfo = upd(jstate, *batch)
        tinfo = tag._update(tstate, *(torch.from_numpy(x) for x in batch),
                            noise)
        assert set(tinfo) == set(jinfo)
        for k in tinfo:
            np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]),
                                       **UPD, err_msg=f'step {step}: {k}')
        _hold_states(tstate, state_from_jax(jstate))
    assert int(tstate.opt_state['enc']['count']) == 5
    if case == 'perturbed':
        assert float(tinfo['pi_scale']) != 1.0
    if case == 'episodic':
        assert float(tinfo['termination_loss']) > 0.0


def test_agent_update_from_buffer_and_checkpoint_round_trip(tmp_path):
    jcfg, tcfg = _cfgs(buffer_size=200)
    ag = TDMPC2(tcfg)
    buf = Buffer(tcfg)
    rng = np.random.default_rng(7)
    for _ in range(3):
        buf.add(_episode(rng, 21))
    info = ag.update(buf)
    assert all(math.isfinite(float(v)) for v in info.values())
    ag.act(np.zeros(OBS, np.float32), t0=True)   # re-prepares the weights
    fp = tmp_path / 'models' / 'latest.pkl'
    ag.save(fp, extra={'step': 3})
    ag2 = TDMPC2(tcfg)
    assert ag2.load(fp) == {'step': 3}
    _hold_states(ag2.state, ag.state, dict(rtol=0, atol=0))
    # the JAX agent reads the port's checkpoint (params, targets, arch)
    jag = JTDMPC2(jcfg)
    jag.load(str(fp))
    for a, b in zip(jax.tree.leaves(jag.state.params),
                    tree.leaves(ag.state.params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ----------------------------------------------------------------- buffer


def _episode(rng, rows, obs_dim=OBS, act_dim=ACT):
    ep = dict(obs=rng.normal(size=(rows, obs_dim)).astype(np.float32),
              action=rng.uniform(-1, 1, (rows, act_dim)).astype(np.float32),
              reward=rng.uniform(size=rows).astype(np.float32),
              terminated=np.zeros(rows, np.float32))
    for k in ('action', 'reward', 'terminated'):
        ep[k][0] = np.nan                        # the bootstrap row
    return ep


def test_draw_slice_indices_by_distribution():
    T, nb, cap = 3, 200_000, 6
    rows = torch.tensor([10, 5, 21, 4, 30, 0])   # slot 3: one valid start
    g = torch.Generator().manual_seed(0)
    ep, start = draw_slice_indices(g, rows, 5, nb, T, cap)
    w = torch.clamp(rows - T, min=0).float()
    w[5:] = 0
    p = (w / w.sum()).numpy()
    freq = np.bincount(ep.numpy(), minlength=cap) / nb
    assert np.all(np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / nb) + 1e-12)
    assert bool((start >= 0).all()) and bool((start + T < rows[ep]).all())
    for e in (0, 2, 4):                          # uniform starts within
        s = start[ep == e].numpy()
        counts = np.bincount(s, minlength=int(rows[e]) - T)
        exp = len(s) / (int(rows[e]) - T)
        assert np.all(np.abs(counts - exp) <= 5 * np.sqrt(exp))
    # the JAX draw, another generator, gives the same law
    jep, _ = jdraw(jax.random.PRNGKey(0), jnp.asarray(rows.numpy(), jnp.int32),
                   5, nb, T, cap)
    jfreq = np.bincount(np.asarray(jep), minlength=cap) / nb
    assert np.all(np.abs(jfreq - p) <= 5 * np.sqrt(p * (1 - p) / nb) + 1e-12)


def test_buffer_batch_layout_matches_jax_buffer():
    jcfg, tcfg = _cfgs(buffer_size=100, steps=100)
    jcfg.buffer_device = 'device'    # no 2 GiB trial allocation on the CPU
    rng = np.random.default_rng(8)
    jbuf, tbuf = JBuffer(jcfg), Buffer(tcfg)
    for rows in (21, 21, 21, 21, 21, 21, 2):     # ring wraps; 2 rows dropped
        ep = _episode(rng, rows)
        assert jbuf.add(ep) == tbuf.add(ep)
    assert tbuf.num_eps == 6 and tbuf.capacity == 100
    jbatch = jbuf.sample()
    key = jax.random.fold_in(jbuf._key, 1)       # the JAX buffer's 1st draw
    ep, start = jdraw(key, jbuf._ep_rows, min(jbuf.num_eps, 5), B,
                      jcfg.horizon, 5)
    got = tbuf.gather(torch.from_numpy(np.array(ep)),
                      torch.from_numpy(np.array(start)))
    T = jcfg.horizon
    shapes = [(T + 1, B, OBS), (T, B, ACT), (T, B, 1), (T, B, 1)]
    for g, r, shp in zip(got, jbatch[:4], shapes):
        assert tuple(g.shape) == shp
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert not any(bool(torch.isnan(x).any()) for x in tbuf.sample())


# ----------------------------------------------------------------- trainer


class _Holder:
    pass


@pytest.mark.parametrize('ratio', [0, 0.5, 1.0, 0.3, 2.0])
def test_update_schedule_matches_jax_trainer(ratio):
    """update_ratio=0 counts as 1 in both (the JAX trainer's `or 1.0`,
    kept on purpose: ROADMAP C)."""
    j, t = _Holder(), _Holder()
    j.cfg, t.cfg = jparse(JConfig(update_ratio=ratio)), parse_cfg(
        Config(update_ratio=ratio))
    t._upd_credit = 0.0
    got = [OnlineTrainer._updates_due(t, 1) for _ in range(20)]
    assert got == [JOnlineTrainer._updates_due(j, 1) for _ in range(20)]


TINY = ['task=toy-reach', 'device=cpu', 'steps=220', 'eval_freq=200',
        'eval_episodes=1', 'batch_size=16', 'enc_dim=32', 'mlp_dim=32',
        'latent_dim=16', 'num_q=2', 'num_samples=32', 'num_elites=4',
        'num_pi_trajs=4', 'iterations=1', 'save_agent=false']


def test_train_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)

    def small_seed_phase(cfg):
        env = make_env(cfg)
        cfg.seed_steps = 60                      # after make_env, as JAX tests do
        return env
    monkeypatch.setattr(train_mod, 'make_env', small_seed_phase)
    infos = []
    update = TDMPC2.update
    monkeypatch.setattr(TDMPC2, 'update',
                        lambda self, buf: infos.append(update(self, buf)) or infos[-1])
    trainer = train_mod.main(TINY)
    assert trainer._step == 221 and trainer.buffer.num_eps == 4
    assert len(infos) == 60 + 160                # the burst, then one per step
    for info in infos[::20] + infos[-1:]:
        assert all(math.isfinite(float(v)) for v in info.values())
    csv = (Path(trainer.cfg.work_dir) / 'eval.csv').read_text().splitlines()
    assert csv[0] == 'step,episode_reward,episode_success' and len(csv) == 3


def test_train_num_envs_on_cpu(tmp_path, monkeypatch):
    """num_envs=4 picks the vectorised trainer: one batched plan per vector
    step, the 60-update burst once the first four episodes are in, then four
    updates per vector step."""
    monkeypatch.chdir(tmp_path)

    def small_seed_phase(cfg):
        env = make_env(cfg)
        cfg.seed_steps = 60
        return env
    monkeypatch.setattr(train_mod, 'make_env', small_seed_phase)
    infos = []
    upd = TDMPC2._update
    monkeypatch.setattr(TDMPC2, '_update', lambda self, *a: infos.append(
        upd(self, *a)) or infos[-1])
    trainer = train_mod.main(TINY + ['num_envs=4'])
    assert type(trainer).__name__ == 'VecOnlineTrainer'
    assert trainer._step == 224 and trainer.buffer.num_eps == 4
    assert trainer.agent.prev_mean.shape == (4, 3, 2)
    # episodes flush at step 200, eval there, then the burst and 4 per step
    assert len(infos) == 60 + 4 * len(range(204, 221, 4))
    assert all(math.isfinite(float(v)) for v in infos[-1].values())
    csv = (Path(trainer.cfg.work_dir) / 'eval.csv').read_text().splitlines()
    assert len(csv) == 3                         # steps 0, 200 and 224 > 220


@pytest.mark.parametrize('extra,err', [
    ([], RuntimeError), (['num_envs=4', 'obs=rgb'], ValueError),
    (['seeds=1,2', 'mesh_shape=2x1'], ValueError),
    (['save_video=true'], NotImplementedError)])
def test_train_refuses_what_the_port_lacks(extra, err):
    argv = [o for o in TINY if not o.startswith('device=')] + extra
    if extra:
        argv.append('device=cpu')
    elif torch.cuda.is_available():
        pytest.skip('a card is present: the default device works here')
    with pytest.raises(err):
        train_mod.main(argv)


def test_training_path_imports_no_jax():
    code = ('import sys, tdmpc2_tpu_torch.train, tdmpc2_tpu_torch.ops.rollout, '
            'tdmpc2_tpu_torch.ops.probe; '
            'bad = sorted(m for m in sys.modules '
            "if m.split('.')[0] in ('jax', 'tdmpc2_tpu', 'optax')); "
            'assert not bad, bad')
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                   timeout=120)
