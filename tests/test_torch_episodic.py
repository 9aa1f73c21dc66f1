"""PyTorch port vs the JAX package on episodic tasks (CPU, small widths,
f32): the termination gate of the planner's value step and the
termination loss of the update.

- the value step (`value_estimate_plain(episodic=True)`) against JAX
  `value_prepared(episodic=True)`, the Pallas value kernel run interpreted
  with f32 dots, for one env and for N=3 under `jax.vmap`; and against the
  JAX agent's plain `_estimate_value` branch, with the port's
  `_estimate_value` held to the same;
- the CEM loop (`cem_plan_plain`) against JAX `cem_prepared(episodic=True)`
  and `plan_vec` against the JAX agent's `_plan_vec`, each env fed the
  draws JAX made;
- five `_update`s, and the steps of one `update_many` against JAX's
  `_update_scan`, from `interop.state_from_jax`, on batches with about 20% of `terminated` set:
  every info key (incl. `termination_loss`, `termination_rate`,
  `termination_f1`) and the whole train state;
- `sigmoid_binary_cross_entropy` against optax;
- both trainers against the JAX trainers on `toy-reach-episodic` (early
  `done`, per-slot flushes with `valid_rows`, `episode_terminated`, `t0`
  after a slot's reset), `train` end to end on the CPU at one env and at
  `num_envs=4`, and a save/load round trip of an episodic agent.

The termination head is perturbed so that its logit splits the rows (the
last layer scaled up, its bias moved to the median logit of one-step
latents), and each planner test asserts that the sticky flag is set on
some rows and not on others. Tolerances are the JAX suite's: 1e-4 for
values, plan means and the update, 1e-3 for actions."""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_planner import _jax_plan_noise, _perturb, _small
from test_torch_train import _dims, _hold_states, _noise_from_jax
from test_torch_vec import _StubAgent, _StubBuffer, _as_vec_steps, _stack
from tdmpc2_tpu.config import Config as JConfig, parse_cfg as jparse
from tdmpc2_tpu.envs import make_env as jmake_env
from tdmpc2_tpu.ops.pallas_cem import cem_prepared
from tdmpc2_tpu.ops.pallas_rollout import (prepare_value_params as jprepare,
                                           value_prepared)
from tdmpc2_tpu.tdmpc2 import TDMPC2 as JTDMPC2
from tdmpc2_tpu.trainer.online import OnlineTrainer as JOnlineTrainer
from tdmpc2_tpu.trainer.vec_online import VecOnlineTrainer as JVecTrainer
from tdmpc2_tpu.utils.logger import Logger as JLogger
from tdmpc2_tpu_torch import train as train_mod
from tdmpc2_tpu_torch.config import Config, parse_cfg
from tdmpc2_tpu_torch.envs import make_env
from tdmpc2_tpu_torch.envs import toy
from tdmpc2_tpu_torch.interop import params_from_jax, state_from_jax
from tdmpc2_tpu_torch.ops import cem
from tdmpc2_tpu_torch.ops import math as tm
from tdmpc2_tpu_torch.ops import value as tv
from tdmpc2_tpu_torch.tdmpc2 import TDMPC2
from tdmpc2_tpu_torch.trainer.online import OnlineTrainer
from tdmpc2_tpu_torch.trainer.vec_online import VecOnlineTrainer
from tdmpc2_tpu_torch.utils.logger import Logger

VTOL = dict(rtol=1e-4, atol=1e-4)
ATOL = dict(rtol=1e-3, atol=1e-3)
EXACT = dict(rtol=0, atol=0)
N = 3
OBS = 10


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **tol)


def _episodic(cfg):
    cfg.episodic = True
    return cfg


def _heads(agent):
    return dict(log_std_min=agent.model.log_std_min,
                log_std_dif=agent.model.log_std_dif)


def _split_termination(jagent, params, seed=0, scale=4.0):
    """`params` with the termination head's last layer scaled by `scale`
    and its bias moved so that half of the H-step rollouts of random
    observations and actions end flagged (the median over rollouts of the
    largest logit along the way becomes 0): the flag then splits the
    planner's rows."""
    cfg = jagent.cfg
    rng = np.random.default_rng(seed)
    z = jagent.model.encode(params, rng.normal(size=(256, OBS)).astype(np.float32))
    last = dict(params['termination'][-1])
    last['w'] = last['w'] * scale
    head = dict(params, termination=params['termination'][:-1] + (last,))
    top = -jnp.inf
    for _ in range(cfg.horizon):
        a = rng.uniform(-1, 1, (256, cfg.action_dim)).astype(np.float32)
        z = jagent.model.next(params, z, a)
        top = jnp.maximum(top, jagent.model.termination(head, z, unnormalized=True))
    last['b'] = last['b'] - jnp.median(top)
    return dict(params, termination=params['termination'][:-1] + (last,))


def _agents(num_envs=1):
    jagent = JTDMPC2(_episodic(_small(jparse(JConfig(task='toy')))))
    jp = _split_termination(jagent, _perturb(jagent.state.params))
    tagent = TDMPC2(_episodic(_small(parse_cfg(
        Config(task='toy', device='cpu', num_envs=num_envs)))))
    tagent.load_params(params_from_jax(jax.tree.map(np.asarray, jp)))
    return jagent, jp, tagent


@pytest.fixture(scope='module')
def agents():
    return _agents(N)


def _flag_share(prep, z0, actions, discs):
    """Share of rows whose sticky flag is set at t=H: z0 [N, S, L];
    actions [N, H, S, A]; discs [N, H+1]."""
    _, term_at = tv.termination_trace_plain(prep, z0, actions, discs)
    return float((term_at > 0).float().mean())


def _assert_split(share):
    assert 0.05 < share < 0.95, f'the gate flagged {share:.2%} of the rows'


def _latents(jagent, jp, rng, *lead):
    obs = rng.normal(size=lead + (OBS,)).astype(np.float32)
    return np.asarray(jagent.model.encode(jp, obs))


# ----------------------------------------------------------------- value


@pytest.mark.parametrize('n', [1, N], ids=['one-env', 'n-envs-vmap'])
def test_value_episodic_matches_pallas_value_kernel(agents, n):
    jagent, jp, tagent = agents
    cfg = jagent.cfg
    S, H, A = 32, cfg.horizon, cfg.action_dim
    rng = np.random.default_rng(20 + n)
    z0 = _latents(jagent, jp, rng, n, S)
    actions = rng.uniform(-1, 1, (n, H, S, A)).astype(np.float32)
    eps = rng.normal(size=(n, S, A)).astype(np.float32)
    qidx = np.asarray([[0, 2], [1, 1], [2, 0]][:n], np.int32)
    discs = np.stack([g ** np.arange(H + 1) for g in (0.95, 0.9, 0.99)][:n]
                     ).astype(np.float32)
    jprep = jprepare(jp, cfg, dot_dtype=jnp.float32)

    def ref_one(z, a, e, q, d):
        return value_prepared(jprep, z, a, e, q, d, horizon=H, episodic=True,
                              dot_dtype=jnp.float32, interpret=True,
                              block_s=16, **_heads(jagent))
    ref = (ref_one(z0[0], actions[0], eps[0], qidx[0], discs[0])[None] if n == 1
           else jax.vmap(ref_one)(z0, actions, eps, qidx, discs))
    prep = tv.prepare_value_params(tagent.params, tagent.cfg, torch.float32)
    assert set(tv.TERM_NAMES) <= set(prep)
    args = (_t(z0), _t(actions), _t(eps), _t(qidx), _t(discs))
    got = tv.value_estimate_plain(prep, *args, **_heads(tagent), episodic=True)
    assert got.shape == (n, S, 1)
    _close(got, ref, VTOL)
    _assert_split(_flag_share(prep, args[0], args[1], args[4]))
    # the gate changes the value (and the wrapper takes the plain version)
    plain = tv.value_estimate_plain(prep, *args, **_heads(tagent))
    assert not torch.allclose(got, plain)
    torch.testing.assert_close(tv.value_estimate(prep, *args, **_heads(tagent),
                                                 episodic=True), got, **EXACT)


def test_value_episodic_matches_jax_plain_value(agents):
    """The prepared-weight value step and the port's model-head value both
    against the JAX agent's plain branch (tdmpc2.py:498-521), which gates
    on sigmoid > 0.5 where the kernels test logit > 0."""
    jagent, jp, tagent = agents
    cfg = jagent.cfg
    S, H, A = 32, cfg.horizon, cfg.action_dim
    key = jax.random.PRNGKey(21)
    rng = np.random.default_rng(21)
    z = _latents(jagent, jp, rng, S)
    actions = rng.uniform(-1, 1, (H, S, A)).astype(np.float32)
    ref = jagent._estimate_value(jp, z, actions, key, None, fused=False)
    k_pi, k_q = jax.random.split(key)
    eps = _t(jax.random.normal(k_pi, (S, A), jnp.float32))
    qidx = _t(jax.random.permutation(k_q, cfg.num_q)[:2]).to(torch.int32)
    _close(tagent._estimate_value(_t(z), _t(actions), eps, qidx), ref, VTOL)
    prep = tv.prepare_value_params(tagent.params, tagent.cfg, torch.float32)
    args = [x[None] for x in (_t(z), _t(actions), eps, qidx, tagent.discs)]
    _close(tv.value_estimate(prep, *args, **_heads(tagent), episodic=True)[0],
           ref, VTOL)
    _assert_split(_flag_share(prep, args[0], args[1], args[4]))


def test_value_episodic_needs_the_termination_head(agents):
    """A prep without the termination head (a non-episodic agent's) is
    refused for episodic=True; the kernel would read null weights."""
    _, _, tagent = agents
    prep = {k: v for k, v in tagent.prep.items() if k not in tv.TERM_NAMES}
    z = torch.zeros(1, 4, 32)
    with pytest.raises(ValueError, match='termination'):
        tv.value_estimate(prep, z, torch.zeros(1, 3, 4, 4), torch.zeros(1, 4, 4),
                          torch.zeros(1, 2, dtype=torch.int32),
                          tagent.discs[None], **_heads(tagent), episodic=True)


# ----------------------------------------------------------------- CEM


@pytest.mark.parametrize('n', [1, N], ids=['one-env', 'n-envs-vmap'])
def test_cem_plan_plain_episodic_matches_pallas_cem_kernel(agents, n):
    jagent, jp, tagent = agents
    cfg = jagent.cfg
    H, S, A = cfg.horizon, cfg.num_samples, cfg.action_dim
    I, n_pi, HA = jagent.iterations, cfg.num_pi_trajs, H * cfg.action_dim
    rng = np.random.default_rng(30 + n)
    f = np.float32
    z0 = _latents(jagent, jp, rng, n, 1)
    pi_eps = rng.normal(size=(n, n_pi, HA)).astype(f)
    noise = rng.normal(size=(n, I, S, HA)).astype(f)
    noise[:, :, :n_pi] = 0.0                  # JAX pads the pi rows with zeros
    eps = rng.normal(size=(n, I, S, A)).astype(f)
    qidx = np.stack([[rng.permutation(cfg.num_q)[:2] for _ in range(I)]
                     for _ in range(n)]).astype(np.int32)
    discs = np.stack([g ** np.arange(H + 1) for g in (0.95, 0.9, 0.99)][:n]
                     ).astype(f)
    mean0 = (0.1 * rng.normal(size=(n, 1, HA))).astype(f)
    std0 = np.full((n, 1, HA), cfg.max_std, f)
    kw = dict(iterations=I, n_pi=n_pi, num_elites=cfg.num_elites,
              temperature=cfg.temperature, min_std=cfg.min_std,
              max_std=cfg.max_std)
    jprep = jprepare(jp, cfg, dot_dtype=jnp.float32)

    def ref_one(*x):
        return cem_prepared(jprep, *x, jnp.ones((1, A), jnp.float32),
                            horizon=H, episodic=True, dot_dtype=jnp.float32,
                            interpret=True, **kw, **_heads(jagent))
    inputs = (z0, pi_eps, noise, eps, qidx, discs, mean0, std0)
    ref = (tuple(r[None] for r in ref_one(*(x[0] for x in inputs))) if n == 1
           else jax.vmap(ref_one)(*inputs))
    prep = tv.prepare_value_params(tagent.params, tagent.cfg, torch.float32)
    args = (prep, _t(z0), _t(pi_eps), _t(noise), _t(eps), _t(qidx), _t(discs),
            _t(mean0)[:, 0], _t(std0)[:, 0], torch.ones(A))
    got = cem.cem_plan_plain(*args, simnorm_dim=8, episodic=True, **kw,
                             **_heads(tagent))
    for g, r, shape in zip(got, ref, [(n, HA), (n, HA), (n, S, 1), (n, S, HA)]):
        assert g.shape == shape and torch.isfinite(g).all()
        _close(g, r, VTOL)
    acts = got[3].view(n, S, H, A).permute(0, 2, 1, 3)
    _assert_split(_flag_share(prep, args[1].expand(n, S, -1), acts, args[6]))


def test_plan_vec_episodic_matches_jax_plan_vec():
    """The JAX planner runs its whole-CEM Pallas kernel interpreted with f32
    dots, vmapped over the env axis, with the termination gate; env i of the
    port gets the draws JAX made from keys[i]."""
    jagent, jp, tagent = _agents(N)
    jagent._fused_cem = True
    jagent._cem_interpret = True
    jagent._pallas_dot_dtype = jnp.float32
    cfg = jagent.cfg
    ko, kp, key = jax.random.split(jax.random.PRNGKey(31), 3)
    obs = jax.random.normal(ko, (N, OBS))
    prev_mean = 0.1 * jax.random.normal(kp, (N, cfg.horizon, cfg.action_dim))
    t0 = np.array([True, False, False])
    acts, new_prev_mean, _ = jagent._plan_vec(
        jp, obs, prev_mean, jnp.asarray(t0), key, None, eval_mode=True)
    keys = jax.random.split(key, N + 1)
    noise = _stack([_jax_plan_noise(keys[i], cfg, jagent.iterations)
                    for i in range(N)])
    tagent.prev_mean = _t(prev_mean)
    a, m = tagent.plan_vec(_t(obs), t0, eval_mode=True, noise=noise)
    _close(m, new_prev_mean, VTOL)
    _close(a, acts, ATOL)
    # the planned means, rolled out from each env's latent, split the flag
    H, A, S = cfg.horizon, cfg.action_dim, 16
    z = tagent.model.encode(tagent.params, _t(obs))[:, None].expand(N, S, -1)
    rng = np.random.default_rng(31)
    plans = (m[:, :, None] + 0.5 * _t(rng.normal(size=(N, H, S, A)).astype(
        np.float32))).clamp(-1, 1)
    _assert_split(_flag_share(tagent.prep, z, plans, tagent.discs.expand(N, -1)))


# ----------------------------------------------------------------- update


def _term_batch(rng, T, B=8, lead=()):
    """A batch in the buffer's layout with 20% of `terminated` set (rounded),
    at random places."""
    f = np.float32
    shape = lead + (T, B, 1)
    term = np.zeros(int(np.prod(shape)), f)
    term[rng.permutation(term.size)[:round(0.2 * term.size)]] = 1.0
    return (rng.normal(size=lead + (T + 1, B, OBS)).astype(f),
            rng.uniform(-1, 1, lead + (T, B, 4)).astype(f),
            rng.uniform(0, 1, shape).astype(f), term.reshape(shape))


SMALL = dict(latent_dim=32, mlp_dim=64, num_q=3)


def _update_agents(**kw):
    jcfg = _episodic(_dims(jparse(JConfig(task='toy')), **SMALL, **kw))
    tcfg = _episodic(_dims(parse_cfg(Config(task='toy', device='cpu')),
                           **SMALL, **kw))
    jag, tag = JTDMPC2(jcfg), TDMPC2(tcfg)
    jstate = jag.state.replace(params=_split_termination(jag, jag.state.params))
    return jag, tag, jstate


def _predicted_split(tag, params, obs, action):
    """Share of the batch's one-step predicted latents that the head flags."""
    z1 = tag.model.next(params, tag.model.encode(params, obs[0]), action[0])
    return float((tag.model.termination(params, z1) > 0.5).float().mean())


def test_update_episodic_matches_jax_update():
    jag, tag, jstate = _update_agents(dropout=0.01)
    jcfg = jag.cfg
    batch = _term_batch(np.random.default_rng(40), jcfg.horizon)
    assert 0 < batch[3][-1].mean() < 1
    tstate = state_from_jax(jstate)
    assert 'termination' in tstate.opt_state['rest']['mu']
    _assert_split(_predicted_split(tag, tstate.params, *(
        torch.from_numpy(x) for x in batch[:2])))
    upd = jax.jit(jag._update)
    for step in range(5):
        noise = _noise_from_jax(jstate.key, jcfg)
        jstate, jinfo = upd(jstate, *batch)
        tinfo = tag._update(tstate, *(torch.from_numpy(x) for x in batch), noise)
        assert set(tinfo) == set(jinfo)
        assert {'termination_rate', 'termination_f1'} <= set(tinfo)
        for k in tinfo:
            np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]), **VTOL,
                                       err_msg=f'step {step}: {k}')
        _hold_states(tstate, state_from_jax(jstate), VTOL)
    assert float(tinfo['termination_loss']) > 0.0
    np.testing.assert_allclose(float(tinfo['termination_rate']),
                               batch[3][-1].mean(), rtol=1e-6)


def test_update_scan_episodic_matches_jax_update_scan():
    jag, tag, jstate = _update_agents(dropout=0.0, num_envs=2)
    jcfg = jag.cfg
    n, T = 3, jcfg.horizon
    batch = _term_batch(np.random.default_rng(41), T, lead=(n,))
    assert 0 < batch[3][-1].mean() < 1
    noises, key = [], jstate.key
    for _ in range(n):
        noises.append(_noise_from_jax(key, jcfg))
        key = jax.random.split(key, 9)[8]
    tstate = state_from_jax(jstate)
    _assert_split(_predicted_split(tag, tstate.params, *(
        torch.from_numpy(x[0]) for x in batch[:2])))
    jstate, jinfo = jax.jit(jag._update_scan)(jstate, *batch)
    tag.state = tstate
    tb = [torch.from_numpy(x) for x in batch]
    for i in range(n):                # update_many's steps, on these draws
        tinfo = tag._step(tuple(x[i] for x in tb), noises[i])
    assert set(tinfo) == set(jinfo) and 'termination_f1' in tinfo
    for k in tinfo:
        np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]), **VTOL,
                                   err_msg=k)
    _hold_states(tstate, state_from_jax(jstate), VTOL)
    assert float(tinfo['termination_loss']) > 0.0


def test_sigmoid_binary_cross_entropy_matches_optax():
    rng = np.random.default_rng(42)
    x = rng.normal(0, 4, (7, 5, 1)).astype(np.float32)
    x[0, 0, 0], x[1, 0, 0], x[2, 0, 0] = 80.0, -80.0, 0.0   # saturated, zero
    z = (rng.uniform(size=x.shape) < 0.3).astype(np.float32)
    _close(tm.sigmoid_binary_cross_entropy(_t(x), _t(z)),
           optax.sigmoid_binary_cross_entropy(x, z), dict(rtol=1e-6, atol=1e-6))
    # the gradient too (the update differentiates it)
    xt = _t(x).requires_grad_(True)
    g, = torch.autograd.grad(tm.sigmoid_binary_cross_entropy(xt, _t(z)).sum(), xt)
    jg = jax.grad(lambda v: optax.sigmoid_binary_cross_entropy(v, z).sum())(x)
    _close(g, jg, dict(rtol=1e-6, atol=1e-6))


# ----------------------------------------------------------------- trainers


class _GoalAgent(_StubAgent):
    """The stub agent with a PD controller towards the goal: obs = [pos,
    vel, goal - pos], so most episodes end early on success."""

    @staticmethod
    def _a(obs):
        obs = np.asarray(obs, np.float32)
        return np.clip(3.0 * obs[..., 4:6] - 2.0 * obs[..., 2:4], -1, 1)


def _recording(logger, out):
    log = logger.log

    def rec(metrics, category):
        if category == 'train':
            out.append((metrics['episode_length'],
                        float(metrics['episode_terminated'])))
        return log(metrics, category)
    logger.log = rec
    return logger


@pytest.mark.parametrize('num_envs', [1, N])
def test_trainers_match_jax_trainers_on_episodic_env(tmp_path, num_envs):
    """The same episodic env copies and the same (stub) agent under the JAX
    and the port's trainer give the same calls (t0 per env after a slot's
    reset; each planned vector step of the JAX trainer's pipelined schedule
    is the port's one `vec_step` call), the same episode flushes
    (valid_rows, obs, reward) and the same logged episode lengths and
    termination flags."""
    logs, metrics = {}, {}
    for name, (C, P, mk, Trainer, Log) in {
            'jax': (JConfig, jparse, jmake_env,
                    JVecTrainer if num_envs > 1 else JOnlineTrainer, JLogger),
            'port': (Config, parse_cfg, make_env,
                     VecOnlineTrainer if num_envs > 1 else OnlineTrainer,
                     Logger)}.items():
        kw = {} if name == 'jax' else {'device': 'cpu'}
        cfg = P(C(task='toy-reach-episodic', episodic=True, num_envs=num_envs,
                  steps=330, eval_freq=165, eval_episodes=2, save_csv=False,
                  save_agent=False, **kw))
        cfg.work_dir = str(tmp_path / name)
        env = mk(cfg)
        cfg.seed_steps = 61
        log, out = [], []
        Trainer(cfg=cfg, env=env, agent=_GoalAgent(log), buffer=_StubBuffer(log),
                logger=_recording(Log(cfg), out)).train()
        logs[name], metrics[name] = log, out
    assert logs['port'] == (_as_vec_steps(logs['jax']) if num_envs > 1 else logs['jax'])
    assert metrics['port'] == metrics['jax']
    lengths = [m[0] for m in metrics['port']]
    assert min(lengths) < 50 and any(m[1] for m in metrics['port'])
    flushed = [e[1] for e in logs['port'] if e[0] == 'add']
    assert min(flushed) < 51


TINY = ['task=toy-reach-episodic', 'episodic=true', 'device=cpu', 'steps=220',
        'eval_freq=200', 'eval_episodes=1', 'batch_size=16', 'enc_dim=32',
        'mlp_dim=32', 'latent_dim=16', 'num_q=2', 'num_samples=32',
        'num_elites=4', 'num_pi_trajs=4', 'iterations=1', 'save_agent=false']


@pytest.mark.parametrize('num_envs', [1, 4])
def test_train_episodic_on_cpu(tmp_path, monkeypatch, num_envs):
    """`train` on toy-reach-episodic at a tiny width. Episodes start within
    0.12 of the goal here (a test-only reset), so that random and planned
    actions end some early in a short run: shorter episodes reach the
    buffer with their terminal flag, and the losses, the termination loss
    included, are finite."""
    monkeypatch.chdir(tmp_path)
    env_rng = np.random.default_rng(43)

    def near_goal_reset(self):
        self._pos = (self._goal + env_rng.uniform(-0.12, 0.12, 2)).astype(np.float32)
        self._vel = np.zeros(2, np.float32)
        return self._obs()
    monkeypatch.setattr(toy.PointMassEnv, 'reset', near_goal_reset)

    def small_seed_phase(cfg):
        env = make_env(cfg)
        cfg.seed_steps = 60
        return env
    monkeypatch.setattr(train_mod, 'make_env', small_seed_phase)
    infos = []
    upd = TDMPC2._update
    monkeypatch.setattr(TDMPC2, '_update', lambda self, *a: infos.append(
        upd(self, *a)) or infos[-1])
    trainer = train_mod.main(TINY + [f'num_envs={num_envs}'])
    buf = trainer.buffer
    rows = buf._ep_rows[:min(buf.num_eps, buf.capacity)]
    assert bool((rows < 51).any()), rows
    assert float(buf._storage['terminated'].nan_to_num().sum()) > 0
    assert len(infos) >= 60
    for info in infos[::20] + infos[-1:]:
        assert all(math.isfinite(float(v)) for v in info.values())
        assert {'termination_rate', 'termination_f1'} <= set(info)
    assert float(infos[-1]['termination_loss']) > 0.0


def test_episodic_checkpoint_round_trip(tmp_path):
    """save/load keeps the termination head and its Adam moments; the
    architecture check tells an episodic checkpoint from another."""
    tcfg = _episodic(_dims(parse_cfg(Config(task='toy', device='cpu'))))
    ag = TDMPC2(tcfg)
    rng = np.random.default_rng(44)
    batch = [torch.from_numpy(x) for x in _term_batch(rng, tcfg.horizon)]
    ag._update(ag.state, *batch, ag.draw_update_noise())
    fp = Path(tmp_path) / 'models' / 'latest.pkl'
    ag.save(fp, extra={'step': 1})
    ag2 = TDMPC2(tcfg)
    assert ag2.load(fp) == {'step': 1}
    _hold_states(ag2.state, ag.state, EXACT)
    assert 'termination' in ag2.state.params
    assert 'termination' in ag2.state.opt_state['rest']['nu']
    other = TDMPC2(_dims(parse_cfg(Config(task='toy', device='cpu'))))
    with pytest.raises(ValueError, match='episodic'):
        other.load(fp)
    # the JAX agent reads it, termination head included
    jag = JTDMPC2(_episodic(_dims(jparse(JConfig(task='toy')))))
    jag.load(str(fp))
    for a, b in zip(jax.tree.leaves(jag.state.params['termination']),
                    jax.tree.leaves(jax.tree.map(
                        lambda x: x.numpy(), ag.state.params['termination']))):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_act_episodic_plans_through_the_gate(agents):
    """`act` on an episodic agent plans (CPU: the plain versions) with the
    gate: a plan with the termination head changes when the head does."""
    _, _, tagent = agents
    obs = np.random.default_rng(45).normal(size=(N, OBS)).astype(np.float32)
    tagent.generator.manual_seed(0)
    a = tagent.act(obs, t0=True, eval_mode=True)
    assert a.shape == (N, 4) and np.all(np.isfinite(a))
    saved = tagent.state.params['termination']
    last = dict(saved[-1], b=saved[-1]['b'] + 100.0)   # every row terminates
    tagent.state.params['termination'] = saved[:-1] + (last,)
    tagent._prep = None
    tagent.generator.manual_seed(0)
    try:
        b = tagent.act(obs, t0=True, eval_mode=True)
    finally:
        tagent.state.params['termination'] = saved
        tagent._prep = None
    assert not np.allclose(a, b)
