"""PyTorch port vs the JAX package: the multi-task model and planner (CPU,
small widths, f32).

A toy multi-task config: 4 tasks with action dims 4, 2, 3, 1 (A = 4),
task_dim 8, episode lengths (so discounts) that differ by task. Each test
feeds the port the inputs and draws JAX used:

- the config: `task=mt30`/`mt80` and model sizes against the JAX config
  (task_dim rule, the mt30/19M latent quirk, the task list);
- the world model's heads with a task per row, against JAX's;
- the planner's prep: the port folds every task's embedding into a
  first-layer bias table and masks the pi head's output, where the JAX prep
  folds one task and masks the mean head's weights: each task's row and
  value step against JAX's folded prep, and the masked actions equal to
  the folded version's;
- the planner's three steps at N = 4 tasks, one launch each (plain
  versions: value_sampled, pi_rollout, elite_moments) against JAX's per
  task;
- `act(task=i)` against the JAX `_plan` for task i, and `act_tasks`
  against the JAX agent's planner vmapped over tasks, each task fed the
  draws JAX made from its key;
- one multi-task `_update` against JAX's, from `interop.state_from_jax`.

Tolerances are the JAX suite's: 1e-4 for values and means, 1e-3 for
actions."""

from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_planner import _jax_plan_noise, _perturb
from test_torch_train import _hold_states, _noise_from_jax
from test_torch_vec import _stack
from tdmpc2_tpu.config import Config as JConfig, load_cfg as jload_cfg
from tdmpc2_tpu.config import parse_cfg as jparse
from tdmpc2_tpu.models import layers as jl
from tdmpc2_tpu.ops import math as jmath
from tdmpc2_tpu.ops.pallas_rollout import (prepare_value_params as jprepare,
                                           value_prepared)
from tdmpc2_tpu.tdmpc2 import TDMPC2 as JTDMPC2
from tdmpc2_tpu_torch.config import Config, load_cfg, parse_cfg
from tdmpc2_tpu_torch.interop import params_from_jax, state_from_jax
from tdmpc2_tpu_torch.ops import cem
from tdmpc2_tpu_torch.ops import value as tv
from tdmpc2_tpu_torch.tdmpc2 import TDMPC2
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
VTOL = dict(rtol=1e-4, atol=1e-4)
ATOL = dict(rtol=1e-3, atol=1e-3)
TASKS = ['toy-a', 'toy-b', 'toy-c', 'toy-d']
ADIMS = [4, 2, 3, 1]
EPLENS = [20, 30, 50, 100]
OBS, A, NT = 10, 4, len(TASKS)


def _mt(cfg, episodic=False, batch_size=8):
    """The toy multi-task geometry, set after parse_cfg as the JAX suite
    does (tests/test_agent.py:175-186)."""
    cfg.multitask, cfg.tasks, cfg.task_dim = True, list(TASKS), 8
    cfg.obs_shape = {'state': (OBS,)}
    cfg.action_dim, cfg.action_dims = A, list(ADIMS)
    cfg.obs_shapes, cfg.episode_lengths = [OBS, 6, 8, 4], list(EPLENS)
    cfg.episode_length = EPLENS[0]
    cfg.enc_dim, cfg.mlp_dim, cfg.latent_dim = 64, 64, 32
    cfg.num_samples, cfg.num_elites, cfg.num_pi_trajs = 64, 8, 8
    cfg.iterations, cfg.num_q, cfg.batch_size = 2, 3, batch_size
    cfg.episodic = episodic
    return cfg


def _agents(episodic=False):
    jagent = JTDMPC2(_mt(jparse(JConfig(task='toy')), episodic))
    jp = _perturb(jagent.state.params)
    tagent = TDMPC2(_mt(parse_cfg(Config(task='toy', device='cpu')), episodic))
    tagent.load_params(params_from_jax(jax.tree.map(np.asarray, jp)))
    return jagent, jp, tagent


@pytest.fixture(scope='module')
def agents():
    return _agents()


@pytest.fixture(scope='module')
def ep_agents():
    return _agents(episodic=True)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **tol)


def _heads(agent):
    return dict(log_std_min=agent.model.log_std_min,
                log_std_dif=agent.model.log_std_dif)


def _masks():
    m = np.zeros((NT, A), np.float32)
    for i, d in enumerate(ADIMS):
        m[i, :d] = 1.0
    return m


# ----------------------------------------------------------------- config


@pytest.mark.parametrize('overrides', [
    ['task=mt30'], ['task=mt30', 'model_size=48'], ['task=mt30', 'model_size=19'],
    ['task=mt30', 'model_size=1'], ['task=mt80', 'model_size=317']])
def test_multitask_config_matches_jax_config(overrides):
    got, ref = load_cfg(overrides=overrides), jload_cfg(overrides=overrides)
    for k in vars(got):
        if k != 'device':
            assert getattr(got, k) == getattr(ref, k), k
    assert got.multitask and got.tasks == ref.tasks
    if overrides == ['task=mt30', 'model_size=48']:
        assert (got.task_dim, len(got.tasks), got.mlp_dim) == (64, 30, 1792)


def test_mt30_literal_matches_dataset_chunk():
    """chip_smoke's mt30 per-task dims against the in-repo dataset: each
    task's action columns and observation columns that are ever non-zero."""
    import chip_smoke
    with np.load(ROOT / 'datasets' / 'mt30_medium' / 'chunk_0.npz') as z:
        obs, act, task = z['obs'], z['action'], z['task']
    adims, odims = [], []
    for i in range(30):
        a = np.abs(act[task == i][:, 1:]).max(axis=(0, 1))
        o = np.abs(obs[task == i]).max(axis=(0, 1))
        adims.append(int(np.flatnonzero(a > 0).max()) + 1)
        odims.append(int(np.flatnonzero(o > 0).max()) + 1)
    assert chip_smoke.MT30_ACTION_DIMS == adims
    assert chip_smoke.MT30_OBS_DIMS == odims
    assert len(load_cfg(overrides=['task=mt30']).tasks) == 30


# ----------------------------------------------------------------- model


@pytest.mark.parametrize('head', ['encode', 'next', 'reward', 'pi', 'Q',
                                  'termination'])
def test_heads_with_task_match_jax(agents, ep_agents, head):
    jagent, jp, tagent = ep_agents if head == 'termination' else agents
    jm, tm, tp = jagent.model, tagent.model, tagent.params
    rng = np.random.default_rng(3)
    T, B, L = 3, 8, 32
    task = rng.integers(0, NT, B)
    z = np.asarray(jm.encode(jp, rng.normal(size=(T, B, OBS)).astype(np.float32),
                             jnp.asarray(task)))
    a = rng.uniform(-1, 1, (T, B, A)).astype(np.float32)
    tt = torch.from_numpy(task)
    if head == 'encode':
        obs = rng.normal(size=(T, B, OBS)).astype(np.float32)
        _close(tm.encode(tp, _t(obs), tt), jm.encode(jp, obs, task), VTOL)
    elif head == 'next':
        _close(tm.next(tp, _t(z), _t(a), tt), jm.next(jp, z, a, task), VTOL)
    elif head == 'reward':
        _close(tm.reward(tp, _t(z), _t(a), tt), jm.reward(jp, z, a, task), VTOL)
    elif head == 'termination':
        _close(tm.termination(tp, _t(z), tt, unnormalized=True),
               jm.termination(jp, z, task, unnormalized=True), VTOL)
    elif head == 'pi':
        key = jax.random.PRNGKey(4)
        ref_a, ref = jm.pi(jp, z, key, task)
        eps = _t(jax.random.normal(key, (T, B, A)))
        got_a, got = tm.pi(tp, _t(z), eps, tt)
        _close(got_a, ref_a, ATOL)
        for k in ('mean', 'log_std', 'entropy', 'scaled_entropy'):
            _close(got[k], ref[k], VTOL)
        # masked columns are 0 in every sample
        assert (got_a * (1 - _t(_masks()[task]))).abs().max() == 0
    else:
        key = jax.random.PRNGKey(5)
        ref = jm.Q(jp, z, a, key=key, task=task, return_type='avg')
        qidx = _t(jax.random.permutation(key, 3)[:2]).long()
        _close(tm.Q(tp, _t(z), _t(a), qidx=qidx, task=tt, return_type='avg'),
               ref, VTOL)
        _close(tm.Q(tp, _t(z), _t(a), task=tt, return_type='all'),
               jm.Q(jp, z, a, task=task, return_type='all'), VTOL)


# ----------------------------------------------------------------- prep


@pytest.mark.parametrize('episodic', [False, True], ids=['plain', 'episodic'])
def test_prep_fold_matches_jax_fold_per_task(agents, ep_agents, episodic):
    """Each task's row of the port's bias tables is the bias JAX folds for
    that task; the value step with the task's row and output mask equals
    JAX's value kernel on its folded, mean-masked prep (eps masked); and
    the pi action masked at the output equals the one from folded weights,
    every bit (a masked column is +-0 either way). The value step is run
    for tasks 1 and 3 (action dims 2 and 1)."""
    jagent, jp, tagent = ep_agents if episodic else agents
    cfg = jagent.cfg
    prep = tv.prepare_value_params(tagent.params, tagent.cfg, torch.float32)
    masks = _masks()
    S, H, L = 16, cfg.horizon, cfg.latent_dim
    rng = np.random.default_rng(9)
    z0 = np.asarray(jagent.model.encode(
        jp, rng.normal(size=(1, OBS)).astype(np.float32), jnp.asarray([0])))
    z0 = np.broadcast_to(z0, (S, L))
    actions = (rng.uniform(-1, 1, (H, S, A)) * masks[2]).astype(np.float32)
    eps = rng.normal(size=(S, A)).astype(np.float32)
    q = np.array([2, 0], np.int32)
    off = 10 if episodic else 0
    for i in range(NT):
        jprep = jprepare(jp, cfg, task=jnp.asarray([i]),
                         action_mask=jnp.asarray(masks[i]), dot_dtype=jnp.float32)
        rows = {'db0': 2, 'rb0': 15, 'pb0': 25 + off, 'qb0': 38 + off}
        if episodic:
            rows['tb0'] = 25
        for k, j in rows.items():
            _close(prep[k][i], np.asarray(jprep[j]).reshape(prep[k][i].shape), VTOL)
        if i % 2 == 0:           # the value step for two of the tasks
            continue
        discs = (jagent.discount[i] ** np.arange(H + 1)).astype(np.float32)
        ref = value_prepared(jprep, z0, actions, eps * masks[i], q, discs,
                             horizon=H, episodic=episodic, dot_dtype=jnp.float32,
                             interpret=True, **_heads(jagent))
        got = tv.value_estimate(
            prep, *(_t(x)[None] for x in (np.ascontiguousarray(z0), actions, eps,
                                          q, discs)),
            **_heads(tagent), episodic=episodic,
            task=torch.tensor([i], dtype=torch.int32), amask=_t(masks[i]))
        _close(got[0], ref, VTOL)
        # the output mask against the weights' fold, on the same hidden rows
        folded = dict(prep, pWm=prep['pWm'] * _t(masks[i]),
                      pbm=prep['pbm'] * _t(masks[i]))
        zt, task = torch.from_numpy(np.ascontiguousarray(z0)), torch.tensor([i])
        mean, ls = tv.pi_head_plain(prep, zt[None], **_heads(tagent), task=task)
        fmean, fls = tv.pi_head_plain(folded, zt[None], **_heads(tagent), task=task)
        m = _t(masks[i])
        assert torch.equal(tv.pi_action_plain(mean, ls, _t(eps), m),
                           torch.tanh(fmean + (_t(eps) * m) * torch.exp(fls)))


# ----------------------------------------------------------------- steps


def _jax_pi_action(jagent, jp, z, eps, task):
    """The JAX model's pi action (world_model.py:144-184) with the given
    eps in place of its own draw: mean, log-std and eps masked."""
    m = jagent.model
    mean, lstd = jnp.split(jl.mlp_apply(jp['pi'], m.task_emb(jp, z, task)), 2, -1)
    lstd = jmath.log_std(lstd, m.log_std_min, m.log_std_dif)
    mask = m.action_masks[task]
    return jnp.tanh(mean * mask + eps * mask * jnp.exp(lstd * mask))


def _task_inputs(jagent, jp, seed):
    cfg = jagent.cfg
    H, S, L = cfg.horizon, cfg.num_samples, cfg.latent_dim
    rng = np.random.default_rng(seed)
    task = np.array([3, 1, 0, 2])
    z = np.asarray(jagent.model.encode(
        jp, rng.normal(size=(NT, OBS)).astype(np.float32), jnp.asarray(task)))
    return task, dict(
        z=z, mean=rng.uniform(-0.8, 0.8, (NT, H * A)).astype(np.float32),
        std=rng.uniform(0.1, 2.0, (NT, H * A)).astype(np.float32),
        noise=rng.normal(size=(NT, S, H * A)).astype(np.float32),
        pi_eps=rng.normal(size=(NT, 8, H * A)).astype(np.float32),
        eps=rng.normal(size=(NT, S, A)).astype(np.float32),
        qidx=np.stack([rng.permutation(3)[:2] for _ in range(NT)]).astype(np.int32),
        value=rng.normal(size=(NT, S)).astype(np.float32))


def test_planner_steps_at_n_tasks_match_jax(agents):
    """One N=4 call of each planner step (each task its own bias rows, mask
    and discounts) against JAX for each task: the pi rollout against the
    model's pi/next scan (tdmpc2.py:557-563), the sampled value step
    against the value kernel on the task's folded prep (envs 0 and 1, tasks
    3 and 1), the elite step against the XLA iteration's top-k moments
    (tdmpc2.py:655-671)."""
    jagent, jp, tagent = agents
    cfg = jagent.cfg
    H, S, E, L = cfg.horizon, cfg.num_samples, cfg.num_elites, cfg.latent_dim
    task, x = _task_inputs(jagent, jp, 21)
    masks = _masks()[task]
    prep = tv.prepare_value_params(tagent.params, tagent.cfg, torch.float32)
    tt = torch.from_numpy(task.astype(np.int32))
    am = _t(masks)
    discs = tagent.discs[tt.long()]
    pa = cem.pi_rollout(prep, _t(x['z'])[:, None], _t(x['pi_eps']),
                        **_heads(tagent), task=tt, amask=am)
    v, acts = tv.value_sampled(
        prep, _t(x['z'])[:, None].expand(NT, S, L), _t(x['mean']), _t(x['std']),
        _t(x['noise']), pa, am, _t(x['eps']), _t(x['qidx']), discs,
        **_heads(tagent), task=tt)
    mean, std, _ = cem.elite_moments(_t(x['value']), acts, am, num_elites=E,
                                     temperature=cfg.temperature,
                                     min_std=cfg.min_std, max_std=cfg.max_std)
    for e in range(NT):
        ti, m = jnp.asarray([task[e]]), jnp.asarray(masks[e])
        zc, steps = jnp.broadcast_to(jnp.asarray(x['z'][e]), (8, L)), []
        for t in range(H):
            a = _jax_pi_action(jagent, jp, zc, x['pi_eps'][e, :, t * A:(t + 1) * A], ti)
            steps.append(a)
            zc = jagent.model.next(jp, zc, a, ti)
        _close(pa[e], jnp.concatenate(steps, -1), ATOL)
        samp = jnp.clip(x['mean'][e] + x['std'][e] * x['noise'][e], -1, 1)
        samp = jnp.concatenate([pa[e].numpy(), samp[8:]], 0) * jnp.tile(m, H)
        _close(acts[e], samp, dict(rtol=0, atol=1e-6))
        if e >= 2:               # JAX's value kernel for two of the tasks
            continue
        jprep = jprepare(jp, cfg, task=ti, action_mask=m, dot_dtype=jnp.float32)
        ref_v = value_prepared(
            jprep, np.broadcast_to(x['z'][e], (S, L)),
            jnp.moveaxis(samp.reshape(S, H, A), 1, 0), x['eps'][e] * masks[e],
            x['qidx'][e], np.asarray(discs[e]), horizon=H, episodic=False,
            dot_dtype=jnp.float32, interpret=True, **_heads(jagent))
        _close(v[e], ref_v, VTOL)
        ev, ei = jax.lax.top_k(jnp.asarray(x['value'][e]), E)
        ea = acts[e].numpy()[np.asarray(ei)]
        sc = jnp.exp(cfg.temperature * (ev - ev.max()))
        sc = (sc / sc.sum())[:, None]
        den = sc.sum() + 1e-9
        mu = (sc * ea).sum(0) / den
        sd = jnp.clip(jnp.sqrt((sc * (ea - mu) ** 2).sum(0) / den),
                      cfg.min_std, cfg.max_std)
        _close(mean[e], mu * jnp.tile(m, H), VTOL)
        _close(std[e], sd * jnp.tile(m, H), VTOL)


# ----------------------------------------------------------------- act


@pytest.mark.parametrize('task,eval_mode', [(1, True), (3, False)])
def test_act_task_matches_jax_plan(agents, task, eval_mode):
    jagent, jp, tagent = agents
    cfg = jagent.cfg
    ko, kp, key = jax.random.split(jax.random.PRNGKey(20 + task), 3)
    obs = jax.random.normal(ko, (1, OBS))
    prev_mean = 0.1 * jax.random.normal(kp, (cfg.horizon, A))
    a_ref, mean_ref, _ = jagent._plan(jp, obs, prev_mean, jnp.asarray(False), key,
                                      jnp.asarray([task]), eval_mode=eval_mode,
                                      fused=False)
    tagent.prev_mean = _t(prev_mean)[None]
    a, mean = tagent.plan_vec(_t(obs), np.array([False]), eval_mode=eval_mode,
                              noise=_jax_plan_noise(key, cfg, jagent.iterations),
                              task=torch.tensor([task], dtype=torch.int32))
    _close(mean[0], mean_ref, VTOL)
    _close(a[0], a_ref, ATOL)
    assert torch.all(a[0, ADIMS[task]:] == 0)


def test_act_tasks_matches_jax_vmapped_planner(agents):
    """All 4 tasks in one plan, each with its own warm start, t0 and key,
    against the JAX agent's `act_tasks` body: `_plan` vmapped over the
    tasks with fused=False (tdmpc2.py:414-420)."""
    jagent, jp, tagent = agents
    cfg = jagent.cfg
    ko, kp, key = jax.random.split(jax.random.PRNGKey(31), 3)
    obs = jax.random.normal(ko, (NT, OBS))
    pm = 0.1 * jax.random.normal(kp, (NT, cfg.horizon, A))
    t0 = np.array([False, True, False, False])
    tasks = np.array([2, 0, 3, 1])
    keys = jax.random.split(key, NT + 1)
    acts, means, _ = jax.vmap(
        partial(jagent._plan, eval_mode=True, fused=False),
        in_axes=(None, 0, 0, 0, 0, 0, None))(
        jp, obs[:, None], pm, jnp.asarray(t0), keys[:NT],
        jnp.asarray(tasks)[:, None], None)
    noise = _stack([_jax_plan_noise(keys[i], cfg, jagent.iterations)
                    for i in range(NT)])
    a, new_pm = tagent.act_tasks(np.asarray(obs), np.asarray(pm), t0, tasks,
                                 noise=noise)
    np.testing.assert_allclose(a, np.asarray(acts), **ATOL)
    _close(new_pm, means, VTOL)
    for i, t in enumerate(tasks):
        assert np.all(a[i, ADIMS[t]:] == 0)
    # the agent's own warm starts are untouched; the caller's come back
    assert tagent.prev_mean.shape == (1, cfg.horizon, A)
    a2, pm2 = tagent.act_tasks(np.asarray(obs), new_pm, True, tasks)
    assert pm2 is new_pm and a2.shape == (NT, A)


# ----------------------------------------------------------------- update


def test_multitask_update_matches_jax_update():
    """Two `_update` steps with a task per sample: the embedding, the
    masks and each sample's discount, against JAX at 1e-4 (state and
    info)."""
    jcfg = _mt(jparse(JConfig(task='toy')), batch_size=8)
    tcfg = _mt(parse_cfg(Config(task='toy', device='cpu')), batch_size=8)
    jcfg.dropout = tcfg.dropout = 0.01
    jag, tag = JTDMPC2(jcfg), TDMPC2(tcfg)
    jstate = jag.state.replace(params=_perturb(jag.state.params, 2))
    rng = np.random.default_rng(12)
    T, B = jcfg.horizon, 8
    task = rng.integers(0, NT, B).astype(np.int32)
    batch = (rng.normal(size=(T + 1, B, OBS)),
             rng.uniform(-1, 1, (T, B, A)) * _masks()[task],
             rng.uniform(0, 1, (T, B, 1)), np.zeros((T, B, 1)))
    batch = tuple(x.astype(np.float32) for x in batch)
    tstate = state_from_jax(jstate)
    upd = jax.jit(jag._update)
    for step in range(2):
        noise = _noise_from_jax(jstate.key, jcfg)
        jstate, jinfo = upd(jstate, *batch, jnp.asarray(task))
        tinfo = tag._update(tstate, *(torch.from_numpy(x) for x in batch),
                            noise, torch.from_numpy(task))
        for k in tinfo:
            np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f'step {step}: {k}')
        _hold_states(tstate, state_from_jax(jstate))
