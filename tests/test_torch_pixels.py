"""PyTorch port vs the JAX package: pixel observations (CPU).

The same inputs, made from a numpy seed or recorded from the trained
walker-walk pixel agent (tests/data/pixel_observations.npz), through the
JAX function and the port's, with the JAX draws fed to the port as data:

- `pixel_preprocess`, `conv_output_dim`, and `conv_encoder_apply` on the
  committed walker-walk-rgb checkpoint's conv weights and recorded frames,
  at 1e-4; `shift_aug` given JAX's shifts, bit for bit;
- `WorldModel.encode` on [B, C, H, W] and [T, B, C, H, W] frames, at 1e-4;
- five pixel `_update` steps from `interop.state_from_jax`, at 1e-4, and a
  plan: values and means at 1e-4, actions at 1e-3 (64 px, 4 channels, so
  latent 64; the JAX suite's 32 px has a conv output of 0);
- the buffer's unstacked uint8 frames after `add` and `load`, and the
  restacked slices at the same (episode, start) pairs, starts 0 and 1
  among them, bit for bit;
- `PixelObs(PointMassEnv)` over an episode, and what `make_env` refuses
  for rgb observations;
- a port-only pixel `OnlineTrainer` run: finite losses, uint8 storage.
"""

from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdmpc2_tpu.config import Config as JConfig, parse_cfg as jparse
from tdmpc2_tpu.data.buffer import Buffer as JBuffer
from tdmpc2_tpu.envs.base import NormalizeInfo as JNormalizeInfo, Timeout as JTimeout
from tdmpc2_tpu.envs.dmcontrol import PixelObs as JPixelObs
from tdmpc2_tpu.envs.toy import PointMassEnv as JPointMassEnv
from tdmpc2_tpu.models import layers as jl
from tdmpc2_tpu.tdmpc2 import TDMPC2 as JTDMPC2
from tdmpc2_tpu_torch.config import Config, parse_cfg
from tdmpc2_tpu_torch.data.buffer import Buffer
from tdmpc2_tpu_torch.envs import make_env
from tdmpc2_tpu_torch.envs.base import NormalizeInfo, Timeout
from tdmpc2_tpu_torch.envs.dmcontrol import PixelObs
from tdmpc2_tpu_torch.envs.toy import PointMassEnv
from tdmpc2_tpu_torch.interop import load_blob, params_from_jax, state_from_jax
from tdmpc2_tpu_torch.models import layers as tl
from tdmpc2_tpu_torch.tdmpc2 import TDMPC2
from tdmpc2_tpu_torch.trainer.online import OnlineTrainer
from tdmpc2_tpu_torch.utils import tree
from tdmpc2_tpu_torch.utils.logger import Logger
from test_torch_planner import _jax_plan_noise
from test_torch_train import _hold_states, _noise_from_jax
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
PIX_FILE = ROOT / 'tests/data/pixel_observations.npz'
WALKER = ROOT / 'results/checkpoints/walker-walk-rgb-s1.pkl.gz'
ENC = dict(rtol=1e-4, atol=1e-4)
VTOL = dict(rtol=1e-4, atol=1e-4)
ATOL = dict(rtol=1e-3, atol=1e-3)
SHAPE = (9, 64, 64)
SMALL = dict(task='toy-reach', obs='rgb', batch_size=4, num_channels=4,
             latent_dim=64, mlp_dim=32, enc_dim=32, num_q=2, num_bins=5,
             num_samples=16, num_elites=4, num_pi_trajs=2, iterations=2,
             horizon=3, buffer_size=200, steps=200)


def _cfgs(**kw):
    """JAX and port configs of a small pixel model (64 px, 4 channels)."""
    out = []
    for c in (jparse(JConfig(**{**SMALL, **kw})),
              parse_cfg(Config(**{**SMALL, **kw}, device='cpu'))):
        c.obs_shape, c.action_dim, c.episode_length = {'rgb': SHAPE}, 2, 50
        out.append(c)
    out[0].buffer_device = 'device'      # no trial allocation here
    return out


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in this module: the convs' parallel
    regions oversubscribe the cores when the suite runs several workers
    (a pixel trainer run took 75x its time alone), and the results do not
    depend on it beyond the tolerances held."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def jax_agent():
    """The JAX agent of the small pixel config, shared (its tests read its
    state and jit its methods; none changes it)."""
    jcfg, _ = _cfgs()
    return jcfg, JTDMPC2(jcfg)


@pytest.fixture(scope='module')
def frames():
    """[65, 9, 64, 64] uint8: the trained walker agent's observations."""
    with np.load(PIX_FILE) as d:
        return d['walker-walk/obs']


@pytest.fixture(scope='module')
def walker_conv():
    """The committed walker-walk-rgb checkpoint's conv encoder (HWIO)."""
    return load_blob(WALKER)['model']['encoder']['rgb']


def _t(x):
    return torch.from_numpy(np.array(x))


def _nchw(x_nhwc):
    return np.asarray(x_nhwc).transpose(0, 3, 1, 2)


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **tol)


# ------------------------------------------------------------ layers


def test_pixel_preprocess_and_conv_output_dim():
    x = np.random.default_rng(0).integers(0, 256, (2, 9, 8, 8), dtype=np.uint8)
    np.testing.assert_array_equal(tl.pixel_preprocess(_t(x)).numpy(),
                                  np.asarray(jl.pixel_preprocess(x)))
    for h, ch in ((64, 32), (64, 4), (32, 4), (48, 4)):
        assert tl.conv_output_dim(h, h, ch) == jl.conv_output_dim(h, h, ch)
    assert tl.conv_output_dim(64, 64, 32) == 512 and tl.conv_output_dim(32, 32, 4) == 0


@pytest.mark.parametrize('source', ['recorded', 'random'])
def test_shift_aug_matches_jax(frames, source):
    """JAX's shifts (randint(key, (N, 2), 0, 7), layers.py:229) fed to the
    port: the same crops bit for bit, every shift from 0 to 6 among them."""
    x = (np.concatenate([frames, frames[:63]]) if source == 'recorded' else
         np.random.default_rng(1).integers(0, 256, (128, 9, 16, 12), dtype=np.uint8))
    key = jax.random.PRNGKey(5)
    shifts = np.asarray(jax.random.randint(key, (x.shape[0], 2), 0, 7))
    assert set(shifts.ravel().tolist()) == set(range(7))
    ref = _nchw(jl.shift_aug(key, x.transpose(0, 2, 3, 1)))
    got = tl.shift_aug(_t(x), _t(shifts))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize('shifted', [False, True])
def test_conv_encoder_on_walker_checkpoint(frames, walker_conv, shifted):
    """The trained walker conv encoder on the recorded frames, at 1e-4."""
    key = jax.random.PRNGKey(2) if shifted else None
    ref = jl.conv_encoder_apply(walker_conv, frames, 8, key=key)
    shifts = (_t(jax.random.randint(key, (frames.shape[0], 2), 0, 7))
              if shifted else None)
    got = tl.conv_encoder_apply(params_from_jax(walker_conv), _t(frames), 8, shifts)
    assert got.shape == (frames.shape[0], 512)
    _close(got, ref, ENC)


@pytest.mark.parametrize('rank', [4, 5])
def test_encode_matches_jax(frames, jax_agent, rank):
    """[B, C, H, W] with one shift draw, and [T, B, C, H, W] with one key a
    time step (world_model.py:139-143); without shifts too."""
    jcfg, jag = jax_agent
    _, tcfg = _cfgs()
    jparams = jag.state.params
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    obs = frames[:12] if rank == 4 else frames[:12].reshape(4, 3, *SHAPE)
    key = jax.random.PRNGKey(4)
    if rank == 4:
        shifts = jax.random.randint(key, (12, 2), 0, 7)
    else:
        shifts = jnp.stack([jax.random.randint(k, (3, 2), 0, 7)
                            for k in jax.random.split(key, 4)])
    jm, tm = jag.model, TDMPC2(tcfg).model
    got = tm.encode(tparams, _t(obs), shifts=_t(shifts))
    assert got.shape == obs.shape[:rank - 3] + (64,)
    _close(got, jm.encode(jparams, obs, key=key), ENC)
    _close(tm.encode(tparams, _t(obs)), jm.encode(jparams, obs), ENC)


def test_latent_must_equal_the_conv_output():
    _, tcfg = _cfgs(latent_dim=32)
    with pytest.raises(ValueError, match='conv encoder output 64'):
        TDMPC2(tcfg)


# ------------------------------------------------------------ agent


def test_pixel_update_matches_jax(frames, jax_agent):
    """Five `_update` steps on a batch of recorded frames, from one JAX
    state: losses, norms, parameters (the conv's among them), targets and
    every Adam moment at 1e-4."""
    jcfg, jag = jax_agent
    tag = TDMPC2(_cfgs()[1])
    T, B = jcfg.horizon, jcfg.batch_size
    rng = np.random.default_rng(6)
    rows = rng.integers(0, len(frames) - T, B)[None] + np.arange(T + 1)[:, None]
    batch = (frames[rows], rng.uniform(-1, 1, (T, B, 2)).astype(np.float32),
             rng.uniform(0, 1, (T, B, 1)).astype(np.float32),
             np.zeros((T, B, 1), np.float32))
    jstate = jag.state
    tstate = state_from_jax(jstate)
    upd = jax.jit(jag._update)
    for step in range(5):
        noise = _noise_from_jax(jstate.key, jcfg)
        assert noise.next_shift.shape == (T, B, 2) and noise.shift0.shape == (B, 2)
        jstate, jinfo = upd(jstate, *batch)
        tinfo = tag._update(tstate, *(torch.from_numpy(x) for x in batch), noise)
        assert set(tinfo) == set(jinfo)
        for k in tinfo:
            np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]), **ENC,
                                       err_msg=f'step {step}: {k}')
        _hold_states(tstate, state_from_jax(jstate), ENC)
    assert int(tstate.opt_state['enc']['count']) == 5


@pytest.mark.parametrize('seed,eval_mode', [(7, True), (8, False)])
def test_pixel_plan_matches_jax(frames, jax_agent, seed, eval_mode):
    """One plan on recorded frames with JAX's draws, the shift among them:
    means at 1e-4, the action at 1e-3."""
    jcfg, jag = jax_agent
    tag = TDMPC2(_cfgs()[1])
    jp = jax.tree.map(lambda x: x + 0.05 * jnp.sin(jnp.arange(x.size).reshape(x.shape)),
                      jag.state.params)
    tag.load_params(params_from_jax(jax.tree.map(np.asarray, jp)))
    obs = frames[seed:seed + 1]
    kp, key = jax.random.split(jax.random.PRNGKey(seed))
    prev_mean = 0.1 * jax.random.normal(kp, (jcfg.horizon, 2))
    a_ref, mean_ref, _ = jax.jit(partial(jag._plan, eval_mode=eval_mode, fused=False))(
        jp, obs, prev_mean, jnp.asarray(False), key, None)
    tag.prev_mean = torch.from_numpy(np.array(prev_mean))[None]
    noise = _jax_plan_noise(key, jcfg, jag.iterations)
    assert noise.shift.shape == (1, 2)
    a, mean = tag.plan_vec(_t(obs), np.array([False]), eval_mode=eval_mode, noise=noise)
    _close(mean[0], mean_ref, VTOL)
    _close(a[0], a_ref, ATOL)


def test_act_sends_frames_as_uint8(frames, monkeypatch):
    """`act` keeps a frame stack uint8 up to the encoder, draws a shift per
    env (also with mpc=false, and in eval mode), and takes one stack or n."""
    _, tcfg = _cfgs(num_envs=3)
    ag = TDMPC2(tcfg)
    seen = []
    encode = ag.model.encode

    def recording(params, obs, task=None, shifts=None):
        seen.append((obs.dtype, tuple(obs.shape), None if shifts is None
                     else tuple(shifts.shape)))
        return encode(params, obs, task, shifts)
    monkeypatch.setattr(ag.model, 'encode', recording)
    assert ag.act(frames[0], t0=True, eval_mode=True).shape == (2,)
    assert ag.act(frames[:3], t0=True).shape == (3, 2)
    ag.cfg.mpc = False
    assert ag.act(frames[:2], eval_mode=True).shape == (2, 2)
    assert seen == [(torch.uint8, (1,) + SHAPE, (1, 2)), (torch.uint8, (3,) + SHAPE, (3, 2)),
                    (torch.uint8, (2,) + SHAPE, (2, 2))]
    # a plan's noise without shifts is refused, not planned unshifted
    noise = ag.draw_noise(1)
    assert noise.shift.shape == (1, 2) and noise.shift.dtype == torch.long
    noise.shift = None
    with pytest.raises(ValueError, match='ShiftAug'):
        ag.plan_vec(_t(frames[:1]), np.array([True]), noise=noise)


# ------------------------------------------------------------ buffer


def _pixel_episodes(rng, n, rows, valid=None):
    """n episodes of stacks [rows, 9, 16, 16] built as PixelObs builds them
    (oldest frame first, the reset frame repeated), uint8."""
    f = rng.integers(0, 256, (n, rows, 3, 16, 16), dtype=np.uint8)
    idx = np.clip(np.arange(rows)[:, None] + np.arange(-2, 1)[None], 0, None)
    obs = f[:, idx].reshape(n, rows, 9, 16, 16)
    eps = dict(obs=obs, action=rng.uniform(-1, 1, (n, rows, 2)).astype(np.float32),
               reward=rng.uniform(size=(n, rows)).astype(np.float32),
               terminated=np.zeros((n, rows), np.float32))
    for k in ('action', 'reward', 'terminated'):
        eps[k][:, 0] = np.nan
    eps['valid_rows'] = np.full(n, rows) if valid is None else np.asarray(valid)
    return eps, f


@pytest.mark.parametrize('write', ['add', 'load'])
def test_buffer_unstacks_and_restacks_like_jax(write, monkeypatch):
    """The same pixel episodes (one short) into both buffers: the same flat
    uint8 storage; then the slices at the same (episode, start) pairs, the
    starts 0 and 1 among them (rows clipped at 0 replicate the reset frame),
    bit for bit against JAX's restack and against the episodes' stacks."""
    jcfg, tcfg = _cfgs(batch_size=6)
    for c in (jcfg, tcfg):
        c.obs_shape, c.episode_length = {'rgb': (9, 16, 16)}, 20
    eps, _ = _pixel_episodes(np.random.default_rng(3), 4, 21, valid=[21, 21, 12, 21])
    jbuf, tbuf = JBuffer(jcfg), Buffer(tcfg)
    for buf in (jbuf, tbuf):
        if write == 'add':
            for i in range(4):
                buf.add({k: v[i] for k, v in eps.items()})
        else:
            buf.load(dict(eps))
    stored = tbuf._storage['obs']
    assert stored.dtype == torch.uint8 and stored.shape == (10, 21, 3 * 16 * 16)
    np.testing.assert_array_equal(stored.numpy(), np.asarray(jbuf._storage['obs']))
    # the newest frame of each stack, flat
    np.testing.assert_array_equal(stored[:4].numpy(),
                                  eps['obs'][:, :, 6:].reshape(4, 21, -1))
    ep_idx = np.array([0, 1, 2, 3, 0, 1], np.int32)
    start = np.array([0, 1, 8, 17, 5, 2], np.int32)
    monkeypatch.setattr(jbuf, '_draw_slices_device',
                        lambda *a: (jnp.asarray(ep_idx), jnp.asarray(start)))
    names = sorted(jbuf._storage)
    ref = jbuf._sample_device({k: jbuf._storage[k] for k in names}, jbuf._ep_rows,
                              None, np.int32(4), np.int32(0))
    got = tbuf.gather(torch.from_numpy(ep_idx).long(), torch.from_numpy(start).long())
    assert got[0].dtype == torch.uint8 and got[0].shape == (4, 6, 9, 16, 16)
    for g, r in zip(got, ref[:4]):
        np.testing.assert_array_equal(g.numpy().astype(np.float32), np.asarray(r))
    rows = start[None] + np.arange(4)[:, None]
    np.testing.assert_array_equal(got[0].numpy(), eps['obs'][ep_idx[None], rows])
    n = tbuf.sample_many(3)[0]
    assert n.dtype == torch.uint8 and n.shape == (3, 4, 6, 9, 16, 16)


# ------------------------------------------------------------ envs


def test_pixel_obs_frames_match_jax():
    """PixelObs(PointMassEnv) in both packages over an episode: channel-first
    uint8 stacks, the reset frame three times, bit for bit."""
    env = NormalizeInfo(Timeout(PixelObs(PointMassEnv(seed=4)), 50))
    jenv = JNormalizeInfo(JTimeout(JPixelObs(JPointMassEnv(seed=4)), 50))
    assert env.observation_space.shape == jenv.observation_space.shape == SHAPE
    o, jo = env.reset(), jenv.reset()
    assert o.dtype == np.uint8 and np.array_equal(o[:3], o[6:])
    np.testing.assert_array_equal(o, jo)
    rng, done = np.random.default_rng(0), False
    while not done:
        a = rng.uniform(-1, 1, 2).astype(np.float32)
        (o, r, done, info), (jo, jr, jdone, jinfo) = env.step(a), jenv.step(a)
        np.testing.assert_array_equal(o, jo)
        assert (r, done, info) == (jr, jdone, jinfo)
    assert o.any()


@pytest.mark.parametrize('task,num_envs,why', [
    ('toy-reach', 1, 'no rgb mode'), ('toy-reach', 4, 'no rgb mode'),
    ('toy', 1, 'no rgb mode'), ('toy-reach-episodic', 1, 'no rgb mode'),
    ('toy-reach-episodic', 4, 'no rgb mode'),
    pytest.param('walker-walk', 1, None, id='walker-walk-1-A11'),
    pytest.param('walker-walk', 4, None, id='walker-walk-4-A11'),
    pytest.param('mt30', 1, None, id='mt30-1-A11')])
def test_make_env_refuses_rgb(task, num_envs, why):
    """A toy task has state observations only: `make_env` refuses rgb there
    (a pixel env, PixelObs around an env that renders, goes to a trainer).
    The dm_control tasks render (ROADMAP A11): where dm_control imports,
    walker-walk (one env, and 4 worker-process copies) and mt30 build with
    rgb observations and the config fields the JAX factory gives them;
    where it does not, the factory's error names it."""
    cfg = parse_cfg(Config(task=task, obs='rgb', num_envs=num_envs, device='cpu'))
    if why is not None:
        with pytest.raises(ValueError, match=why):
            make_env(cfg)
        return
    try:
        import dm_control  # noqa: F401
    except ImportError:
        with pytest.raises(ValueError, match='Failed to make environment.*dm_control'):
            make_env(cfg)
        return
    from tdmpc2_tpu.envs import make_env as jmake_env
    jcfg = jparse(JConfig(task=task, obs='rgb', num_envs=num_envs))
    env, jenv = make_env(cfg), jmake_env(jcfg)
    try:
        fields = ('obs_shape', 'action_dim', 'episode_length', 'seed_steps')
        fields += ('obs_shapes', 'action_dims', 'episode_lengths') if task == 'mt30' else ()
        assert {k: cfg.get(k) for k in fields} == {k: jcfg.get(k) for k in fields}
        if task == 'walker-walk':
            assert cfg.obs_shape == {'rgb': SHAPE}
            assert getattr(env, 'num_envs', 1) == num_envs
            np.testing.assert_array_equal(env.reset(), jenv.reset())
    finally:
        for e in (env, jenv):
            if hasattr(e, 'close'):
                e.close()


# ------------------------------------------------------------ trainer


def test_pixel_online_trainer_runs(tmp_path):
    """The port's OnlineTrainer on NormalizeInfo(Timeout(PixelObs(point
    mass))) with 12-step episodes: the 12-update burst and 4 planned steps
    with finite losses, the ring uint8 [eps, rows, 3*64*64], and an eval
    episode."""
    _, cfg = _cfgs(steps=16, save_agent=False, save_csv=False, eval_freq=1000,
                   eval_episodes=1)
    cfg.work_dir, cfg.seed_steps, cfg.episode_length = str(tmp_path), 12, 12
    env = NormalizeInfo(Timeout(PixelObs(PointMassEnv(cfg.seed)), 12))
    agent, buf = TDMPC2(cfg), Buffer(cfg)
    infos = []
    update = agent._update

    def recording(*a):
        infos.append(update(*a))
        return infos[-1]
    agent._update = recording
    OnlineTrainer(cfg=cfg, env=env, agent=agent, buffer=buf, logger=Logger(cfg)).train()
    assert len(infos) == 12 + 4
    assert all(np.isfinite(float(v)) for i in infos for v in i.values())
    st = buf._storage['obs']
    assert st.dtype == torch.uint8 and st.shape[1:] == (13, 3 * 64 * 64)
    assert all(x.dtype == torch.float32 for x in tree.leaves(agent.params))
