"""PyTorch port vs the JAX package: checkpoints (CPU).

- the committed full-state checkpoint (hopper-hop, 5M model, Adam count
  1,440,484, scale 15.45) loaded into the JAX agent and into the port:
  equal Adam counts and moments and scale, then one `_update` each on a
  batch of recorded observations with the same draws, at 1e-4;
- both committed checkpoints read by the port in a process where `jax`,
  `optax` and `ml_dtypes` cannot be imported, bit for bit against what the
  JAX package's loader (pickle with those packages) gives, bf16 after its
  upcast to f32; any other class in a pickle is refused;
- a stripped checkpoint (weights only): fresh optimiser states and scale 1
  in both;
- the reference's formats against the JAX package's `torch_interop` on the
  same synthetic state dicts and TensorDict chunk: new and old API keys,
  the normed-linear forward, the architecture mismatch, a state dict
  passed as a dict and as a `.pt` file, the chunk read, a pixel model's
  conv encoder (OIHW to HWIO); an Orbax directory raises;
- the committed full pixel train state (walker-walk-rgb, conv encoder) in
  both: equal Adam states, then one `_update` at 1e-4 on a batch of 32
  slices of the recorded walker frames;
- the port's own round trip: the train state and both generators (agent
  and buffer), whose next draws are equal.
"""

import gzip
import pickle
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tdmpc2_tpu.config import Config as JConfig, parse_cfg as jparse
from tdmpc2_tpu.models.layers import normed_linear_apply
from tdmpc2_tpu.models.world_model import WorldModel as JWorldModel
from tdmpc2_tpu.tdmpc2 import TDMPC2 as JTDMPC2
from tdmpc2_tpu.utils import torch_interop as jti
from tdmpc2_tpu_torch.config import Config, parse_cfg
from tdmpc2_tpu_torch.data.buffer import Buffer
from tdmpc2_tpu_torch.interop import load_blob, state_from_jax
from tdmpc2_tpu_torch.models.layers import normed_linear
from tdmpc2_tpu_torch.tdmpc2 import TDMPC2, UpdateNoise
from tdmpc2_tpu_torch.utils import torch_interop as tti
from tdmpc2_tpu_torch.utils import tree

ROOT = Path(__file__).resolve().parent.parent
FULL = ROOT / 'results/checkpoints/full/hopper-hop-s1-r5.pkl.gz'
STRIPPED = ROOT / 'results/checkpoints/acrobot-swingup-s1.pkl.gz'
FULL_RGB = ROOT / 'results/checkpoints/full/walker-walk-rgb-s1-r4px3.pkl.gz'
OBS_FILE = ROOT / 'tests/data/observations.npz'
PIX_FILE = ROOT / 'tests/data/pixel_observations.npz'
UPD = dict(rtol=1e-4, atol=1e-4)
B = 32                           # update batch (not part of the architecture)
BLOCKED = ('jax', 'jaxlib', 'optax', 'ml_dtypes')


def _cfgs(task, obs_dim, act_dim, **kw):
    """JAX and port configs of the default 5M model for a dm_control task,
    its dims set as the checkpoints record them (no env is built)."""
    out = []
    for c in (jparse(JConfig(task=task, batch_size=B, **kw)),
              parse_cfg(Config(task=task, batch_size=B, device='cpu', **kw))):
        c.obs_shape, c.action_dim, c.episode_length = {'state': (obs_dim,)}, act_dim, 1000
        out.append(c)
    return out


@pytest.fixture(scope='module')
def jax_blobs():
    """The JAX package's reading of each committed checkpoint: gzip and
    pickle, with ml_dtypes and optax (tdmpc2_tpu/tdmpc2.py:295-301)."""
    out = {}
    for fp in (FULL, STRIPPED):
        with gzip.open(fp, 'rb') as f:
            out[fp.name] = pickle.load(f)
    return out


def _hold_tree(got, ref, path='blob'):
    """Equal structure (namedtuples by class name), equal values, arrays
    bit for bit, bf16 after its upcast to f32."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), path
        for k in ref:
            _hold_tree(got[k], ref[k], f'{path}/{k}')
    elif isinstance(ref, tuple):
        assert type(got).__name__ == type(ref).__name__, (path, type(got), type(ref))
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            _hold_tree(a, b, f'{path}[{i}]')
    elif isinstance(ref, np.ndarray):
        if ref.dtype.name == 'bfloat16':
            ref = ref.astype(np.float32)
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        assert got.tobytes() == ref.tobytes(), path
    else:
        assert type(got) is type(ref) and got == ref, (path, got, ref)


# ------------------------------------------------- the JAX train state's fault


def _noise_from_jax(key, cfg):
    """The draws JAX `_update` makes from `key` (tdmpc2.py:933-949), the
    pixel encoder's shifts among them on an rgb config."""
    T, N, M, A = cfg.horizon, cfg.num_q, cfg.mlp_dim, cfg.action_dim
    (_, k_enc_next, k_td, k_enc0, k_drop, k_pi_upd, k_pi_q, k_pi_drop,
     _) = jax.random.split(key, 9)
    k_pi, k_q = jax.random.split(k_td)

    def keep(k, rows):
        return torch.from_numpy(np.stack([
            np.asarray(jax.random.bernoulli(km, 1.0 - cfg.dropout, (rows, B, M)))
            for km in jax.random.split(k, N)]))

    def qpair(k):
        return torch.from_numpy(np.array(jax.random.permutation(k, N)[:2])).long()

    def normal(k, shape):
        return torch.from_numpy(np.array(jax.random.normal(k, shape), np.float32))

    def shifts(k):
        return torch.from_numpy(np.array(jax.random.randint(k, (B, 2), 0, 7))).long()
    rgb = cfg.obs == 'rgb'
    return UpdateNoise(
        td_eps=normal(k_pi, (T, B, A)), td_qidx=qpair(k_q),
        q_keep=keep(k_drop, T), pi_eps=normal(k_pi_upd, (T + 1, B, A)),
        pi_qidx=qpair(k_pi_q), pi_keep=keep(k_pi_drop, T + 1),
        next_shift=(torch.stack([shifts(k) for k in jax.random.split(k_enc_next, T)])
                    if rgb else None),
        shift0=shifts(k_enc0) if rgb else None)


def recorded_batch(task, horizon, batch, seed):
    """A batch of `batch` slices of horizon+1 rows from the recorded
    trajectory of `task` (tests/data/observations.npz), in the update's
    layout: obs [T+1, B, obs], action [T, B, A], reward and terminated
    [T, B, 1]."""
    with np.load(OBS_FILE) as d:
        obs, act, rew = (d[f'{task}/{k}'] for k in ('obs', 'action', 'reward'))
    starts = np.random.default_rng(seed).integers(0, len(act) - horizon, batch)
    rows = starts[None] + np.arange(horizon + 1)[:, None]        # [T+1, B]
    return (obs[rows], act[rows[:-1]], rew[rows[:-1]][..., None],
            np.zeros((horizon, batch, 1), np.float32))


def _hold_states(got, ref, tol):
    for name in ('params', 'target_Qs', 'opt_state', 'pi_opt_state', 'scale'):
        g, r = tree.leaves(getattr(got, name)), tree.leaves(getattr(ref, name))
        assert len(g) == len(r), name
        for a, b in zip(g, r):
            assert a.shape == b.shape and a.dtype == b.dtype, name
            np.testing.assert_allclose(a.numpy(), b.numpy(), **tol, err_msg=name)


def test_full_checkpoint_update_matches_jax(jax_blobs):
    """The port's `load` carries a JAX train state's Adam states and scale
    (the policy loss divides Q by the scale), so its first update after the
    load is the JAX agent's."""
    jcfg, tcfg = _cfgs('hopper-hop', 15, 4)
    jag, tag = JTDMPC2(jcfg), TDMPC2(tcfg)
    jag.load(jax_blobs[FULL.name])
    assert tag.load(FULL) == {'step': 1450008, 'ep_idx': 1064}
    jstate = jag.state
    _hold_states(tag.state, state_from_jax(jstate), dict(rtol=0, atol=0))
    assert int(tag.state.opt_state['enc']['count']) == 1440484
    assert int(tag.state.pi_opt_state['count']) == 1440484
    assert abs(float(tag.state.scale) - 15.452264) < 1e-5
    batch = tuple(x.astype(np.float32) for x in
                  recorded_batch('hopper-hop', jcfg.horizon, B, 12))
    noise = _noise_from_jax(jstate.key, jcfg)
    jstate, jinfo = jax.jit(jag._update)(jstate, *batch)
    tinfo = tag._update(tag.state, *(torch.from_numpy(x) for x in batch), noise)
    assert set(tinfo) == set(jinfo)
    for k in tinfo:
        np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]), **UPD,
                                   err_msg=k)
    assert float(tinfo['pi_scale']) > 10.0
    _hold_states(tag.state, state_from_jax(jstate), UPD)


def test_full_pixel_checkpoint_update_matches_jax():
    """The committed full walker-walk-rgb train state (conv encoder, Adam
    states, scale) in both packages, then one `_update` each on 32 slices
    of the recorded walker frames with the same draws (ShiftAug's among
    them), at 1e-4. One diagnostic has a wider band: `pi_entropy`, the
    policy's entropy with its squash term log(1 - tanh(u)^2 + 1e-6), which
    the trained walker policy saturates, so one f32 step of tanh(u) next to
    1 (6e-8) moves the log's argument by several percent of its 1e-6 floor;
    it enters no loss (the loss takes `pi_scaled_entropy`, held at 1e-4)
    and is held at 1e-3 of its value."""
    jcfg, tcfg = (parse(Cfg(task='walker-walk', obs='rgb', batch_size=B, **kw))
                  for parse, Cfg, kw in ((jparse, JConfig, {}),
                                         (parse_cfg, Config, {'device': 'cpu'})))
    for c in (jcfg, tcfg):
        c.obs_shape, c.action_dim, c.episode_length = {'rgb': (9, 64, 64)}, 6, 500
    with gzip.open(FULL_RGB, 'rb') as f:
        jblob = pickle.load(f)
    jag, tag = JTDMPC2(jcfg), TDMPC2(tcfg)
    jag.load(jblob)
    assert tag.load(FULL_RGB) == jblob['extra']
    jstate = jag.state
    _hold_states(tag.state, state_from_jax(jstate), dict(rtol=0, atol=0))
    assert int(tag.state.opt_state['enc']['count']) > 0
    assert tag.params['encoder']['rgb'][0]['w'].shape == (7, 7, 9, 32)
    with np.load(PIX_FILE) as d:
        obs, act, rew = (d[f'walker-walk/{k}'] for k in ('obs', 'action', 'reward'))
    T = jcfg.horizon
    rows = (np.random.default_rng(12).integers(0, len(act) - T, B)[None]
            + np.arange(T + 1)[:, None])
    batch = (obs[rows], act[rows[:-1]], rew[rows[:-1]][..., None],
             np.zeros((T, B, 1), np.float32))
    noise = _noise_from_jax(jstate.key, jcfg)
    jstate, jinfo = jax.jit(jag._update)(jstate, *batch)
    # one intra-op thread: the convs' parallel regions oversubscribe the
    # cores when the suite runs several workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tinfo = tag._update(tag.state, *(torch.from_numpy(x) for x in batch), noise)
    finally:
        torch.set_num_threads(threads)
    assert set(tinfo) == set(jinfo)
    for k in tinfo:
        np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]), err_msg=k,
                                   **(dict(rtol=1e-3, atol=0) if k == 'pi_entropy'
                                      else UPD))
    _hold_states(tag.state, state_from_jax(jstate), UPD)


def test_stripped_checkpoint_keeps_fresh_optimiser_states(jax_blobs):
    """Weights only: both agents keep fresh Adam states and scale 1."""
    jcfg, tcfg = _cfgs('acrobot-swingup', 6, 1)
    jag, tag = JTDMPC2(jcfg), TDMPC2(tcfg)
    jag.load(jax_blobs[STRIPPED.name])
    assert tag.load(STRIPPED) == {'step': 400000, 'ep_idx': 768}
    _hold_states(tag.state, state_from_jax(jag.state), dict(rtol=0, atol=0))
    assert int(tag.state.opt_state['rest']['count']) == 0
    assert float(tag.state.scale) == 1.0


# ------------------------------------------- reading without jax, optax, ml_dtypes

_READ = f'''
import importlib, pickle, sys
BLOCKED = {BLOCKED!r}

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError(f'{{name}} is blocked here')
        return None

sys.meta_path.insert(0, Blocker())
for m in BLOCKED:
    try:
        importlib.import_module(m)
    except ImportError:
        pass
    else:
        raise SystemExit(f'{{m}} imported past the blocker')
from tdmpc2_tpu_torch.interop import load_blob
blobs = {{fp: load_blob(fp) for fp in sys.argv[2:]}}
bad = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
assert not bad, bad
with open(sys.argv[1], 'wb') as f:
    pickle.dump(blobs, f)
'''


@pytest.fixture(scope='module')
def blobs_without_jax(tmp_path_factory):
    """Both committed checkpoints as the port reads them in a process where
    jax, optax and ml_dtypes cannot be imported."""
    out = tmp_path_factory.mktemp('read') / 'blobs.pkl'
    subprocess.run([sys.executable, '-c', _READ, str(out), str(FULL), str(STRIPPED)],
                   cwd=ROOT, check=True, timeout=120)
    with open(out, 'rb') as f:
        return pickle.load(f)


@pytest.mark.parametrize('fp', [FULL, STRIPPED], ids=lambda p: p.name)
def test_reads_checkpoints_without_jax(fp, jax_blobs, blobs_without_jax):
    _hold_tree(blobs_without_jax[str(fp)], jax_blobs[fp.name])


class _Evil:
    def __reduce__(self):
        return (print, ('this runs while unpickling',))


@pytest.mark.parametrize('payload', ['callable', 'class'])
def test_load_blob_refuses_other_classes(payload, tmp_path):
    obj = _Evil() if payload == 'callable' else {'x': types.SimpleNamespace(a=1)}
    fp = tmp_path / 'bad.pkl'
    fp.write_bytes(pickle.dumps(obj))
    with pytest.raises(pickle.UnpicklingError, match='may not name'):
        load_blob(fp)


@pytest.mark.parametrize('core', ['numpy.core', 'numpy._core'])
def test_load_blob_reads_numpy1_and_numpy2_names(core, tmp_path):
    """numpy 1 pickles name numpy.core.multiarray, numpy 2 numpy._core:
    either is read, whatever the installed numpy, Fortran order too."""
    arrays = {'f': np.arange(6, dtype=np.float32).reshape(2, 3),
              'i': np.asfortranarray(np.arange(6, dtype=np.int64).reshape(3, 2))}
    raw = pickle.dumps(arrays, protocol=3)      # module names as text
    for name in (b'numpy.core.multiarray', b'numpy._core.multiarray'):
        raw = raw.replace(name, core.encode() + b'.multiarray')
    assert core.encode() + b'.multiarray' in raw
    fp = tmp_path / 'arrays.pkl'
    fp.write_bytes(raw)
    got = load_blob(fp)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v)


# ------------------------------------------------------- the reference's formats

OBS, ACT = 10, 4


def _ref_cfgs(**kw):
    out = []
    for c in (jparse(JConfig(task='toy')), parse_cfg(Config(task='toy', device='cpu'))):
        c.obs_shape, c.action_dim, c.episode_length = {'state': (OBS,)}, ACT, 20
        c.enc_dim, c.mlp_dim, c.latent_dim, c.num_q, c.batch_size = 64, 64, 32, 3, 16
        for k, v in kw.items():
            setattr(c, k, v)
        out.append(c)
    return out


def _torch_mlp_sd(prefix, dims, gen, sd, final_normed=False):
    """Reference-style keys of one MLP head (reference layers.py:121-133)."""
    n = len(dims) - 1
    for i in range(n):
        out_d, in_d = dims[i + 1], dims[i]
        sd[f'{prefix}.{i}.weight'] = torch.randn(out_d, in_d, generator=gen) * 0.1
        sd[f'{prefix}.{i}.bias'] = torch.randn(out_d, generator=gen) * 0.1
        if i < n - 1 or final_normed:
            sd[f'{prefix}.{i}.ln.weight'] = torch.rand(out_d, generator=gen) + 0.5
            sd[f'{prefix}.{i}.ln.bias'] = torch.randn(out_d, generator=gen) * 0.1


def build_reference_sd(cfg, old_api=False, seed=0, obs_dim=OBS):
    """A reference-format WorldModel state dict with cfg's geometry, seeded
    (tests/test_interop.py's layout): normed layers, the stacked Q
    ensemble, target heads 0.01 off, and the old API's flat Q keys on
    request."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    D, A, M = cfg.latent_dim, cfg.action_dim, cfg.mlp_dim
    nb = max(cfg.num_bins, 1)
    enc = [obs_dim] + max(cfg.num_enc_layers - 1, 1) * [cfg.enc_dim] + [D]
    _torch_mlp_sd('_encoder.state', enc, gen, sd, final_normed=True)
    _torch_mlp_sd('_dynamics', [D + A, M, M, D], gen, sd, final_normed=True)
    _torch_mlp_sd('_reward', [D + A, M, M, nb], gen, sd)
    _torch_mlp_sd('_pi', [D, M, M, 2 * A], gen, sd)
    q_dims = [D + A, M, M, nb]
    for li in range(3):
        out_d, in_d = q_dims[li + 1], q_dims[li]
        sd[f'_Qs.params.{li}.weight'] = torch.randn(
            cfg.num_q, out_d, in_d, generator=gen) * 0.1
        sd[f'_Qs.params.{li}.bias'] = torch.randn(cfg.num_q, out_d, generator=gen) * 0.1
        if li < 2:
            sd[f'_Qs.params.{li}.ln.weight'] = torch.rand(
                cfg.num_q, out_d, generator=gen) + 0.5
            sd[f'_Qs.params.{li}.ln.bias'] = torch.randn(
                cfg.num_q, out_d, generator=gen) * 0.1
        for k in ('weight', 'bias', 'ln.weight', 'ln.bias'):
            if f'_Qs.params.{li}.{k}' in sd:
                sd[f'_target_Qs_params.{li}.{k}'] = sd[f'_Qs.params.{li}.{k}'] + (
                    0.01 if k == 'weight' else 0.0)
    sd['log_std_min'] = torch.tensor(float(cfg.log_std_min))
    sd['log_std_dif'] = torch.tensor(float(cfg.log_std_max) - float(cfg.log_std_min))
    if old_api:
        # the pre-torch.compile flat scheme (layers.py:171-192)
        names = ['weight', 'bias', 'ln.weight', 'ln.bias']
        flat = {}
        for k, v in sd.items():
            for pre, new in (('_Qs.params.', '_Qs.params.'),
                             ('_target_Qs_params.', '_target_Qs.params.')):
                if k.startswith(pre):
                    li, kind = k[len(pre):].split('.', 1)
                    flat[f'{new}{4 * int(li) + names.index(kind)}'] = v
                    break
            else:
                flat[k] = v
        sd = flat
    return sd


def _equal_trees(got, ref):
    g, r = tree.leaves(got), jax.tree.leaves(ref)
    assert len(g) == len(r)
    for a, b in zip(g, r):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize('api', ['new', 'old'])
def test_reference_state_dict_conversion_matches_jax(api):
    jcfg, _ = _ref_cfgs()
    sd = build_reference_sd(jcfg, old_api=api == 'old', seed=3)
    got = tti.convert_reference_state_dict(dict(sd))
    ref = jti.convert_reference_state_dict(dict(sd))
    for g, r in zip(got, ref):
        _equal_trees(g, r)
    # the targets come from _target_Qs_params, not from the Q heads
    assert not np.array_equal(got[1][0]['w'], got[0]['Qs'][0]['w'])


def test_converted_normed_linear_matches_torch_and_jax():
    """A torch Linear + LayerNorm + Mish block against the port's and the
    JAX package's normed linear on the converted parameters."""
    jcfg, _ = _ref_cfgs()
    sd = build_reference_sd(jcfg)
    params, _ = tti.convert_reference_state_dict(dict(sd))
    x = torch.randn(7, jcfg.latent_dim + jcfg.action_dim,
                    generator=torch.Generator().manual_seed(9))
    y = torch.nn.functional.linear(x, sd['_dynamics.0.weight'], sd['_dynamics.0.bias'])
    y = torch.nn.functional.layer_norm(y, y.shape[-1:], sd['_dynamics.0.ln.weight'],
                                       sd['_dynamics.0.ln.bias'])
    y = torch.nn.functional.mish(y)
    layer = {k: torch.from_numpy(np.array(v)) for k, v in params['dynamics'][0].items()}
    got = normed_linear(layer, x)
    ref = normed_linear_apply({k: np.asarray(v) for k, v in params['dynamics'][0].items()},
                              x.numpy())
    np.testing.assert_allclose(got.numpy(), y.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize('form', ['dict', 'pt'])
def test_reference_checkpoint_loads_into_agent(form, tmp_path):
    """`load` takes a reference state dict as a dict or as a `.pt` file:
    the JAX package's conversion, the agent's optimiser states and scale
    left as they were, and the agent plans on the weights."""
    jcfg, tcfg = _ref_cfgs(num_samples=64, num_elites=8, num_pi_trajs=8,
                           iterations=2)
    sd = build_reference_sd(jcfg, seed=5)
    ag = TDMPC2(tcfg)
    ag.state.scale.fill_(3.0)
    if form == 'pt':
        fp = tmp_path / 'ref.pt'
        torch.save({'model': sd}, fp)
        assert ag.load(fp) == {}
    else:
        assert ag.load({'model': sd}) == {}
    params, target = jti.convert_reference_state_dict({'model': sd})
    _equal_trees(ag.params, params)
    _equal_trees(ag.state.target_Qs, target)
    assert float(ag.state.scale) == 3.0
    a = ag.act(np.random.default_rng(0).normal(size=OBS).astype(np.float32), t0=True)
    assert a.shape == (ACT,) and np.isfinite(a).all()


@pytest.mark.parametrize('mismatch', ['mlp_dim', 'num_enc_layers'])
def test_reference_architecture_mismatch_raises(mismatch):
    jcfg, tcfg = _ref_cfgs()
    bad, _ = _ref_cfgs(**{mismatch: {'mlp_dim': 128, 'num_enc_layers': 3}[mismatch]})
    sd = build_reference_sd(bad)
    ag = TDMPC2(tcfg)
    for convert, template in ((tti.convert_reference_state_dict, ag.params),
                              (jti.convert_reference_state_dict,
                               JWorldModel(jcfg).init(jax.random.PRNGKey(0)))):
        with pytest.raises(ValueError, match='architecture differs'):
            convert({'model': sd}, template)
    with pytest.raises(ValueError, match='architecture differs'):
        ag.load({'model': sd})


def test_pixel_reference_and_orbax_raise(tmp_path):
    """A pixel model's reference state dict (`_encoder.rgb.{2,4,6,8}`, torch
    OIHW) converts to the JAX package's tree (HWIO), held against a pixel
    agent's shapes, and loads into it; an Orbax directory raises."""
    _, tcfg = _ref_cfgs(obs='rgb', num_channels=2)      # 64 px x 2 -> latent 32
    tcfg.obs_shape = {'rgb': (9, 64, 64)}
    sd = {k: v for k, v in build_reference_sd(tcfg).items()
          if not k.startswith('_encoder.state')}
    gen = torch.Generator().manual_seed(4)
    ch = 9
    for i, k in zip((2, 4, 6, 8), (7, 5, 3, 3)):
        sd[f'_encoder.rgb.{i}.weight'] = torch.randn(2, ch, k, k, generator=gen)
        sd[f'_encoder.rgb.{i}.bias'] = torch.randn(2, generator=gen)
        ch = 2
    ag = TDMPC2(tcfg)
    got = tti.convert_reference_state_dict(dict(sd), ag.params)
    ref = jti.convert_reference_state_dict(dict(sd))
    for g, r in zip(got, ref):
        _equal_trees(g, r)
    assert got[0]['encoder']['rgb'][0]['w'].shape == (7, 7, 9, 2)
    assert ag.load({'model': sd}) == {}
    _equal_trees(ag.params, ref[0])
    with pytest.raises(NotImplementedError, match='orbax'):
        TDMPC2(tcfg).load(tmp_path / 'state.orbax')


class _FakeTensorDict:
    """A TensorDict lookalike pickled under the module name 'tensordict'."""

    def __init__(self, source, batch_size=None):
        self._tensordict = source
        self._batch_size = batch_size


_FakeTensorDict.__module__ = 'tensordict'
_FakeTensorDict.__qualname__ = 'TensorDict'


def fake_tensordict_chunk(fp, n_eps=3, rows=11, obs_dim=OBS, act_dim=ACT, seed=0):
    """torch.save a TensorDict lookalike whose class lives in a module that
    is then removed, as the published chunks' is absent here; returns its
    tensors."""
    gen = torch.Generator().manual_seed(seed)
    mod = types.ModuleType('tensordict')
    mod.TensorDict = _FakeTensorDict
    sys.modules['tensordict'] = mod
    try:
        data = {'obs': torch.randn(n_eps, rows, obs_dim, generator=gen),
                'action': torch.rand(n_eps, rows, act_dim, generator=gen) * 2 - 1,
                'reward': torch.rand(n_eps, rows, generator=gen),
                'task': torch.randint(0, 2, (n_eps, rows), generator=gen)}
        torch.save(_FakeTensorDict(data, batch_size=(n_eps, rows)), fp)
    finally:
        del sys.modules['tensordict']
    return data


def test_read_tensordict_chunk_matches_jax(tmp_path):
    fp = tmp_path / 'chunk_0.pt'
    data = fake_tensordict_chunk(fp)
    got, ref = tti.read_tensordict_chunk(fp), jti.read_tensordict_chunk(fp)
    assert set(got) == set(ref) == {'obs', 'action', 'reward', 'task'}
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
        np.testing.assert_array_equal(got[k], data[k].numpy())


# ----------------------------------------------------------- the port's round trip


def test_save_load_round_trip_with_generators(tmp_path):
    """The train state, the scale and both generators come back bit for bit:
    the loaded agent and buffer draw what the saved ones draw next."""
    _, tcfg = _ref_cfgs(buffer_size=200)
    ag, buf = TDMPC2(tcfg), Buffer(tcfg)
    rng = np.random.default_rng(1)
    for _ in range(3):
        ep = dict(obs=rng.normal(size=(21, OBS)).astype(np.float32),
                  action=rng.uniform(-1, 1, (21, ACT)).astype(np.float32),
                  reward=rng.uniform(size=21).astype(np.float32),
                  terminated=np.zeros(21, np.float32))
        buf.add(ep)
    ag.update(buf)
    ag.draw_noise()                      # the generators moved off their seeds
    fp = tmp_path / 'models' / 'latest.pkl'
    ag.save(fp, extra={'step': 7}, buffer=buf)
    ag2, buf2 = TDMPC2(tcfg), Buffer(tcfg)
    assert ag2.load(fp, buffer=buf2) == {'step': 7}
    _hold_states(ag2.state, ag.state, dict(rtol=0, atol=0))
    for _ in range(3):
        buf2.add(ep)                     # the buffer's generator is made here
    a, b = ag.draw_noise(), ag2.draw_noise()
    assert all(x is y is None or torch.equal(x, y)     # shift: None on state
               for x, y in zip(vars(a).values(), vars(b).values()))
    assert torch.equal(buf.generator.get_state(), buf2.generator.get_state())
