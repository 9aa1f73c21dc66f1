"""PyTorch port vs the JAX package: the bf16 update, `bf16_update=true`
(CPU, tests/test_bf16_update.py's tiny widths).

- the product with bf16 operands and f32 sums against JAX `linear_apply`
  with dtype=bfloat16 (layers.py:110-121): the output, and the operands'
  cotangents, which JAX gives as f32 sums rounded to bf16, then widened;
  the card's `_Bf16Product` wiring, its product replaced by the plain one
  (the card rounds the output's cotangent to bf16 once: equal where the
  cotangent is a bf16 value);
- the conv stack in bf16 against JAX `conv_encoder_apply(dtype=bfloat16)`;
- the port's bf16 `_update` against JAX's bf16 `_update` for five steps
  from one state with JAX's draws (`interop.state_from_jax`), state,
  episodic and conv models;
- the port's bf16 update against its own f32 update under JAX's contract
  (tests/test_bf16_update.py:52-71): each loss within 5% of max(|f32|, 1),
  f32 master weights within 2e-3;
- acting under `bf16_update=true` gives the f32 agent's bits.

Tolerances: 1e-4 (the JAX suite's) for the losses, the parameters, the
target heads and the scale. The gradient norms and the Adam moments are
held at 1e-3: each is a sum over the bf16-rounded cotangents, and the two
packages' f32 sums (torch's and XLA's orders) round a few of those to
neighbouring bf16 values, one bf16 step apart (2^-8 relative); the worst
seen over the five steps was 4.1 times the 1e-4 band (grad_norm, the
episodic model's fourth step). One more
exception: XLA on the CPU sums a bf16 reduction in bf16, each partial sum
rounded (the conv biases' cotangents, a sum over every output pixel), where
torch sums in f32; the conv case's bias Adam moments are held at 1e-1 and
its grad_norm at 1e-2 for that reason, its parameters at 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _cfgs, _hold_states, _noise_from_jax
from tdmpc2_tpu.models import layers as jl
from tdmpc2_tpu.tdmpc2 import TDMPC2 as JTDMPC2
from tdmpc2_tpu_torch.config import load_cfg
from tdmpc2_tpu_torch.interop import state_from_jax
from tdmpc2_tpu_torch.models import layers
from tdmpc2_tpu_torch.tdmpc2 import TDMPC2
from tdmpc2_tpu_torch.utils import tree
from torch_threads import one_torch_thread  # noqa: F401

UPD = dict(rtol=1e-4, atol=1e-4)
GRAD = dict(rtol=1e-3, atol=1e-3)
LOSSES = ('total_loss', 'consistency_loss', 'reward_loss', 'value_loss',
          'pi_loss', 'grad_norm')
OBS, ACT, B = 10, 4, 8


def _bf(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


# ----------------------------------------------------------------- layers


@pytest.mark.parametrize('lead', [(16,), (3, 8)], ids=['rows', 'time-rows'])
def test_bf16_product_and_cotangents_match_jax(lead):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(lead + (40,)).astype(np.float32)
    w = (0.1 * rng.standard_normal((40, 24))).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    g = rng.standard_normal(lead + (24,)).astype(np.float32)

    def jf(x, w):
        return jnp.sum(jl.linear_apply({'w': w, 'b': jnp.asarray(b)}, x,
                                       dtype=jnp.bfloat16) * g)
    y_ref = jl.linear_apply({'w': w, 'b': b}, x, dtype=jnp.bfloat16)
    gx_ref, gw_ref = jax.grad(jf, argnums=(0, 1))(x, w)
    tx, tw = (torch.from_numpy(v).requires_grad_(True) for v in (x, w))
    y = layers.linear({'w': tw, 'b': torch.from_numpy(b)}, tx, torch.bfloat16)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=1e-6, atol=1e-6)
    # each cotangent is a bf16 value; a flip of its rounding is one bf16 step
    for got, ref in ((tx.grad, gx_ref), (tw.grad, gw_ref)):
        got = got.numpy()
        np.testing.assert_array_equal(got, _bf(got))
        np.testing.assert_allclose(got, ref, rtol=2 ** -8, atol=1e-6)


def test_card_product_wiring_on_the_plain_product(monkeypatch):
    """`_Bf16Product` (the card's) with its cuBLAS call replaced by the
    plain f32 product of the bf16 operands: the plain version's output,
    and its cotangents where the output's cotangent is a bf16 value; for
    the member axis (x [n, R, in], w [n, in, out]) too."""
    monkeypatch.setattr(layers, '_mm_f32', lambda a, b: a.float() @ b.float())
    rng = np.random.default_rng(1)
    for xs, ws in (((5, 7, 40), (40, 24)), ((3, 16, 40), (3, 40, 24))):
        x = torch.from_numpy(rng.standard_normal(xs).astype(np.float32))
        w = torch.from_numpy((0.1 * rng.standard_normal(ws)).astype(np.float32))
        g = torch.from_numpy(_bf(rng.standard_normal(xs[:-1] + (24,))))
        outs = []
        for fn in (layers._Bf16Product.apply,
                   lambda a, c: layers.product(a, c, torch.bfloat16)):
            a, c = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
            y = fn(a, c)
            (y * g).sum().backward()
            outs.append((y.detach(), a.grad, c.grad))
        for got, ref in zip(*outs):
            torch.testing.assert_close(got, ref, rtol=2 ** -8, atol=1e-6)


def test_bf16_conv_encoder_matches_jax():
    """The conv stack under bf16 (JAX layers.py:260-284): the latents, and
    the weights' cotangents within one bf16 step."""
    rng = np.random.default_rng(2)
    jp = jl.conv_encoder_init(jax.random.PRNGKey(0), 9, 4)
    tp = tuple({k: torch.from_numpy(np.array(v)).requires_grad_(True)
                for k, v in p.items()} for p in jp)
    x = rng.integers(0, 256, (8, 9, 64, 64)).astype(np.uint8)
    c = (np.arange(64) / 64.0).astype(np.float32)
    ref = jl.conv_encoder_apply(jp, jnp.asarray(x), 8, dtype=jnp.bfloat16)
    got = layers.conv_encoder_apply(tp, torch.from_numpy(x), 8,
                                    dtype=torch.bfloat16)
    np.testing.assert_allclose(got.detach().numpy(), ref, **UPD)
    (got * torch.from_numpy(c)).sum().backward()
    gref = jax.grad(lambda p: jnp.sum(jl.conv_encoder_apply(
        p, jnp.asarray(x), 8, dtype=jnp.bfloat16) * c))(jp)
    for p, r in zip(tp, gref):
        np.testing.assert_allclose(p['w'].grad.numpy(), r['w'],
                                   rtol=2 ** -8, atol=2 ** -8 * float(
                                       np.abs(r['w']).max()))


# ----------------------------------------------------------------- update


def _rgb(cfg):
    cfg.obs, cfg.obs_shape = 'rgb', {'rgb': (9, 64, 64)}
    cfg.num_channels, cfg.latent_dim = 4, 64
    return cfg


def _batch(rng, T, rgb=False, episodic=False):
    terminated = np.zeros((T, B, 1), np.float32)
    if episodic:
        terminated.flat[rng.permutation(terminated.size)[:terminated.size // 5]] = 1
    obs = (rng.integers(0, 256, (T + 1, B, 9, 64, 64)).astype(np.uint8) if rgb
           else rng.normal(size=(T + 1, B, OBS)).astype(np.float32))
    return (obs, rng.uniform(-1, 1, (T, B, ACT)).astype(np.float32),
            rng.uniform(0, 1, (T, B, 1)).astype(np.float32), terminated)


def _hold_bf16(got, ref, rgb):
    """UPD on the parameters, targets and scale; GRAD on the Adam moments
    (the conv biases' at 1e-1 on the conv model: XLA's bf16 sum)."""
    for name in ('params', 'target_Qs', 'scale'):
        for a, b in zip(tree.leaves(getattr(got, name)), tree.leaves(getattr(ref, name))):
            assert a.dtype == b.dtype == torch.float32, name
            np.testing.assert_allclose(a.numpy(), b.numpy(), **UPD, err_msg=name)
    for name in ('opt_state', 'pi_opt_state'):
        g, r = getattr(got, name), getattr(ref, name)
        conv_b = set()
        if rgb and name == 'opt_state':
            for m in ('mu', 'nu'):
                conv_b |= {id(p['b']) for p in g['enc'][m]['rgb']}
        for a, b in zip(tree.leaves(g), tree.leaves(r)):
            tol = dict(rtol=1e-1, atol=1e-1) if id(a) in conv_b else GRAD
            np.testing.assert_allclose(a.numpy(), b.numpy(), **tol, err_msg=name)


@pytest.mark.parametrize('case', ['state', 'episodic', 'conv'])
def test_bf16_update_matches_jax_bf16_update(case):
    """Five bf16 `_update` steps from one JAX state, fed JAX's draws."""
    kw = dict(dropout=0.01, bf16_update=True, episodic=case == 'episodic')
    jcfg, tcfg = _cfgs(**kw)
    if case == 'conv':
        jcfg, tcfg = _rgb(jcfg), _rgb(tcfg)
    jag, tag = JTDMPC2(jcfg), TDMPC2(tcfg)
    assert tag.model_upd is not tag.model and tag.model_upd.dtype == torch.bfloat16
    rng = np.random.default_rng(6)
    batch = _batch(rng, jcfg.horizon, case == 'conv', case == 'episodic')
    jbatch = tuple(jnp.asarray(x, jnp.float32) for x in batch)
    jstate, tstate = jag.state, state_from_jax(jag.state)
    upd = jax.jit(jag._update)
    for step in range(5):
        noise = _noise_from_jax(jstate.key, jcfg)
        jstate, jinfo = upd(jstate, *jbatch)
        tinfo = tag._update(tstate, *(torch.from_numpy(x) for x in batch), noise)
        assert set(tinfo) == set(jinfo)
        for k in tinfo:
            tol = GRAD if 'grad_norm' in k else UPD
            if case == 'conv' and k == 'grad_norm':
                tol = dict(rtol=1e-2, atol=1e-2)
            np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]), **tol,
                                       err_msg=f'step {step}: {k}')
        _hold_bf16(tstate, state_from_jax(jstate), case == 'conv')


@pytest.mark.parametrize('case', ['state', 'conv'])
def test_bf16_update_close_to_f32(case):
    """JAX's contract for the bf16 update against the f32 one, on the
    port: finite losses within 5% of max(|f32|, 1), f32 master weights
    within 2e-3 (tests/test_bf16_update.py:52-71, 74-108)."""
    _, fcfg = _cfgs(dropout=0.01)
    _, bcfg = _cfgs(dropout=0.01, bf16_update=True)
    if case == 'conv':
        fcfg, bcfg = _rgb(fcfg), _rgb(bcfg)
    fp, bf = TDMPC2(fcfg), TDMPC2(bcfg)
    batch = tuple(torch.from_numpy(x) for x in
                  _batch(np.random.default_rng(7), fcfg.horizon, case == 'conv'))
    noise = fp.draw_update_noise()
    info_f = fp._update(fp.state, *batch, noise)
    info_b = bf._update(bf.state, *batch, noise)
    for k in LOSSES:
        a, b = float(info_f[k]), float(info_b[k])
        assert np.isfinite(b) and abs(a - b) <= 0.05 * max(abs(a), 1.0), (k, a, b)
    for pf, pb in zip(tree.leaves(fp.state.params), tree.leaves(bf.state.params)):
        assert pb.dtype == torch.float32
        np.testing.assert_allclose(pb.numpy(), pf.numpy(), rtol=0, atol=2e-3)


def test_bf16_acting_is_exactly_f32():
    """`act` under bf16_update=true gives the f32 agent's bits: acting, the
    plan and the weight prep never see the bf16 view."""
    _, fcfg = _cfgs()
    _, bcfg = _cfgs(bf16_update=True)
    fcfg.num_envs = bcfg.num_envs = 2
    fp, bf = TDMPC2(fcfg), TDMPC2(bcfg)
    obs = np.random.default_rng(1).standard_normal((2, OBS)).astype(np.float32)
    for t0, em in ((True, True), (False, False)):
        np.testing.assert_array_equal(fp.act(obs, t0=t0, eval_mode=em),
                                      bf.act(obs, t0=t0, eval_mode=em))
    assert load_cfg(overrides=['task=toy-reach', 'bf16_update=true']).bf16_update
