"""Functional NN building blocks (port of tdmpc2_tpu/models/layers.py).

Parameters are the JAX package's pytree with torch tensors for leaves, in
its layout, so weights carry across by renaming nothing:
- Linear:       {'w': [in, out], 'b': [out]}
- NormedLinear: {'w': [in, out], 'b': [out], 'ln_w': [out], 'ln_b': [out]}
- MLP:          tuple of layer dicts; the last is a plain Linear, or a
                NormedLinear whose activation the caller supplies.
- Ensemble:     one MLP whose leaves carry a leading [n] member axis.
- Conv encoder: tuple of {'w': [kh, kw, in, out] (HWIO), 'b': [out]}.

Dropout takes its keep-mask as an input, and ShiftAug its integer shifts
(noise is data in the port).
"""

from __future__ import annotations

import math as _pymath
from contextlib import contextmanager
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Initializers (reference: tdmpc2/common/init.py; JAX layers.py:31-56)
# ---------------------------------------------------------------------------


def trunc_normal(gen: torch.Generator, shape, std: float = 0.02):
    """Normal(0, std) truncated to [-2, 2] absolute, as
    torch.nn.init.trunc_normal_(std=0.02) in the reference (init.py:7).
    At std 0.02 the bounds sit at 100 sigma, so clamping is exact in
    distribution."""
    return (torch.randn(shape, generator=gen) * std).clamp_(-2.0, 2.0)


def linear_init(gen, in_dim: int, out_dim: int, zero: bool = False):
    w = (torch.zeros(in_dim, out_dim) if zero
         else trunc_normal(gen, (in_dim, out_dim)))
    return {'w': w, 'b': torch.zeros(out_dim)}


def normed_linear_init(gen, in_dim: int, out_dim: int):
    p = linear_init(gen, in_dim, out_dim)
    p['ln_w'] = torch.ones(out_dim)
    p['ln_b'] = torch.zeros(out_dim)
    return p


def embedding_init(gen, num: int, dim: int):
    """Uniform(-0.02, 0.02), as reference init.py:10-11 (JAX layers.py:51)."""
    return {'w': torch.rand(num, dim, generator=gen) * 0.04 - 0.02}


def mlp_init(gen, in_dim: int, mlp_dims: Sequence[int], out_dim: int,
             final_normed: bool = False, zero_final: bool = False):
    """dims = [in] + mlp_dims + [out]; NormedLinear (Mish) layers, then a
    plain Linear or a NormedLinear (reference layers.py:121-133)."""
    dims = [in_dim] + list(mlp_dims) + [out_dim]
    layers = [normed_linear_init(gen, dims[i], dims[i + 1])
              for i in range(len(dims) - 2)]
    if final_normed:
        layers.append(normed_linear_init(gen, dims[-2], dims[-1]))
    else:
        layers.append(linear_init(gen, dims[-2], dims[-1], zero=zero_final))
    return tuple(layers)


def conv_init(gen, kh: int, kw: int, in_ch: int, out_ch: int):
    """Kaiming-uniform(a=sqrt(5)) weights and a uniform bias, torch
    Conv2d's default (the reference leaves its convs at that; JAX
    layers.py:56-66), in HWIO."""
    bound = 1.0 / _pymath.sqrt(in_ch * kh * kw)
    w = torch.rand(kh, kw, in_ch, out_ch, generator=gen) * (2 * bound) - bound
    b = torch.rand(out_ch, generator=gen) * (2 * bound) - bound
    return {'w': w, 'b': b}


def ensemble_init(n: int, init_fn: Callable):
    """`n` independent copies with leaves stacked on a leading axis."""
    members = [init_fn() for _ in range(n)]
    return tuple({k: torch.stack([m[i][k] for m in members])
                  for k in members[0][i]}
                 for i in range(len(members[0])))


# ---------------------------------------------------------------------------
# Activations / normalizers
# ---------------------------------------------------------------------------


def mish(x):
    """x * tanh(softplus(x)) through tanh(log z) = (z²-1)/(z²+1), z = 1+eˣ,
    with the exp argument clamped at 15 (JAX layers.py:74-85)."""
    z = torch.exp(torch.clamp(x, max=15.0)) + 1.0
    z2 = z * z
    return x * (z2 - 1.0) / (z2 + 1.0)


def simnorm(x, dim: int):
    """Softmax over contiguous groups of `dim` (reference layers.py:74-91)."""
    shp = x.shape
    return torch.softmax(x.reshape(*shp[:-1], -1, dim), dim=-1).reshape(shp)


def layer_norm(x, w, b, eps: float = 1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def linear(p, x):
    """y = x @ w + b, weights [in, out] (a leading member axis batches)."""
    return torch.matmul(x, p['w']) + p['b'].unsqueeze(-2)


def normed_linear(p, x, act: Callable = mish, keep_mask=None,
                  dropout: float = 0.0):
    """Linear -> Dropout -> LayerNorm -> act (reference layers.py:107-111).

    `keep_mask` (bool, the linear output's shape) turns on dropout at rate
    `dropout`; without it the layer is in eval mode.
    """
    x = linear(p, x)
    if keep_mask is not None and dropout > 0.0:
        keep = 1.0 - dropout
        x = torch.where(keep_mask, x / keep, torch.zeros_like(x))
    return act(layer_norm(x, p['ln_w'].unsqueeze(-2), p['ln_b'].unsqueeze(-2)))


def mlp(params, x, final_act: Optional[Callable] = None, keep_mask=None,
        dropout: float = 0.0):
    """Apply the MLP; dropout (if a mask is given) on the first layer only
    (reference layers.py:131)."""
    for i, p in enumerate(params[:-1]):
        x = normed_linear(p, x, keep_mask=keep_mask if i == 0 else None,
                          dropout=dropout)
    last = params[-1]
    if 'ln_w' in last:
        return normed_linear(last, x, act=final_act or mish)
    x = linear(last, x)
    return final_act(x) if final_act is not None else x


def ensemble(params, x, keep_mask=None, dropout: float = 0.0):
    """Every member of a stacked MLP on shared input x [..., in] ->
    [n, ..., out] (a batched matmul over the member axis).

    `keep_mask` [n, ..., hidden] (bool) turns on each member's own dropout
    on its first layer, as the JAX package's per-member keys do
    (layers.py:180-193)."""
    n = params[0]['w'].shape[0]
    xs = x.reshape(1, -1, x.shape[-1]).expand(n, -1, -1)
    if keep_mask is not None:
        keep_mask = keep_mask.reshape(n, xs.shape[1], -1)
    out = mlp(params, xs, keep_mask=keep_mask, dropout=dropout)
    return out.reshape(n, *x.shape[:-1], out.shape[-1])


# ---------------------------------------------------------------------------
# Pixel path (JAX layers.py:212-284; reference layers.py:36-71, 136-150)
# ---------------------------------------------------------------------------

SHIFT_PAD = 3                                  # ShiftAug's +-3 pixels
_CONV_SPEC = ((7, 2), (5, 2), (3, 2), (3, 1))  # (kernel, stride) per layer


def pixel_preprocess(x):
    """uint8 [0, 255] -> f32 [-0.5, 0.5] (reference layers.py:62-71)."""
    return x.float() / 255.0 - 0.5


def shift_aug(x, shifts, pad: int = SHIFT_PAD):
    """ShiftAug with the caller's integer shifts (reference layers.py:36-59):
    x [N, C, H, W], any dtype; shifts [N, 2] (rows, columns) in
    [0, 2 * pad]. Image n is edge-padded by `pad` and cropped at
    (shifts[n, 0], shifts[n, 1]), as the JAX package's two `take_along_axis`
    gathers do (layers.py:217-234): here one gather of rows, one of columns,
    on the input's dtype, with the padding folded into clamped indices."""
    n, c, h, w = x.shape
    shifts = shifts.to(device=x.device, dtype=torch.long)
    rows = torch.clamp(shifts[:, :1] - pad + torch.arange(h, device=x.device),
                       0, h - 1)                                  # [N, H]
    cols = torch.clamp(shifts[:, 1:] - pad + torch.arange(w, device=x.device),
                       0, w - 1)                                  # [N, W]
    x = torch.gather(x, 2, rows[:, None, :, None].expand(n, c, h, w))
    return torch.gather(x, 3, cols[:, None, None, :].expand(n, c, h, w))


def conv_output_dim(h: int, w: int, num_channels: int) -> int:
    """Flattened output size of the conv encoder for an h x w input."""
    for k, s in _CONV_SPEC:
        h = (h - k) // s + 1
        w = (w - k) // s + 1
    return h * w * num_channels


def conv_encoder_init(gen, in_ch: int, num_channels: int):
    """The 4-layer CNN for 64x64 frames (reference layers.py:136-150)."""
    layers, ch = [], in_ch
    for ksize, _ in _CONV_SPEC:
        layers.append(conv_init(gen, ksize, ksize, ch, num_channels))
        ch = num_channels
    return tuple(layers)


@contextmanager
def f32_convs(deterministic: bool = False):
    """cuDNN's convolutions in f32 inside the block (TF32 off): the card
    then holds the CPU at 1e-4. With `deterministic`, by deterministic
    algorithms as well, which an update's backward takes so that its
    weight gradients have the same bits in every run and in its graph's
    replays; cuDNN reads both settings where it runs a convolution, the
    backward's at `torch.autograd.grad`. The previous settings are
    restored after it. Nothing else changes."""
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32 = False
    cudnn.deterministic = deterministic or prev[1]
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = prev


def conv_encoder_apply(params, x, simnorm_dim: int, shifts=None):
    """x [N, C, H, W] (uint8 frames, channel-first) -> [N, D]: ShiftAug
    when `shifts` [N, 2] is given, then [-0.5, 0.5], the convs (VALID
    padding, each followed by ReLU), the NHWC flatten of the JAX package
    (layers.py:283) and SimNorm. The weights stay HWIO, permuted to OIHW
    at the call; the convs are cuDNN's on the card, in f32."""
    if shifts is not None:
        x = shift_aug(x, shifts)
    x = pixel_preprocess(x)
    with f32_convs():
        for p, (_, stride) in zip(params, _CONV_SPEC):
            x = torch.relu(F.conv2d(x, p['w'].permute(3, 2, 0, 1), p['b'],
                                    stride=stride))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return simnorm(x, simnorm_dim)
