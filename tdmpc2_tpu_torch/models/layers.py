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

`dtype=torch.bfloat16` (the update's view under `cfg.bf16_update`; JAX
layers.py:110-121, 260-284) takes every product with bf16 operands and
f32 sums into an f32 output, the weights staying f32 masters; LayerNorm,
Mish, SimNorm, dropout and the bias stay f32. The conv stack then runs in
bf16 end to end, as JAX's does.
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


BF16 = torch.bfloat16


def _mm_f32(a, b):
    """bf16 a @ b into f32 on the card: cuBLAS with f32 sums
    (`aten::mm.dtype`, `aten::bmm.dtype` for a leading member axis)."""
    if b.ndim == 3:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.mm(a, b, out_dtype=torch.float32)


class _Bf16Product(torch.autograd.Function):
    """x @ w with bf16 operands and f32 sums on the card: x [..., in] and w
    [in, out], or x [n, R, in] and w [n, in, out]. The backward's two
    products take bf16 operands too (the output's f32 cotangent rounded
    once) and give each cotangent as JAX's transposed products do: the f32
    sum rounded to bf16, then widened to f32 (the casts' transposes)."""

    @staticmethod
    def forward(ctx, x, w):
        xb = x.to(BF16).reshape(-1, x.shape[-1]) if w.ndim == 2 else x.to(BF16)
        wb = w.to(BF16)
        ctx.save_for_backward(xb, wb)
        ctx.x_shape = x.shape
        return _mm_f32(xb, wb).reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        gb = g.to(BF16).reshape(xb.shape[:-1] + g.shape[-1:])
        gx = _mm_f32(gb, wb.transpose(-1, -2)).to(BF16).float()
        gw = _mm_f32(xb.transpose(-1, -2), gb).to(BF16).float()
        return gx.reshape(ctx.x_shape), gw


def product(x, w, dtype=None):
    """x @ w in f32, or with `dtype` (bf16) operands and f32 sums. On the
    card `_Bf16Product`; the plain version (the CPU) rounds the operands to
    bf16 and multiplies in f32, where autograd through the two casts gives
    JAX's cotangents: the f32 sums rounded to bf16, then widened."""
    if dtype is None:
        return torch.matmul(x, w)
    if x.is_cuda:
        return _Bf16Product.apply(x, w)
    return torch.matmul(x.to(BF16).float(), w.to(BF16).float())


@contextmanager
def bf16_f32_sums():
    """cuBLAS's bf16 products sum in f32 inside the block, split-K
    reductions included (`allow_bf16_reduced_precision_reduction` off); the
    previous setting is restored after it."""
    m = torch.backends.cuda.matmul
    prev = m.allow_bf16_reduced_precision_reduction
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction = prev


def linear(p, x, dtype=None):
    """y = x @ w + b, weights [in, out] (a leading member axis batches);
    `dtype` selects the product's operands (see `product`)."""
    return product(x, p['w'], dtype) + p['b'].unsqueeze(-2)


def normed_linear(p, x, act: Callable = mish, keep_mask=None,
                  dropout: float = 0.0, dtype=None):
    """Linear -> Dropout -> LayerNorm -> act (reference layers.py:107-111).

    `keep_mask` (bool, the linear output's shape) turns on dropout at rate
    `dropout`; without it the layer is in eval mode.
    """
    x = linear(p, x, dtype)
    if keep_mask is not None and dropout > 0.0:
        keep = 1.0 - dropout
        x = torch.where(keep_mask, x / keep, torch.zeros_like(x))
    return act(layer_norm(x, p['ln_w'].unsqueeze(-2), p['ln_b'].unsqueeze(-2)))


def mlp(params, x, final_act: Optional[Callable] = None, keep_mask=None,
        dropout: float = 0.0, dtype=None):
    """Apply the MLP; dropout (if a mask is given) on the first layer only
    (reference layers.py:131); `dtype` for every product."""
    for i, p in enumerate(params[:-1]):
        x = normed_linear(p, x, keep_mask=keep_mask if i == 0 else None,
                          dropout=dropout, dtype=dtype)
    last = params[-1]
    if 'ln_w' in last:
        return normed_linear(last, x, act=final_act or mish, dtype=dtype)
    x = linear(last, x, dtype)
    return final_act(x) if final_act is not None else x


def ensemble(params, x, keep_mask=None, dropout: float = 0.0, dtype=None):
    """Every member of a stacked MLP on shared input x [..., in] ->
    [n, ..., out] (a batched matmul over the member axis).

    `keep_mask` [n, ..., hidden] (bool) turns on each member's own dropout
    on its first layer, as the JAX package's per-member keys do
    (layers.py:180-193)."""
    n = params[0]['w'].shape[0]
    xs = x.reshape(1, -1, x.shape[-1]).expand(n, -1, -1)
    if keep_mask is not None:
        keep_mask = keep_mask.reshape(n, xs.shape[1], -1)
    out = mlp(params, xs, keep_mask=keep_mask, dropout=dropout, dtype=dtype)
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


def _conv_bf16(x, w, stride):
    """A bf16 convolution (x bf16, w f32 master): cuDNN's in bf16 on the
    card; the plain version (the CPU) convolves the bf16 values in f32 and
    rounds the output to bf16, where autograd through the casts rounds each
    cotangent to bf16 as JAX's bf16 transposes do."""
    wb = w.to(BF16)
    if x.is_cuda:
        return F.conv2d(x, wb, stride=stride)
    return F.conv2d(x.float(), wb.float(), stride=stride).to(BF16)


def conv_encoder_apply(params, x, simnorm_dim: int, shifts=None, dtype=None):
    """x [N, C, H, W] (uint8 frames, channel-first) -> [N, D]: ShiftAug
    when `shifts` [N, 2] is given, then [-0.5, 0.5], the convs (VALID
    padding, each followed by ReLU), the NHWC flatten of the JAX package
    (layers.py:283) and SimNorm. The weights stay HWIO, permuted to OIHW
    at the call; the convs are cuDNN's on the card, in f32, or with
    `dtype` (bf16) in bf16 from the scaling on: each conv's bf16 output,
    plus the bias cast to bf16, ReLU, as JAX layers.py:260-284; SimNorm
    in f32."""
    if shifts is not None:
        x = shift_aug(x, shifts)
    if dtype is not None:
        x = x.to(dtype) / 255.0 - 0.5
        for p, (_, stride) in zip(params, _CONV_SPEC):
            x = torch.relu(_conv_bf16(x, p['w'].permute(3, 2, 0, 1), stride)
                           + p['b'].to(dtype)[:, None, None])
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).float()
        return simnorm(x, simnorm_dim)
    x = pixel_preprocess(x)
    with f32_convs():
        for p, (_, stride) in zip(params, _CONV_SPEC):
            x = torch.relu(F.conv2d(x, p['w'].permute(3, 2, 0, 1), p['b'],
                                    stride=stride))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return simnorm(x, simnorm_dim)
