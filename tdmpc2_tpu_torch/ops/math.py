"""Math helpers of the planner and the update (port of
tdmpc2_tpu/ops/math.py).

Shape-polymorphic over leading dims, like the JAX versions. Randomness is
an input: `gumbel_softmax_sample` takes its Gumbel noise as a tensor, so a
test can feed the draw the JAX side made.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def symlog(x):
    """sign(x) * log(1+|x|). (reference math.py:42-47)"""
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    """sign(x) * (exp(|x|)-1). (reference math.py:50-55)"""
    return torch.sign(x) * torch.expm1(torch.abs(x))


_LOG_SQRT_2PI = 0.9189385175704956  # log(sqrt(2*pi)), reference math.py:19


def two_hot(x, num_bins: int, vmin: float, vmax: float):
    """Scalar [..., 1] -> soft two-hot target [..., num_bins] over
    symlog-spaced bins. At x == vmax the upper weight is 0 and its index
    wraps to bin 0, as in the JAX version. (reference math.py:58-71)
    """
    if num_bins == 0:
        return x
    if num_bins == 1:
        return symlog(x)
    bin_size = (vmax - vmin) / (num_bins - 1)
    x = torch.clamp(symlog(x), vmin, vmax)[..., 0]
    pos = (x - vmin) / bin_size
    idx = torch.floor(pos)
    off = (pos - idx)[..., None]
    idx = idx.long()
    lo = F.one_hot(idx, num_bins).to(x.dtype) * (1.0 - off)
    hi = F.one_hot((idx + 1) % num_bins, num_bins).to(x.dtype) * off
    return lo + hi


def soft_ce(pred_logits, target, num_bins: int, vmin: float, vmax: float):
    """Cross-entropy of logits [..., num_bins] against the two-hot encoding
    of a scalar target [..., 1] -> [..., 1]. (reference math.py:5-9)"""
    logp = F.log_softmax(pred_logits, dim=-1)
    t = two_hot(target, num_bins, vmin, vmax)
    return -torch.sum(t * logp, dim=-1, keepdim=True)


def gaussian_logprob(eps, log_std_):
    """Log-prob of eps under N(0, exp(log_std)^2), summed over the last
    axis. (reference math.py:16-20)"""
    residual = -0.5 * eps * eps - log_std_
    return torch.sum(residual - _LOG_SQRT_2PI, dim=-1, keepdim=True)


def squash(mu, pi, log_pi):
    """Tanh-squash mean and sample; log-det-Jacobian correction of the
    log-prob. (reference math.py:23-29)"""
    mu = torch.tanh(mu)
    pi = torch.tanh(pi)
    correction = torch.log(F.relu(1.0 - pi * pi) + 1e-6)
    return mu, pi, log_pi - torch.sum(correction, dim=-1, keepdim=True)


def termination_statistics(pred, target, eps: float = 1e-9):
    """Termination rate and F1 of predictions [..., 1] against 0/1 targets
    [..., 1]. (reference math.py:97-109)"""
    pred, target = pred[..., 0], target[..., 0]
    rate = torch.sum(target) / target.numel()
    tp = torch.sum((pred > 0.5) & (target == 1))
    fn = torch.sum((pred <= 0.5) & (target == 1))
    fp = torch.sum((pred > 0.5) & (target == 0))
    recall = tp / (tp + fn + eps)
    precision = tp / (tp + fp + eps)
    f1 = 2 * (precision * recall) / (precision + recall + eps)
    return {'termination_rate': rate, 'termination_f1': f1}


def sigmoid_binary_cross_entropy(logits, labels):
    """Elementwise cross-entropy of sigmoid(logits) against labels in
    [0, 1], as optax.sigmoid_binary_cross_entropy computes it (the JAX
    update's termination loss, tdmpc2.py:977-984): through log-sigmoids,
    whose gradient is sigmoid(x) - z everywhere. (The equal form
    relu(x) - x*z + log1p(exp(-|x|)) differentiates to -z at x = 0.)"""
    labels = labels.to(logits.dtype)
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


def percentile_range(x, lo: float = 5.0, hi: float = 95.0):
    """Linearly interpolated (lo, hi) percentiles over axis 0 of x [N, ...]
    -> two tensors of shape [prod(...)], by the reference's own
    interpolation (tdmpc2/common/scale.py:21-37)."""
    n = x.shape[0]
    xs = torch.sort(x.reshape(n, -1), dim=0).values
    out = []
    for p in (lo, hi):
        pos = p * (n - 1) / 100.0
        floored = int(pos)
        ceiled = min(floored + 1, n - 1)
        w_ceil = pos - floored
        out.append(xs[floored] * (1.0 - w_ceil) + xs[ceiled] * w_ceil)
    return out[0], out[1]


def two_hot_inv(logits, num_bins: int, vmin: float, vmax: float):
    """Soft two-hot logits [..., num_bins] -> scalar [..., 1].

    (reference math.py:74-83)
    """
    if num_bins == 0:
        return logits
    if num_bins == 1:
        return symexp(logits)
    bins = torch.linspace(vmin, vmax, num_bins, dtype=logits.dtype,
                          device=logits.device)
    x = torch.softmax(logits, dim=-1)
    x = torch.sum(x * bins, dim=-1, keepdim=True)
    return symexp(x)


def log_std(x, low, dif):
    """Squash an unbounded log-std head into [low, low+dif]. (math.py:12-13)"""
    return low + 0.5 * dif * (torch.tanh(x) + 1.0)


def int_to_one_hot(x, num_classes: int):
    """Integer tensor -> float one-hot. (math.py:32-39)"""
    return F.one_hot(x.long(), num_classes).float()


def gumbel_softmax_sample(p, gumbel, temperature: float = 1.0):
    """Index ~ Gumbel-softmax over unnormalized probabilities `p` [N].

    `gumbel` [N] is standard Gumbel noise, drawn by the caller.
    (reference math.py:86-94)
    """
    logits = torch.log(p)
    return torch.argmax((logits + gumbel) / temperature, dim=-1)
