"""Math helpers of the planner path (port of tdmpc2_tpu/ops/math.py:20-112).

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
