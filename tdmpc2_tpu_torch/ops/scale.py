"""Running Q-value scale (port of tdmpc2_tpu/ops/scale.py).

The reference's RunningScale (tdmpc2/common/scale.py:7-50) as a function of
a scalar tensor that the train state carries.
"""

from __future__ import annotations

import torch

from tdmpc2_tpu_torch.ops.math import percentile_range


@torch.no_grad()
def update_scale(scale, qs, tau: float):
    """One EMA step of `scale` toward the 5-95 percentile range of qs [N, ...]
    (the t=0 Q values), the range taken at its first element and floored
    at 1. Not differentiated."""
    p5, p95 = percentile_range(qs)
    rng = torch.clamp((p95 - p5).reshape(-1)[0], min=1.0)
    return scale + tau * (rng - scale)
