"""Seeding (reference: tdmpc2/common/seed.py).

Seeds the host generators (`random`, numpy) and torch's global generators,
and returns an explicit `torch.Generator` on `device` that the planner
draws all its noise from.
"""

import random

import numpy as np
import torch


def set_seed(seed: int, device='cpu') -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)
