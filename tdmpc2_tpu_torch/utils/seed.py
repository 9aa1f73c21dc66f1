"""Seeding (reference: tdmpc2/common/seed.py).

`set_seed` seeds the host generators (`random`, numpy) and torch's global
generators, and returns an explicit `torch.Generator` on `device` that the
planner draws all its noise from. `generator_state` and
`restore_generator` carry a generator's state through a checkpoint.
"""

import random

import numpy as np
import torch


def set_seed(seed: int, device='cpu') -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)


def generator_state(generator: torch.Generator) -> dict:
    """A generator's state as numpy, with the kind of device it draws on."""
    return {'device': generator.device.type,
            'state': generator.get_state().numpy().copy()}


def restore_generator(generator: torch.Generator, saved: dict, whose: str):
    """Restore `saved` (from `generator_state`) into `generator` when both
    draw on the same kind of device (a CPU and a CUDA generator's states
    differ in kind); otherwise the generator keeps its seeded state, and
    says so."""
    if saved['device'] != generator.device.type:
        print(f'{whose}: the checkpoint\'s generator drew on '
              f'{saved["device"]}, this one on {generator.device.type}: '
              'it keeps its seeded state')
        return
    generator.set_state(torch.from_numpy(np.array(saved['state'], np.uint8)))
