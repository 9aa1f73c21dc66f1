"""Per-phase wall-time accounting for the online collection loops (a copy
of tdmpc2_tpu/utils/phase.py).

Prints a `[phases]` breakdown every `every` vector steps. Every mark is a
host clock: a phase that only queues work on the card (the `update` phase
of the vectorised trainer) is booked with the time its launches took to
issue, not the card's time to run them. No reference counterpart.
"""

from __future__ import annotations

from time import perf_counter


class PhaseTimer:
    def __init__(self, names=('act', 'update', 'env', 'flush'),
                 steps_per_mark: int = 1, every: int = 500,
                 suffix: str = 'env-steps/s'):
        self._names = tuple(names)
        self._per = steps_per_mark
        self._every = every
        self._suffix = suffix
        self._phases = dict.fromkeys(self._names, 0.0)
        self._steps = 0
        self._t = perf_counter()

    def reset(self):
        """Start timing an iteration (excludes eval/log time since the
        previous mark)."""
        self._t = perf_counter()

    def mark(self, name: str):
        now = perf_counter()
        self._phases[name] += now - self._t
        self._t = now

    def step(self):
        """Count one vector step; print + reset the window at `every`."""
        self._steps += 1
        if self._steps < self._every:
            return
        tot = sum(self._phases.values()) or 1e-9
        print('[phases] ' + ' '.join(
            f'{k}={v / self._steps * 1e3:.1f}ms'
            for k, v in self._phases.items())
            + f' | {self._per * self._steps / tot:.1f} {self._suffix}')
        self._phases = dict.fromkeys(self._names, 0.0)
        self._steps = 0
