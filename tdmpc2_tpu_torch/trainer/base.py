"""Trainer base (a copy of tdmpc2_tpu/trainer/base.py; reference
tdmpc2/trainer/base.py)."""

from __future__ import annotations

from tdmpc2_tpu_torch.utils import tree


class Trainer:
    def __init__(self, cfg, env, agent, buffer, logger):
        self.cfg = cfg
        self.env = env
        self.agent = agent
        self.buffer = buffer
        self.logger = logger
        n = sum(p.numel() for p in tree.leaves(agent.state.params))
        print(f'Agent parameters: {n:,}')

    def eval(self):
        raise NotImplementedError

    def train(self):
        raise NotImplementedError

    def finish(self):
        """End-of-run teardown: the final checkpoint through the logger,
        then the buffer and the env's worker processes, if it has any."""
        self.logger.finish(self.agent, self.buffer)
        self.buffer.close()
        if hasattr(self.env, 'close'):
            self.env.close()
