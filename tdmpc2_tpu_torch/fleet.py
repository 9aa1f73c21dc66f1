"""A fleet: K seeds of one task trained in one process (port of
tdmpc2_tpu/fleet.py).

The reference runs one seed a process, and its published evidence is 3
seeds a task; a fleet gives such users their K runs from one process. Seed
k is a whole port agent, `TDMPC2(cfg.replace(seed=seeds[k]))`: its
parameters, Adam states, scale, warm starts and generator are that single
agent's bit for bit, and so is every number it computes on the same inputs
and draws. Where the JAX fleet vmaps one seed-stacked train state through
its XLA planner (the Pallas kernels take one set of weights, fleet.py:21-25),
the port plans each seed through its own kernels:

- `act` is K plans, each the replay of seed k's plan graph on seed k's
  prepared weights (on the card: K graph replays, 1 + 2 x iterations
  kernel calls each, then one fetch of all K x N actions);
- `update_many` draws every seed's n batches at once from the
  `FleetBuffer` and takes each seed's n steps on its own train state (on
  the card n replays of seed k's update graph), returning the last step's
  info averaged over the seeds, as the JAX fleet does;
- `update_many_fused` and `step` (the JAX fleet's one-dispatch schedules)
  are the same replays in the same order: `step` is `act`'s plans, then
  `update_many`, then the fetch of the actions, which were planned with
  the weights before the updates.

A kernel's seed axis of weights (one launch for all K plans) is a kernel
feature the JAX package lacks: ROADMAP B queues it. A fleet over a device
mesh (`mesh_shape`) waits on ROADMAP A10; the config refuses the key.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from tdmpc2_tpu_torch.tdmpc2 import TDMPC2


class FleetAgent:
    """K single-task agents, one a seed."""

    def __init__(self, cfg, seeds, device=None):
        self.seeds = [int(s) for s in seeds]
        self.K = len(self.seeds)
        if self.K < 1 or len(set(self.seeds)) != self.K:
            raise ValueError(f'seeds must be distinct, got {self.seeds}')
        if cfg.multitask:
            raise ValueError('a fleet trains one task online (single-task)')
        if not cfg.mpc:
            raise ValueError('a fleet agent plans (mpc=true)')
        self.cfg = cfg
        self.agents = [TDMPC2(cfg.replace(seed=s), device) for s in self.seeds]
        self.device = self.agents[0].device

    def seed_state(self, k: int):
        """Seed k's train state (the agent's own, not a copy)."""
        return self.agents[k].state

    # ------------------------------------------------------------------ act

    def _plans(self, obs, t0, eval_mode, noise=None):
        """Seed k's plan for obs[k] [N, ...], left on the device, for every
        k; `noise` (K PlanNoises) replaces the seeds' draws."""
        obs = np.asarray(obs)
        if obs.shape[0] != self.K:
            raise ValueError(f'{obs.shape[0]} seeds of observations for {self.K}')
        t0 = np.broadcast_to(np.asarray(t0, bool), obs.shape[:2])
        noise = noise or [None] * self.K
        return [ag.plan_vec(torch.from_numpy(ag._obs_array(o)), t,
                            eval_mode=eval_mode, noise=nz)[0]
                for ag, o, t, nz in zip(self.agents, obs, t0, noise)]

    def act(self, obs, t0=False, eval_mode=False, noise=None):
        """obs [K, N, obs_dim]; t0 a bool or [K, N] -> actions [K, N, A]
        (numpy): K plans, then one fetch. `noise`, a PlanNoise a seed,
        replaces the draws (a test feeds JAX's)."""
        return torch.stack(self._plans(obs, t0, eval_mode, noise)).cpu().numpy()

    # ------------------------------------------------------------- learning

    def _update_batches(self, batch, n: int, noise=None) -> dict:
        """Seed k's n steps on batch leaves [k, i] (with noise[k][i], an
        UpdateNoise, where given; a test feeds JAX's); the last step's
        info averaged over the seeds."""
        infos = []
        for k, ag in enumerate(self.agents):
            for i in range(n):
                info = ag._step(tuple(x[k, i] for x in batch),
                                None if noise is None else noise[k][i])
            ag._prep = None
            infos.append(info)
        return {key: torch.stack([i[key] for i in infos]).mean(0)
                for key in infos[0]}

    def update_many(self, buffer, n: int) -> dict:
        """n updates a seed, each seed on its own n batches of one
        `buffer.sample_many(n)` draw (JAX fleet.py:87-97)."""
        return self._update_batches(buffer.sample_many(n), n)

    def update_many_fused(self, buffer, n: int) -> dict:
        """The JAX fleet's sample-inside-the-program variant
        (fleet.py:99-127): the same draw and the same replays."""
        return self.update_many(buffer, n)

    def step(self, buffer, obs, t0, n: int):
        """Every seed's plan, then `update_many(buffer, n)`, then one fetch
        of the actions (JAX fleet.py:129-173) -> (actions [K, N, A] numpy,
        the seed-averaged info)."""
        if buffer.num_eps == 0:
            raise RuntimeError('cannot step: some seed has no replay episodes')
        plans = self._plans(obs, t0, False)
        info = self.update_many(buffer, n)
        return torch.stack(plans).cpu().numpy(), info

    # -------------------------------------------------------- checkpointing

    def save_seed(self, k: int, fp, extra=None):
        """Seed k's single-agent checkpoint, which `TDMPC2.load`,
        `evaluate` and a resume read unchanged (JAX fleet.py:178-188)."""
        self.agents[k].save(fp, extra=extra)

    def load_seeds(self, fps) -> list:
        """One checkpoint a seed (a port's `save_seed`, a JAX fleet's
        `save_seed` or any single-agent checkpoint); returns their `extra`
        dicts (JAX fleet.py:190-205)."""
        if len(fps) != self.K:
            raise ValueError(f'{len(fps)} checkpoints for {self.K} seeds')
        return [ag.load(fp) for ag, fp in zip(self.agents, fps)]

    def load_states(self, states):
        """Take K port train states (e.g. `interop.fleet_states_from_jax`)
        as the seeds' states; every graph is dropped."""
        if len(states) != self.K:
            raise ValueError(f'{len(states)} states for {self.K} seeds')
        for ag, st in zip(self.agents, states):
            ag.state = st.to(ag.device)
            ag._prep = None

    def work_dir(self, k: int) -> Path:
        """Seed k's log directory, a single-seed run's layout
        (logs/<task>/<seed>/<exp>)."""
        return Path(self.cfg.work_dir).parent.parent / str(self.seeds[k]) / \
            self.cfg.exp_name
