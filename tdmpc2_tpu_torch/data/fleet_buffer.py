"""Seed-stacked replay buffer for a fleet, K seeds of one task in one
process (port of tdmpc2_tpu/data/fleet_buffer.py).

K per-seed episode rings in one set of tensors on the agent's device,
[K, capacity_eps, rows, ...], with the single-seed buffer's episode
semantics (data/buffer.py: the bootstrap row, the strict-length drop, slices
weighted by their valid starts). `sample_many(n)` draws every seed's n
batches at once from the buffer's own `torch.Generator`, each seed from its
own ring, and returns leaves [K, n, T(+1), B, ...]. A test feeds JAX's draws
through `gather`.

As in the JAX buffer, a write of fewer finished episodes than `num_envs`
(an episodic fleet's partial flush) fills a whole block of `num_envs` slots,
the rest as pad episodes of zero valid rows: they are never sampled, and
the next write overwrites them; at the ring's wrap, where fewer slots than
a block are left, episodes go one at a time. `num_eps` is the smallest
per-seed count, the gate of every update. State observations only, as in
the JAX package (fleet_buffer.py:36-37).
"""

from __future__ import annotations

import numpy as np
import torch

from tdmpc2_tpu_torch.data.buffer import draw_slice_indices


class FleetBuffer:
    """K per-seed episode rings with one sample for all seeds."""

    def __init__(self, cfg, num_seeds: int, device=None):
        if cfg.get('obs') == 'rgb':
            raise ValueError('a fleet buffer holds state observations; run '
                             'rgb tasks single-seed (as the JAX package does)')
        self.cfg = cfg
        self.device = torch.device(device or cfg.device)
        self.K = int(num_seeds)
        self._capacity = int(min(cfg.buffer_size, cfg.steps))
        self._rows = int(cfg.episode_length) + 1
        self._capacity_eps = max(1, self._capacity // int(cfg.episode_length))
        self._horizon = int(cfg.horizon)
        self._batch_size = int(cfg.batch_size)
        self._num_eps = np.zeros(self.K, np.int64)      # per seed
        self._storage = None
        self._ep_rows = None
        self._block = max(1, int(cfg.get('num_envs') or 1))
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 0xF1EE7)

    @property
    def num_eps(self) -> int:
        """The smallest per-seed episode count (sampling needs it > 0)."""
        return int(self._num_eps.min())

    def _init_storage(self, ep: dict):
        total = self._rows * self._capacity_eps * self.K * sum(
            v[0].nbytes for v in ep.values())
        print(f'Fleet buffer: {self.K} seeds x {self._capacity_eps:,} '
              f'episodes x {self._rows} rows -> {total / 1e9:.3f} GB on '
              f'{self.device}')
        self._storage = {
            k: torch.zeros((self.K, self._capacity_eps, self._rows) + v.shape[1:],
                           dtype=torch.from_numpy(v).dtype, device=self.device)
            for k, v in ep.items()}
        self._ep_rows = torch.zeros(self.K, self._capacity_eps,
                                    dtype=torch.long, device=self.device)

    def add(self, seed_idx: int, episodes: dict) -> int:
        """Write a block of seed `seed_idx`'s episodes: a dict of
        [M, rows, ...] arrays, optionally 'valid_rows' [M]. Episodes too
        short for a slice are dropped; shorter ones are zero-padded. Returns
        the seed's episode count (JAX fleet_buffer.py:77-151)."""
        episodes = dict(episodes)
        valid = episodes.pop('valid_rows', None)
        m = int(episodes['reward'].shape[0])
        valid = (np.full(m, self._rows, np.int64) if valid is None
                 else np.asarray(valid, np.int64).reshape(m))
        keep = valid >= self._horizon + 1           # torchrl's strict_length
        if not keep.all():
            episodes = {k: np.asarray(v)[keep] for k, v in episodes.items()}
            valid = valid[keep]
            m = int(valid.shape[0])
        if m == 0:
            return int(self._num_eps[seed_idx])
        for k, v in episodes.items():
            v = np.asarray(v)
            if v.dtype == np.float64:
                v = v.astype(np.float32)
            if v.shape[1] < self._rows:
                v = np.pad(v, [(0, 0), (0, self._rows - v.shape[1])]
                           + [(0, 0)] * (v.ndim - 2))
            episodes[k] = v
        if self._storage is None:
            self._init_storage({k: v[0] for k, v in episodes.items()})
        i = 0
        while i < m:
            slot = int(self._num_eps[seed_idx]) % self._capacity_eps
            room = self._capacity_eps - slot
            avail = min(m - i, room)
            # a whole block, a partial one padded to a block, or one
            # episode at the wrap (JAX fleet_buffer.py:117-131)
            if avail >= self._block:
                n, pad = self._block, 0
            elif room >= self._block:
                n, pad = avail, self._block - avail
            else:
                n, pad = 1, 0

            def blk(v):
                b = np.ascontiguousarray(v[i:i + n])
                return np.pad(b, [(0, pad)] + [(0, 0)] * (b.ndim - 1)) if pad else b
            for k, store in self._storage.items():
                store[seed_idx, slot:slot + n + pad].copy_(
                    torch.from_numpy(blk(episodes[k])))
            self._ep_rows[seed_idx, slot:slot + n + pad].copy_(
                torch.from_numpy(blk(valid)))
            self._num_eps[seed_idx] += n
            i += n
        return int(self._num_eps[seed_idx])

    def draw(self, n_batches: int = 1):
        """(episode, start) [K, n*B] of every seed's slices, each seed on its
        own ring (`draw_slice_indices` a seed, in seed order)."""
        if self.num_eps == 0:
            raise RuntimeError('cannot sample: some seed has no episodes')
        n_filled = np.minimum(self._num_eps, self._capacity_eps)
        nb = n_batches * self._batch_size
        got = [draw_slice_indices(self.generator, self._ep_rows[k],
                                  int(n_filled[k]), nb, self._horizon,
                                  self._capacity_eps) for k in range(self.K)]
        return (torch.stack([g[0] for g in got]),
                torch.stack([g[1] for g in got]))

    def gather(self, ep_idx, start, n_batches: int = 1):
        """Seed k's slices (ep_idx[k, j], rows start[k, j] .. + H) in the
        fleet update's layout: obs [K, n, H+1, B, ...], action [K, n, H, B,
        A], reward and terminated [K, n, H, B, 1] (JAX
        fleet_buffer.py:231-267)."""
        T, st, dev = self._horizon, self._storage, self.device
        ep_idx, start = ep_idx.to(dev), start.to(dev)
        rows_obs = start[..., None] + torch.arange(T + 1, device=dev)  # [K, NB, T+1]
        rows_act = rows_obs[..., 1:]
        seed_ax = torch.arange(self.K, device=dev)[:, None, None]
        ep_b = ep_idx[..., None]
        obs = st['obs'][seed_ax, ep_b, rows_obs]
        action = st['action'][seed_ax, ep_b, rows_act]
        reward = st['reward'][seed_ax, ep_b, rows_act][..., None]
        terminated = (st['terminated'][seed_ax, ep_b, rows_act][..., None]
                      if 'terminated' in st else torch.zeros_like(reward))

        def layout(x):      # [K, n*B, T, ...] -> [K, n, T, B, ...]
            x = x.reshape(self.K, n_batches, -1, *x.shape[2:])
            return x.transpose(2, 3).contiguous()
        return tuple(layout(x) for x in (obs, action, reward, terminated))

    def sample_many(self, n: int):
        """Every seed's n batches from one draw: (obs, action, reward,
        terminated), leaves [K, n, ...] (the n axis kept at n == 1)."""
        return self.gather(*self.draw(n), n)

    def save_snapshot(self, fp, max_episodes: int) -> int:
        """Every seed's newest S = min(max_episodes, the smallest per-seed
        count) episodes to `fp` (npz, [K, S, rows, ...]; JAX
        fleet_buffer.py:153-178). Returns the smallest per-seed count of
        env steps they hold, the refill gate's credit."""
        if self._storage is None or self.num_eps == 0:
            return 0
        s = min(int(max_episodes), self.num_eps, self._capacity_eps)
        idxs = torch.tensor([[(int(self._num_eps[k]) - s + i) % self._capacity_eps
                              for i in range(s)] for k in range(self.K)],
                            device=self.device)
        seed_ax = torch.arange(self.K, device=self.device)[:, None]
        out = {f'ep__{name}': arr[seed_ax, idxs].cpu().numpy()
               for name, arr in self._storage.items()}
        rows = self._ep_rows[seed_ax, idxs].cpu().numpy().astype(np.int32)
        out['valid_rows'] = rows
        with open(fp, 'wb') as f:
            np.savez(f, **out)
        return int((rows.astype(np.int64) - 1).sum(axis=1).min())

    def load_snapshot(self, fp) -> int:
        """Write a `save_snapshot` file back, seed by seed (JAX
        fleet_buffer.py:180-196); one of another seed count is skipped.
        Returns the smallest per-seed count of env steps restored."""
        with np.load(fp, allow_pickle=False) as data:
            rows = data['valid_rows'].astype(np.int32)       # [K, S]
            if rows.shape[0] != self.K:
                print(f'Fleet snapshot has {rows.shape[0]} seeds, need '
                      f'{self.K}; skipping restore.')
                return 0
            episodes = {n[4:]: data[n] for n in data.files
                        if n.startswith('ep__')}
        for k in range(self.K):
            ep_k = {name: v[k] for name, v in episodes.items()}
            ep_k['valid_rows'] = rows[k]
            self.add(k, ep_k)
        return int((rows.astype(np.int64) - 1).sum(axis=1).min())
