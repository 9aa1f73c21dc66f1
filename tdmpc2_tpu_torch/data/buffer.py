"""Episode replay buffer (port of tdmpc2_tpu/data/buffer.py, the single-
task state path).

- Storage is a ring of whole episodes, tensors [capacity_eps, rows, ...]
  with rows = episode_length + 1: each episode keeps the reference's
  leading bootstrap row, whose action, reward and terminated are NaN
  (online_trainer.py:54-72). Sampled slices never read that row's action
  or reward: they take the actions and rewards one row after the start.
- The ring lives on the device when 2.5x its bytes fit in the card's free
  memory (the reference's heuristic, buffer.py:62); otherwise in host RAM,
  and each sampled batch is gathered there and copied to the device once.
- `sample` draws (episode, start) pairs with `draw_slice_indices` from the
  buffer's own `torch.Generator` and returns the update's layout
  (obs [H+1, B, ...], action [H, B, A], reward and terminated [H, B, 1]).
  `sample_many(n)` draws n*B slices at once and returns n batches with a
  leading n axis, for `TDMPC2.update_many`.

Pixel frame restacking, bulk `load`/`reserve` (offline datasets) and
snapshots are later parts of the port.
"""

from __future__ import annotations

import numpy as np
import torch


def draw_slice_indices(generator, ep_rows, n_filled: int, nb: int,
                       horizon: int, capacity_eps: int):
    """(episode [nb], start row [nb]) of nb slices of horizon+1 rows.

    As torchrl's SliceSampler, uniform over slices rather than episodes:
    an episode is picked with weight equal to its count of valid starts
    (rows - horizon), then a start uniformly within it (reference
    common/buffer.py:17-24; JAX buffer.py:38-60). `ep_rows` [capacity_eps]
    int holds each slot's row count; the first `n_filled` slots are live.
    Draws come from `generator`, on ep_rows' device.
    """
    T, dev = horizon, ep_rows.device
    valid = torch.arange(capacity_eps, device=dev) < n_filled
    w = torch.where(valid, torch.clamp(ep_rows - T, min=0),
                    torch.zeros_like(ep_rows))
    cum = torch.cumsum(w.float(), 0)
    u = torch.rand(nb, generator=generator, device=dev) * cum[-1]
    ep_idx = torch.clamp(torch.searchsorted(cum, u, right=True), 0,
                         capacity_eps - 1)
    max_start = ep_rows[ep_idx] - (T + 1)       # inclusive max valid start
    v = torch.rand(nb, generator=generator, device=dev)
    start = torch.floor(v * (max_start + 1).float()).long()
    return ep_idx, start


class Buffer:
    """Replay buffer for TD-MPC2 training."""

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = torch.device(device or cfg.device)
        self._capacity = int(min(cfg.buffer_size, cfg.steps))
        self._rows = int(cfg.episode_length) + 1
        self._capacity_eps = max(1, self._capacity // int(cfg.episode_length))
        self._horizon = int(cfg.horizon)
        self._batch_size = int(cfg.batch_size)
        self._num_eps = 0
        self._storage = None
        self._ep_rows = None
        self._generator = None

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def num_eps(self) -> int:
        return self._num_eps

    def _init_storage(self, ep: dict):
        """Allocate the ring, sized by the first episode (reference
        buffer.py:50-67)."""
        total = self._rows * self._capacity_eps * sum(
            v[0].nbytes for v in ep.values())
        store = self.device
        if store.type == 'cuda':
            free, _ = torch.cuda.mem_get_info(store)
            if not 2.5 * total < free:
                store = torch.device('cpu')
        print(f'Buffer capacity: {self._capacity:,} '
              f'({self._capacity_eps:,} episodes x {self._rows} rows); '
              f'storage {total / 1e9:.3f} GB on {store}')
        self._storage = {
            k: torch.zeros((self._capacity_eps, self._rows) + v.shape[1:],
                           dtype=torch.from_numpy(v).dtype, device=store)
            for k, v in ep.items()}
        self._ep_rows = torch.zeros(self._capacity_eps, dtype=torch.long,
                                    device=store)
        self._generator = torch.Generator(device=store).manual_seed(
            self.cfg.seed + 0x5EED)

    def add(self, ep: dict) -> int:
        """Add one episode: a dict of [rows, ...] arrays (obs, action,
        reward, terminated) and optionally 'valid_rows'. Shorter episodes
        are zero-padded; one too short for a slice of horizon+1 rows is
        dropped (torchrl's strict_length). Returns the episode count
        (reference buffer.py:84-91)."""
        ep = dict(ep)
        valid_rows = int(ep.pop('valid_rows', ep['reward'].shape[0]))
        if valid_rows < self._horizon + 1:
            return self._num_eps
        for k, v in ep.items():
            v = np.asarray(v)
            if v.dtype == np.float64:
                v = v.astype(np.float32)
            if v.shape[0] < self._rows:
                v = np.pad(v, [(0, self._rows - v.shape[0])]
                           + [(0, 0)] * (v.ndim - 1))
            ep[k] = np.ascontiguousarray(v)
        if self._storage is None:
            self._init_storage(ep)
        slot = self._num_eps % self._capacity_eps
        for k, v in self._storage.items():
            v[slot].copy_(torch.from_numpy(ep[k]))
        self._ep_rows[slot] = valid_rows
        self._num_eps += 1
        return self._num_eps

    def gather(self, ep_idx, start, n_batches: int = 1):
        """The slices (ep_idx[i], rows start[i] .. start[i]+H) in the
        update's layout, on the buffer's device: obs [H+1, B, ...], action
        [H, B, A], reward and terminated [H, B, 1]; with n_batches > 1 the
        slices are n batches of B, laid out [n, H(+1), B, ...]
        (JAX `_to_batch_layout`, buffer.py:610-630)."""
        T = self._horizon
        st = self._storage
        dev = st['obs'].device
        ep_idx, start = ep_idx.to(dev), start.to(dev)
        rows_obs = start[:, None] + torch.arange(T + 1, device=dev)[None]
        rows_act = rows_obs[:, 1:]
        ep_b = ep_idx[:, None]
        obs = st['obs'][ep_b, rows_obs]
        action = st['action'][ep_b, rows_act]
        reward = st['reward'][ep_b, rows_act]
        terminated = (st['terminated'][ep_b, rows_act] if 'terminated' in st
                      else torch.zeros_like(reward))
        out = (obs, action, reward[..., None], terminated[..., None])
        if n_batches == 1:
            return tuple(x.transpose(0, 1).to(self.device).contiguous()
                         for x in out)
        # [n*B, T(+1), ...] -> [n, T(+1), B, ...]
        return tuple(
            x.reshape(n_batches, -1, *x.shape[1:]).transpose(1, 2)
            .to(self.device).contiguous() for x in out)

    def sample(self):
        """A batch of batch_size slices of horizon+1 rows (reference
        buffer.py:93-115)."""
        return self.sample_many(1)

    def sample_many(self, n: int):
        """n batches from one draw of n * batch_size slices (JAX
        buffer.py:481-507): leaves [n, H(+1), B, ...]; n == 1 gives the
        unbatched layout of `sample`."""
        if self._num_eps == 0:
            raise RuntimeError('cannot sample from an empty buffer')
        ep_idx, start = draw_slice_indices(
            self._generator, self._ep_rows,
            min(self._num_eps, self._capacity_eps), n * self._batch_size,
            self._horizon, self._capacity_eps)
        return self.gather(ep_idx, start, n)

    def close(self):
        """Nothing runs beside the buffer; kept for the trainer's teardown."""
