"""Episode replay buffer (port of tdmpc2_tpu/data/buffer.py: state and
pixel observations, single- and multi-task).

- Storage is a ring of whole episodes, tensors [capacity_eps, rows, ...]
  with rows = episode_length + 1: each episode keeps the reference's
  leading bootstrap row, whose action, reward and terminated are NaN
  (online_trainer.py:54-72). Sampled slices never read that row's action
  or reward: they take the actions and rewards one row after the start.
- Where the ring lives is `cfg.buffer_device` (JAX buffer.py:146-193):
  'device' puts it on the agent's device, 'host' in host RAM, and 'auto'
  (the default) on the device when 2.5x its bytes fit in the card's free
  memory (the reference's heuristic, buffer.py:62), where a card that
  refuses the allocation sends it to the host instead; without a card
  (the CPU) 'auto' is 'device', as the JAX buffer's trial allocation
  decides on a backend that reports no free memory. A ring in host RAM is
  gathered there, and each sampled batch is copied to the device once.
  `sample_batch_bytes` feeds the agent's cap on updates a call
  (`TDMPC2._update_chunk`).
- `sample` draws (episode, start) pairs with `draw_slice_indices` from the
  buffer's own `torch.Generator` and returns the update's layout
  (obs [H+1, B, ...], action [H, B, A], reward and terminated [H, B, 1]).
  `sample_many(n)` draws n*B slices at once and returns n batches with a
  leading n axis, for `TDMPC2.update_many`.
- Multi-task data: an episode may carry its task index ('task', a scalar),
  kept in a per-episode store; a batch then ends with each slice's task
  (task [B], or [n, B] from `sample_many`), as the JAX buffer's does
  (buffer.py:202-207, 327-328).
- `reserve(n)` sizes the ring to an offline dataset before the first
  write, and `load(episodes)` writes whole chunks of episodes at once
  (JAX buffer.py:363-440; the reference's offline loading,
  common/buffer.py:69-82).
- `save_snapshot` writes the newest episodes to an npz in the JAX
  buffer's layout (`ep__<name>`, `valid_rows`, `task`; JAX
  buffer.py:290-352), so either package reads the other's, and
  `load_snapshot` writes one back through `load`. The generator's state
  travels with the agent's checkpoint (`TDMPC2.save(buffer=...)`,
  `set_rng_state`).
- Pixel observations (uint8 stacks of 3 frames, oldest first, as
  envs/dmcontrol.py `PixelObs` makes them) are stored unstacked, as in the
  JAX buffer (buffer.py:21-27): a row keeps only its newest frame's
  c = C/3 channels, flattened to c*H*W (the reset row's stack is its first
  frame three times, so that row holds it too). A sampled slice rebuilds
  each of its T+1 stacks from rows start-2 .. start+T, clipped at row 0
  (JAX buffer.py:558-593), on the device and in uint8: the encoder casts.
  A ring on the host sends the unstacked frames to the card, a third of
  the stacks' bytes. Snapshots carry the frame shape (`meta_frame_shape`).
"""

from __future__ import annotations

import numpy as np
import torch

from tdmpc2_tpu_torch.utils.seed import restore_generator

BUFFER_DEVICES = ('auto', 'device', 'host')


def device_free_bytes(device):
    """Free memory of `device` in bytes (`torch.cuda.mem_get_info`), None
    for a device that does not report it (the CPU)."""
    device = torch.device(device)
    if device.type != 'cuda':
        return None
    return torch.cuda.mem_get_info(device)[0]


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
        self._placement = str(cfg.get('buffer_device') or 'auto')
        if self._placement not in BUFFER_DEVICES:
            raise ValueError(f'buffer_device={self._placement!r}: one of '
                             f'{BUFFER_DEVICES}')
        self._on_device = None
        self._capacity = int(min(cfg.buffer_size, cfg.steps))
        self._rows = int(cfg.episode_length) + 1
        self._capacity_eps = max(1, self._capacity // int(cfg.episode_length))
        self._horizon = int(cfg.horizon)
        self._batch_size = int(cfg.batch_size)
        self._num_eps = 0
        self._storage = None
        self._ep_rows = None
        self._task_store = None
        self._generator = None
        self._rng_state = None      # a checkpoint's, until the ring exists
        self._draws = 0             # sample_many calls (JAX buffer._draws)
        # pixel frame stacks are stored unstacked: (c, H, W) of one frame
        self._frame_stack = 3 if cfg.get('obs') == 'rgb' else 1
        self._obs_frame_shape = None

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def on_device(self) -> bool:
        """Whether the ring lives on the agent's device (False before the
        first write): `vec_step` takes its one-call path on such a ring."""
        return bool(self._on_device)

    def sample_batch_bytes(self):
        """Bytes of one sampled batch as the update takes it in, or None
        before the first write (JAX buffer.py:113-125): every field in f32,
        pixel stacks frame_stack x the stored frame, since the encoder casts
        them to f32."""
        if self._storage is None:
            return None
        T, B = self._horizon, self._batch_size
        total = 0
        for k, v in self._storage.items():
            n_feat = int(np.prod(v.shape[2:])) if v.ndim > 2 else 1
            if k == 'obs':
                n_feat *= self._frame_stack
            total += (T + 1 if k == 'obs' else T) * B * n_feat * 4
        return total

    @property
    def generator(self):
        """The slice sampler's generator; None until the first write."""
        return self._generator

    def set_rng_state(self, saved: dict):
        """Restore the generator from a checkpoint (`TDMPC2.load`): at once,
        or when the first write creates it."""
        self._rng_state = saved
        if self._generator is not None:
            self._restore_rng()

    def _restore_rng(self):
        restore_generator(self._generator, self._rng_state, 'the buffer')
        self._rng_state = None

    @property
    def num_eps(self) -> int:
        return self._num_eps

    def reserve(self, n_episodes: int):
        """Clamp the ring to `n_episodes` before the first write (offline
        loading, JAX buffer.py:363-369): storage sized to the dataset rather
        than to the config's cap."""
        if self._storage is not None:
            raise RuntimeError('reserve() must precede the first write')
        self._capacity_eps = max(1, min(self._capacity_eps, int(n_episodes)))
        self._capacity = self._capacity_eps * int(self.cfg.episode_length)

    def _init_storage(self, ep: dict, has_task: bool = False):
        """Allocate the ring, sized by the first episode (reference
        buffer.py:50-67; pixel frames already unstacked, so the placement
        rule counts the uint8 frames it stores), where `buffer_device` puts
        it (JAX buffer.py:140-193), and the per-episode task store when the
        data carries tasks."""
        total = self._rows * self._capacity_eps * sum(
            v[0].nbytes for v in ep.values())
        free = device_free_bytes(self.device)
        if self._placement == 'auto':
            self._on_device = free is None or 2.5 * total < free
        else:
            self._on_device = self._placement == 'device'

        def alloc(store):
            return {k: torch.zeros((self._capacity_eps, self._rows) + v.shape[1:],
                                   dtype=torch.from_numpy(v).dtype, device=store)
                    for k, v in ep.items()}
        storage = None
        if self._on_device:
            try:
                storage = alloc(self.device)
            except torch.cuda.OutOfMemoryError as e:
                if self._placement == 'device':
                    raise
                print(f'Device buffer allocation failed ({e}); the ring goes '
                      'to host RAM')
                self._on_device = False
        store = self.device if self._on_device else torch.device('cpu')
        self._storage = storage if storage is not None else alloc(store)
        print(f'Buffer capacity: {self._capacity:,} '
              f'({self._capacity_eps:,} episodes x {self._rows} rows); '
              f'storage {total / 1e9:.3f} GB on {store} (buffer_device='
              f'{self._placement}, free device memory '
              f'{"n/a" if free is None else f"{free / 1e9:.2f} GB"})')
        self._ep_rows = torch.zeros(self._capacity_eps, dtype=torch.long,
                                    device=store)
        if has_task:
            self._task_store = torch.zeros(self._capacity_eps,
                                           dtype=torch.int32, device=store)
        self._generator = torch.Generator(device=store).manual_seed(
            self.cfg.seed + 0x5EED)
        if self._rng_state is not None:
            self._restore_rng()

    def _unstack(self, obs, lead: int):
        """Pixel frame stacks [*rows, fs*c, H, W] -> the newest frame of each,
        flat [*rows, c*H*W] (`lead` leading axes); other observations as
        they are. The first stack seen fixes the frame shape."""
        if (self._frame_stack == 1 or obs.ndim != lead + 3
                or obs.shape[lead] % self._frame_stack):
            return obs
        if self._obs_frame_shape is None and self._storage is None:
            self._obs_frame_shape = (obs.shape[lead] // self._frame_stack,
                                     *obs.shape[lead + 1:])
        if self._obs_frame_shape is None:
            return obs
        c = self._obs_frame_shape[0]
        return np.ascontiguousarray(obs[(slice(None),) * lead + (
            slice(-c, None),)]).reshape(*obs.shape[:lead], -1)

    def add(self, ep: dict) -> int:
        """Add one episode: a dict of [rows, ...] arrays (obs, action,
        reward, terminated) and optionally 'valid_rows' and a scalar 'task'.
        Shorter episodes are zero-padded; one too short for a slice of
        horizon+1 rows is dropped (torchrl's strict_length). Returns the
        episode count (reference buffer.py:84-91)."""
        ep = dict(ep)
        valid_rows = int(ep.pop('valid_rows', ep['reward'].shape[0]))
        task = ep.pop('task', None)
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
        ep['obs'] = self._unstack(ep['obs'], 1)
        if self._storage is None:
            self._init_storage(ep, task is not None)
        slot = self._num_eps % self._capacity_eps
        for k, v in self._storage.items():
            v[slot].copy_(torch.from_numpy(ep[k]))
        self._ep_rows[slot] = valid_rows
        if self._task_store is not None:
            self._task_store[slot] = int(task)
        self._num_eps += 1
        return self._num_eps

    def load(self, episodes: dict) -> int:
        """Write a chunk of episodes at once (offline datasets; JAX
        buffer.py:373-440): arrays [N, rows, ...], with optional 'task'
        ([N], or [N, rows] whose column 0 is taken) and 'valid_rows' [N].
        Episodes are zero-padded to the ring's rows; those too short for a
        slice are dropped. Returns the episode count."""
        episodes = dict(episodes)
        task = episodes.pop('task', None)
        valid = episodes.pop('valid_rows', None)
        n = int(episodes['reward'].shape[0])
        if task is not None:
            task = np.asarray(task)
            task = (task[:, 0] if task.ndim > 1 else task).astype(np.int32)
        for k, v in episodes.items():
            v = np.asarray(v)
            if v.dtype == np.float64:
                v = v.astype(np.float32)
            if v.shape[1] < self._rows:
                v = np.pad(v, [(0, 0), (0, self._rows - v.shape[1])]
                           + [(0, 0)] * (v.ndim - 2))
            episodes[k] = v
        valid = (np.full(n, self._rows, np.int64) if valid is None
                 else np.asarray(valid, np.int64))
        keep = valid >= self._horizon + 1
        if not keep.all():
            episodes = {k: v[keep] for k, v in episodes.items()}
            valid = valid[keep]
            task = None if task is None else task[keep]
            n = int(valid.shape[0])
        if n == 0:
            return self._num_eps
        episodes['obs'] = self._unstack(episodes['obs'], 2)
        if self._storage is None:
            self._init_storage({k: v[0] for k, v in episodes.items()},
                               task is not None)
        i = 0
        while i < n:
            slot = self._num_eps % self._capacity_eps
            m = min(n - i, self._capacity_eps - slot)
            for k, v in self._storage.items():
                v[slot:slot + m].copy_(torch.from_numpy(
                    np.ascontiguousarray(episodes[k][i:i + m])))
            self._ep_rows[slot:slot + m].copy_(torch.from_numpy(valid[i:i + m]))
            if self._task_store is not None:
                self._task_store[slot:slot + m].copy_(
                    torch.from_numpy(task[i:i + m]))
            self._num_eps += m
            i += m
        return self._num_eps

    def gather(self, ep_idx, start, n_batches: int = 1):
        """The slices (ep_idx[i], rows start[i] .. start[i]+H) in the
        update's layout, on the buffer's device: obs [H+1, B, ...], action
        [H, B, A], reward and terminated [H, B, 1], and on multi-task data
        each slice's task (int32 [B]); with n_batches > 1 the slices are n
        batches of B, laid out [n, H(+1), B, ...] (task [n, B]) (JAX
        `_to_batch_layout`, buffer.py:610-630)."""
        T = self._horizon
        st = self._storage
        dev = st['obs'].device
        ep_idx, start = ep_idx.to(dev), start.to(dev)
        rows_obs = start[:, None] + torch.arange(T + 1, device=dev)[None]
        rows_act = rows_obs[:, 1:]
        ep_b = ep_idx[:, None]
        if self._obs_frame_shape is None:
            obs = st['obs'][ep_b, rows_obs]
        else:
            obs = self._restack(st['obs'], ep_b, start)
        action = st['action'][ep_b, rows_act]
        reward = st['reward'][ep_b, rows_act]
        terminated = (st['terminated'][ep_b, rows_act] if 'terminated' in st
                      else torch.zeros_like(reward))
        out = (obs, action, reward[..., None], terminated[..., None])
        if self._task_store is None:
            task = ()
        else:
            task = (self._task_store[ep_idx].reshape(n_batches, -1)
                    .to(self.device),)
            task = (task[0][0],) if n_batches == 1 else task
        if n_batches == 1:
            return tuple(x.transpose(0, 1).to(self.device).contiguous()
                         for x in out) + task
        # [n*B, T(+1), ...] -> [n, T(+1), B, ...]
        return tuple(
            x.reshape(n_batches, -1, *x.shape[1:]).transpose(1, 2)
            .to(self.device).contiguous() for x in out) + task

    def _restack(self, frames, ep_b, start):
        """The slices' pixel stacks [NB, T+1, fs*c, H, W] uint8 on the
        buffer's device: the frames of rows start-fs+1 .. start+T, clipped
        at 0 (JAX buffer.py:587-588), gathered where the ring is, then
        restacked oldest first (a flat concat of fs frames is their channel
        concat, a frame being (c, H, W)-contiguous)."""
        fs, T = self._frame_stack, self._horizon
        dev = frames.device
        f_rows = torch.clamp(
            start[:, None] + torch.arange(-(fs - 1), T + 1, device=dev)[None], min=0)
        got = frames[ep_b, f_rows].to(self.device)          # [NB, T+fs, c*H*W]
        win = (torch.arange(T + 1, device=self.device)[:, None]
               + torch.arange(fs, device=self.device)[None])  # [T+1, fs]
        c, h, w = self._obs_frame_shape
        return got[:, win].reshape(got.shape[0], T + 1, fs * c, h, w)

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
        self._draws += 1
        ep_idx, start = draw_slice_indices(
            self._generator, self._ep_rows,
            min(self._num_eps, self._capacity_eps), n * self._batch_size,
            self._horizon, self._capacity_eps)
        return self.gather(ep_idx, start, n)

    def save_snapshot(self, fp, max_episodes: int) -> int:
        """Write the newest `max_episodes` episodes of the ring to `fp` (npz,
        the storage dtypes kept; JAX buffer.py:290-334). Returns the env
        steps they hold (valid rows less each bootstrap row). A resumed run
        restores them (`load_snapshot`): resuming a trained agent against an
        empty buffer destabilises it even behind the refill gate."""
        if self._storage is None or self._num_eps == 0:
            return 0
        k = min(int(max_episodes), self._num_eps, self._capacity_eps)
        idxs = torch.tensor([(self._num_eps - k + i) % self._capacity_eps
                             for i in range(k)], device=self._ep_rows.device)
        out = {f'ep__{name}': arr[idxs].cpu().numpy()
               for name, arr in self._storage.items()}
        rows = self._ep_rows[idxs].cpu().numpy().astype(np.int32)
        out['valid_rows'] = rows
        if self._task_store is not None:
            out['task'] = self._task_store[idxs].cpu().numpy().astype(np.int32)
        if self._obs_frame_shape is not None:
            out['meta_frame_shape'] = np.array(self._obs_frame_shape, np.int32)
        with open(fp, 'wb') as f:
            np.savez(f, **out)
        return int(rows.astype(np.int64).sum() - k)

    def load_snapshot(self, fp) -> int:
        """Write a `save_snapshot` file (the port's or the JAX buffer's) into
        the buffer through `load` (JAX buffer.py:336-352). Returns the env
        steps restored, the refill gate's credit."""
        with np.load(fp, allow_pickle=False) as data:
            if 'meta_frame_shape' in data.files:     # flat unstacked frames
                self._obs_frame_shape = tuple(
                    int(x) for x in data['meta_frame_shape'])
            episodes = {n[4:]: data[n] for n in data.files if n.startswith('ep__')}
            rows = data['valid_rows'].astype(np.int32)
            episodes['valid_rows'] = rows
            if 'task' in data.files:
                episodes['task'] = data['task']
        self.load(episodes)
        return int(rows.astype(np.int64).sum() - rows.shape[0])

    def close(self):
        """Nothing runs beside the buffer; kept for the trainer's teardown."""
