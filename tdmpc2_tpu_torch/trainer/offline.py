"""Multi-task offline trainer (port of tdmpc2_tpu/trainer/offline.py;
reference tdmpc2/trainer/offline_trainer.py:15-94).

Loads a fixed multi-task dataset into the replay buffer, runs `cfg.steps`
gradient iterations, and every `eval_freq` iterations evaluates every
task, prints the per-domain aggregate (`Logger.pprint_multitask`) and
saves a checkpoint.

- Datasets are native `.npz` chunks (arrays 'obs', 'action', 'reward',
  'task' shaped [episodes, rows, ...], 'task' [episodes] or
  [episodes, rows]), or the published TensorDict `.pt` chunks, read
  without tensordict (`utils/torch_interop.read_tensordict_chunk`). The
  buffer is sized to an npz dataset from the chunks' headers
  (`Buffer.reserve`) and filled chunk by chunk (`Buffer.load`).
- Iterations run in chunks of `update_many` (8 at most), cut so that the
  log, eval and checkpoint boundaries fall on their exact iteration; on
  the card each update is one replay of the update's CUDA graph.
- `eval` runs every task's episodes in lockstep: one `act_tasks` plan a
  step for all tasks (on the card one graph replay of the planner's
  launches), where the reference loops the tasks one after another;
  `_eval_sequential` is that loop, for a pi-only agent or an env without
  sub-envs.
- `resume=true` continues from the newest iteration checkpoint
  (work_dir/models/<iteration>.pkl): the train state, both generators and
  the iteration (JAX offline.py:143-162).
"""

from __future__ import annotations

import os
import zipfile
from glob import glob
from pathlib import Path
from time import time

import numpy as np
from numpy.lib import format as npf

from tdmpc2_tpu_torch.data.buffer import Buffer
from tdmpc2_tpu_torch.trainer.base import Trainer
from tdmpc2_tpu_torch.utils.torch_interop import read_tensordict_chunk

UPDATE_CHUNK = 8   # updates per update_many call (JAX offline.py:169)


def _load_chunk(fp: str) -> dict:
    if fp.endswith('.npz'):
        with np.load(fp) as z:
            return {k: z[k] for k in z.files}
    if fp.endswith('.pt'):
        return read_tensordict_chunk(fp)
    raise ValueError(f'Unknown dataset format: {fp}')


def _npz_episode_count(fp: str) -> int:
    """Episodes in an .npz chunk, from the zip member's header only."""
    with zipfile.ZipFile(fp) as z:
        with z.open('reward.npy') as f:
            read = (npf.read_array_header_1_0 if npf.read_magic(f) == (1, 0)
                    else npf.read_array_header_2_0)
            shape, _, _ = read(f)
    return int(shape[0])


class OfflineTrainer(Trainer):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._start_time = time()

    def eval(self):
        """Every task's eval episodes in lockstep (JAX offline.py:56-95;
        reference offline_trainer.py:22-40 loops the tasks)."""
        envs = getattr(self.env, 'envs', None)
        if envs is None or not self.cfg.mpc:
            return self._eval_sequential()
        n = len(envs)
        H, A = self.cfg.horizon, self.cfg.action_dim
        a_dims = self.env.action_dims
        rewards = [[] for _ in range(n)]
        successes = [[] for _ in range(n)]
        for _ in range(self.cfg.eval_episodes):
            obs = np.stack([self.env._pad(e.reset()) for e in envs])
            prev_mean = np.zeros((n, H, A), np.float32)
            t0 = np.ones(n, bool)
            active = np.ones(n, bool)
            ep_reward = np.zeros(n)
            while active.any():
                actions, prev_mean = self.agent.act_tasks(
                    obs, prev_mean, t0, np.arange(n))
                t0[:] = False
                for i in np.flatnonzero(active):
                    o, r, done, info = envs[i].step(actions[i][: a_dims[i]])
                    obs[i] = self.env._pad(o)
                    ep_reward[i] += r
                    if done:
                        active[i] = False
                        rewards[i].append(float(ep_reward[i]))
                        successes[i].append(info.get('success', 0.0))
        results = {}
        for i, task in enumerate(self.cfg.tasks):
            results[f'episode_reward+{task}'] = float(np.nanmean(rewards[i]))
            results[f'episode_success+{task}'] = float(np.nanmean(successes[i]))
        return results

    def _eval_sequential(self):
        """One task at a time (the reference's loop, JAX offline.py:97-115)."""
        results = {}
        for task_idx, task in enumerate(self.cfg.tasks):
            rewards, successes = [], []
            for _ in range(self.cfg.eval_episodes):
                obs, done, ep_reward, t = self.env.reset(task_idx), False, 0.0, 0
                info = {}
                while not done:
                    action = self.agent.act(
                        obs, t0=(t == 0), eval_mode=True, task=task_idx)
                    obs, reward, done, info = self.env.step(action)
                    ep_reward += reward
                    t += 1
                rewards.append(ep_reward)
                successes.append(info.get('success', 0.0))
            results[f'episode_reward+{task}'] = float(np.nanmean(rewards))
            results[f'episode_success+{task}'] = float(np.nanmean(successes))
        return results

    def _load_dataset(self):
        """Load the dataset chunks (JAX offline.py:117-141; reference
        offline_trainer.py:42-65) into a buffer sized to them."""
        if not self.cfg.data_dir:
            raise ValueError('data_dir must be set for offline training')
        fps = sorted(glob(os.path.join(self.cfg.data_dir, '*.npz'))) or \
            sorted(glob(os.path.join(self.cfg.data_dir, '*.pt')))
        if not fps:
            raise FileNotFoundError(f'No data found in {self.cfg.data_dir}')
        print(f'Found {len(fps)} dataset chunks in {self.cfg.data_dir}')
        # the dataset's buffer geometry (reference offline_trainer.py:52-56)
        _cfg = self.cfg.replace()
        if self.cfg.task == 'mt80':
            _cfg.episode_length, _cfg.buffer_size = 100, 550_450_000
        elif self.cfg.task == 'mt30':
            _cfg.episode_length, _cfg.buffer_size = 500, 345_690_000
        _cfg.steps = _cfg.buffer_size
        self.buffer = Buffer(_cfg, self.agent.device)
        if all(fp.endswith('.npz') for fp in fps):
            self.buffer.reserve(sum(_npz_episode_count(fp) for fp in fps))
        for fp in fps:
            chunk = _load_chunk(fp)
            print(f'  loading {os.path.basename(fp)}: '
                  f'{chunk["reward"].shape[0]} episodes')
            self.buffer.load(chunk)
        print(f'Loaded {self.buffer.num_eps} episodes.')

    def _maybe_resume(self) -> int:
        """With resume=true, load the newest iteration checkpoint of
        work_dir/models into the agent and the buffer's generator; returns
        its iteration, 0 without one (JAX offline.py:143-162)."""
        if not self.cfg.resume:
            return 0
        ckpts = {int(fp.stem): fp
                 for fp in (Path(self.cfg.work_dir) / 'models').glob('*.pkl')
                 if fp.stem.isdigit()}
        if not ckpts:
            print('resume=true but no iteration checkpoint found; '
                  'starting fresh.')
            return 0
        i = max(ckpts)
        self.agent.load(ckpts[i], buffer=self.buffer)
        print(f'Resumed offline training at iteration {i:,}.')
        return i

    def train(self):
        """The offline loop (JAX offline.py:164-209; reference
        offline_trainer.py:67-94)."""
        if not self.cfg.multitask:
            raise ValueError('Offline training requires a multitask cfg.')
        self._load_dataset()
        print(f'Training agent for {self.cfg.steps} iterations...')
        i = self._maybe_resume()
        while i < self.cfg.steps:
            boundary = min(
                x for x in (
                    self.cfg.steps,
                    (i // self.cfg.eval_freq + 1) * self.cfg.eval_freq,
                    (i // 10_000 + 1) * 10_000)
                if x > i)
            k = min(UPDATE_CHUNK, boundary - i)
            train_metrics = (self.agent.update_many(self.buffer, k)
                             if k > 1 else self.agent.update(self.buffer))
            i += k
            if i % self.cfg.eval_freq == 0 or i % 10_000 == 0 or i == self.cfg.steps:
                metrics = dict(iteration=i,
                               elapsed_time=time() - self._start_time)
                metrics.update({k: float(v) for k, v in train_metrics.items()})
                if i % self.cfg.eval_freq == 0:
                    metrics.update(self.eval())
                    score = self.logger.pprint_multitask(metrics, self.cfg)
                    self.logger.save_agent(self.agent, identifier=f'{i}',
                                           buffer=self.buffer)
                    rts = [v for k, v in metrics.items()
                           if k.startswith('episode_reward+')]
                    scs = [v for k, v in metrics.items()
                           if k.startswith('episode_success+')]
                    self.logger.log(dict(
                        step=i,
                        episode_reward=float(np.nanmean(rts)),
                        episode_success=float(np.nanmean(scs)),
                        normalized_score=score), 'eval')
                self.logger.log(metrics, 'pretrain')
        self.finish()
