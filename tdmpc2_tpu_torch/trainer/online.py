"""Single-task online trainer (port of tdmpc2_tpu/trainer/online.py;
reference tdmpc2/trainer/online_trainer.py:9-127).

Random actions for the first `seed_steps` steps, a `seed_steps`-update
pretraining burst at the first update, then updates every step by
`update_ratio`; episodes are buffered with a leading bootstrap row (NaN
action, reward and terminated); periodic evaluation, each followed by the
'latest' checkpoint and, with `buffer_snapshot_eps`, a snapshot of the
newest replay episodes.

`resume=true` continues from work_dir/models/latest.pkl (JAX
online.py:82-121): the train state, both generators, the step and episode
counters and the snapshot; then no updates (and no burst) until the
restored policy has collected `resume_refill_steps` env steps, the
snapshot's steps counted.

`profile_dir` (JAX online.py:203-210): at the first step after the burst
that owes one update, ten updates run under `torch.profiler` (on the card
ten replays of the update's graph) in its place, and the trace is written
to `profile_dir/updates.trace.json` (Chrome's trace format), once a run.
"""

from __future__ import annotations

import os
import zipfile
from pathlib import Path
from time import time

import numpy as np
import torch

from tdmpc2_tpu_torch.trainer.base import Trainer


class OnlineTrainer(Trainer):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._step = 0
        self._ep_idx = 0
        self._start_time = time()
        self._upd_credit = 0.0
        self._sps_anchor = 0    # steps done before this process started
        self._resumed = False
        self._resume_step = 0
        self._refill_credit = 0
        self._profiled = False

    def common_metrics(self):
        elapsed = time() - self._start_time
        return dict(step=self._step, episode=self._ep_idx,
                    elapsed_time=elapsed,
                    # a resumed run: this process's steps over its time
                    steps_per_second=(self._step - self._sps_anchor)
                    / max(elapsed, 1e-9))

    def eval(self):
        """Greedy-planning episodes (reference online_trainer.py:28-52)."""
        rewards, successes, lengths = [], [], []
        for _ in range(self.cfg.eval_episodes):
            obs, done, ep_reward, t, info = self.env.reset(), False, 0.0, 0, {}
            while not done:
                action = self.agent.act(obs, t0=(t == 0), eval_mode=True)
                obs, reward, done, info = self.env.step(action)
                ep_reward += reward
                t += 1
            rewards.append(ep_reward)
            successes.append(info.get('success', 0.0))
            lengths.append(t)
        return dict(episode_reward=float(np.nanmean(rewards)),
                    episode_success=float(np.nanmean(successes)),
                    episode_length=float(np.nanmean(lengths)))

    def _start_episode(self, obs):
        """Begin an episode with the bootstrap row (reference
        online_trainer.py:54-72)."""
        self._ep_obs = [np.asarray(obs)]
        self._ep_action = [np.full(self.env.action_space.shape, np.nan,
                                   np.float32)]
        self._ep_reward = [np.nan]
        self._ep_terminated = [np.nan]

    def _record_step(self, obs, action, reward, terminated):
        self._ep_obs.append(np.asarray(obs))
        self._ep_action.append(np.asarray(action, np.float32))
        self._ep_reward.append(float(reward))
        self._ep_terminated.append(float(terminated))

    def _episode_dict(self):
        return dict(
            obs=np.stack(self._ep_obs),
            action=np.stack(self._ep_action),
            reward=np.asarray(self._ep_reward, np.float32),
            terminated=np.asarray(self._ep_terminated, np.float32),
            valid_rows=len(self._ep_obs))

    def _updates_due(self, n):
        """Updates owed for `n` collected env steps under cfg.update_ratio,
        with fractional credit carried over. As in the JAX trainer, a ratio
        of 0 counts as 1 (`or 1.0`): a fault kept on purpose so that the
        port does what the JAX package does (ROADMAP C)."""
        r = float(self.cfg.get('update_ratio', 1.0) or 1.0)
        if r == 1.0:
            return n
        self._upd_credit += n * r
        k = int(self._upd_credit)
        self._upd_credit -= k
        return k

    def _models(self) -> Path:
        return Path(self.cfg.work_dir) / 'models'

    def maybe_resume(self):
        """With resume=true, load work_dir/models/latest.pkl into the agent
        and the buffer's generator, take its step and episode counters, and
        write its replay snapshot (buffer.npz) back into the buffer (JAX
        online.py:82-110); without a checkpoint, start fresh. Once per
        trainer."""
        if not self.cfg.resume or self._resumed:
            return
        fp = self._models() / 'latest.pkl'
        if not fp.exists():
            print('resume=true but no checkpoint found; starting fresh.')
            return
        extra = self.agent.load(fp, buffer=self.buffer)
        self._step = int(extra.get('step', 0))
        self._ep_idx = int(extra.get('ep_idx', 0))
        self._sps_anchor = self._resume_step = self._step
        self._resumed = True
        print(f'Resumed from {fp} at step {self._step:,}.')
        snap = fp.parent / 'buffer.npz'
        if snap.exists():
            try:
                self._refill_credit = self.buffer.load_snapshot(snap)
            except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
                # a damaged snapshot must not stop the resume
                print(f'Replay snapshot restore failed ({type(e).__name__}: '
                      f'{e}); continuing with an empty buffer.')
            else:
                print(f'Restored replay snapshot: {self.buffer.num_eps} '
                      f'episodes, {self._refill_credit:,} steps of refill '
                      'credit.')

    def _refill_done(self) -> bool:
        """The update gate after a resume: True once the restored policy
        has collected cfg.resume_refill_steps env steps, a restored
        snapshot's steps counted (JAX online.py:112-121); always True on a
        fresh run."""
        if not self._resumed:
            return True
        gate = int(self.cfg.get('resume_refill_steps', 0) or 0)
        return self._step - self._resume_step + self._refill_credit >= gate

    def _checkpoint(self):
        """The 'latest' checkpoint, with the buffer's generator, and with
        buffer_snapshot_eps > 0 the newest episodes in models/buffer.npz,
        written to a temporary file and renamed (JAX online.py:136-149)."""
        self.logger.save_agent(
            self.agent, identifier='latest',
            extra=dict(step=self._step, ep_idx=self._ep_idx),
            buffer=self.buffer)
        k = int(self.cfg.get('buffer_snapshot_eps', 0) or 0)
        if k > 0 and self.buffer.num_eps > 0:
            snap = self._models() / 'buffer.npz'
            snap.parent.mkdir(parents=True, exist_ok=True)
            tmp = snap.with_name('buffer.npz.tmp')
            try:
                self.buffer.save_snapshot(tmp, k)
                os.replace(tmp, snap)
            except OSError as e:         # snapshots are best-effort
                print(f'Replay snapshot save failed ({type(e).__name__}: {e})')

    def _updates_now(self) -> bool:
        """Whether this step updates: past the seed phase, with data, and
        past a resume's refill gate."""
        return (self._step >= self.cfg.seed_steps and self.buffer.num_eps > 0
                and self._refill_done())

    def _profile_updates(self, n) -> dict:
        """n updates under torch.profiler, their trace written to
        cfg.profile_dir; returns the last update's info."""
        from torch.profiler import ProfilerActivity, profile
        on_card = self.agent.device.type == 'cuda'
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=activities) as prof:
            for _ in range(n):
                info = self.agent.update(self.buffer)
            if on_card:
                torch.cuda.synchronize(self.agent.device)
        out = Path(self.cfg.profile_dir) / 'updates.trace.json'
        out.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out))
        if on_card:
            device = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            print(f'Profiled {n} updates into {out}: {len(device) / n:.0f} '
                  'device activities an update')
        else:
            print(f'Profiled {n} updates into {out} (on the CPU)')
        return info

    def train(self):
        """Main loop (reference online_trainer.py:74-127)."""
        cfg = self.cfg
        self.maybe_resume()
        train_metrics, done, eval_next = {}, True, False
        info = {}
        while self._step <= cfg.steps:
            if self._step % cfg.eval_freq == 0:
                eval_next = True

            if done:
                if eval_next:
                    eval_metrics = self.eval()
                    eval_metrics.update(self.common_metrics())
                    self.logger.log(eval_metrics, 'eval')
                    eval_next = False
                    self._checkpoint()

                if self._step > 0 and hasattr(self, '_ep_obs'):
                    if info.get('terminated', 0) and not cfg.episodic:
                        raise ValueError(
                            'Termination detected but episodic=false. Set '
                            'episodic=true to enable termination support.')
                    train_metrics.update(
                        episode_reward=float(np.nansum(self._ep_reward[1:])),
                        episode_success=info.get('success', 0.0),
                        episode_length=len(self._ep_obs) - 1,
                        episode_terminated=info.get('terminated', 0.0))
                    train_metrics.update(self.common_metrics())
                    self.logger.log(train_metrics, 'train')
                    self._ep_idx = self.buffer.add(self._episode_dict())

                obs = self.env.reset()
                self._start_episode(obs)

            # collect experience
            if self._step > cfg.seed_steps:
                action = self.agent.act(obs, t0=len(self._ep_obs) == 1)
            else:
                action = self.env.rand_act()
            obs, reward, done, info = self.env.step(action)
            self._record_step(obs, action, reward, info['terminated'])

            # update the agent; its metrics stay on the device until the
            # logger converts them at the end of the episode
            if self._updates_now():
                if self._step == cfg.seed_steps and not self._resumed:
                    num_updates = cfg.seed_steps
                    print('Pretraining agent on seed data...')
                else:
                    num_updates = self._updates_due(1)
                if cfg.profile_dir and num_updates == 1 and not self._profiled:
                    self._profiled = True
                    train_metrics.update(self._profile_updates(10))
                else:
                    for _ in range(num_updates):
                        train_metrics.update(self.agent.update(self.buffer))

            self._step += 1

        self.finish()
