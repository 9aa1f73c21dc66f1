"""Fleet online trainer: K seeds x N env copies of one task in one process
(port of tdmpc2_tpu/trainer/fleet_online.py).

Each seed gets what K single-seed runs would give it: its eval.csv and
checkpoints under logs/<task>/<seed>/<exp>/, the layout single-seed runs
use. The reference loop's semantics hold a seed at a time (reference
tdmpc2/trainer/online_trainer.py:74-127): random actions for the first
seed_steps, a seed_steps burst at the first update, one update per env
step, episodes buffered with the NaN bootstrap row, per-slot episode
boundaries (episodic tasks too). A vector step is one `FleetAgent.step`
after the burst (every seed's plan, N updates a seed, one fetch of the
actions) before the K x N envs step.

Updates wait until every seed has an episode (`FleetBuffer.num_eps` is the
smallest per-seed count), so an episodic fleet, or a resumed one, stalls
all seeds alike: the owed updates are one counter (`_update_deficit`, a
multiple of N), accrued while the gate is closed, folded into the burst or
drained at twice the rate after it, which restores one update per env step
(JAX fleet_online.py:16-27). `fused_step` and `overlap_update` select
nothing, as in the vectorised trainer. A failure raises: the JAX trainer's
fallback to unfused dispatches (fleet_online.py:259-266) has no
counterpart.
"""

from __future__ import annotations

import os
import zipfile
from time import time

import numpy as np

from tdmpc2_tpu_torch.utils import tree
from tdmpc2_tpu_torch.utils.phase import PhaseTimer


class FleetOnlineTrainer:
    def __init__(self, cfg, env, agent, buffer, loggers):
        self.cfg = cfg
        self.env = env          # the flat K*N VecEnv (envs.make_fleet_env)
        self.agent = agent      # FleetAgent
        self.buffer = buffer    # FleetBuffer
        self.loggers = loggers  # one Logger a seed
        self.K = agent.K
        self.N = env.num_envs // agent.K
        if env.num_envs != self.K * self.N:
            raise ValueError(f'{env.num_envs} env copies for {self.K} seeds')
        n_params = sum(int(p.numel()) for p in
                       tree.leaves(agent.agents[0].state.params))
        print(f'Agent parameters: {n_params:,} x {self.K} seeds')
        self._step = 0                 # env steps a seed
        self._n_updates = 0            # updates a seed
        self._update_deficit = 0       # owed updates (a multiple of N)
        self._ep_idx = np.zeros(self.K, np.int64)
        self._start_time = time()
        self._sps_anchor = 0
        self._resumed = False
        self._resume_step = 0
        self._refill_credit = 0

    def common_metrics(self, k: int):
        elapsed = time() - self._start_time
        return dict(step=self._step, episode=int(self._ep_idx[k]),
                    elapsed_time=elapsed,
                    steps_per_second=(self._step - self._sps_anchor)
                    / max(elapsed, 1e-9))

    def _obs_kn(self, obs_flat):
        obs_flat = np.asarray(obs_flat)
        return obs_flat.reshape((self.K, self.N) + obs_flat.shape[1:])

    # -- per-slot episode buffers (slot j = k*N + i) ---------------------------

    def _start_episodes(self, obs_flat):
        kn = self.K * self.N
        self._ep_obs, self._ep_action = [None] * kn, [None] * kn
        self._ep_reward, self._ep_terminated = [None] * kn, [None] * kn
        for j in range(kn):
            self._reset_episode_at(j, obs_flat[j])

    def _reset_episode_at(self, j, obs_j):
        self._ep_obs[j] = [np.asarray(obs_j)]
        self._ep_action[j] = [np.full(self.env.action_space.shape, np.nan,
                                        np.float32)]
        self._ep_reward[j] = [np.nan]
        self._ep_terminated[j] = [np.nan]

    def _record_steps(self, obs_flat, actions_flat, rewards, infos):
        for j in range(self.K * self.N):
            self._ep_obs[j].append(np.asarray(obs_flat[j]))
            self._ep_action[j].append(np.asarray(actions_flat[j], np.float32))
            self._ep_reward[j].append(float(rewards[j]))
            self._ep_terminated[j].append(float(infos[j]['terminated']))

    def _episode_rows(self, j):
        """Slot j's episode, zero-padded to the ring's rows, and its length."""
        rows = self.buffer._rows
        n = len(self._ep_obs[j])

        def padto(x):
            x = np.asarray(np.stack(x) if np.ndim(x[0]) else x, np.float32)
            if x.shape[0] < rows:
                x = np.pad(x, [(0, rows - x.shape[0])] + [(0, 0)] * (x.ndim - 1))
            return x
        return dict(obs=padto(self._ep_obs[j]), action=padto(self._ep_action[j]),
                    reward=padto(self._ep_reward[j]),
                    terminated=padto(self._ep_terminated[j])), n

    def _flush_seed(self, k, done_slots):
        """Seed k's finished episodes in one buffer write."""
        eps, valids = [], []
        for j in done_slots:
            ep, n = self._episode_rows(j)
            eps.append(ep)
            valids.append(n)
        block = {key: np.stack([e[key] for e in eps]) for key in eps[0]}
        block['valid_rows'] = np.asarray(valids, np.int32)
        self._ep_idx[k] = self.buffer.add(k, block)

    # -- resume / checkpoints ---------------------------------------------------

    def _ckpt_path(self, k):
        return self.agent.work_dir(k) / 'models' / 'latest.pkl'

    def _snapshot_path(self):
        return self._ckpt_path(0).parent / 'fleet_buffer.npz'

    def maybe_resume(self):
        """With resume=true and a checkpoint for every seed: each seed's
        state and generator, the smallest step, the episode counters, and
        fleet_buffer.npz (JAX fleet_online.py:142-171)."""
        if not self.cfg.resume or self._resumed:
            return
        fps = [self._ckpt_path(k) for k in range(self.K)]
        if not all(fp.exists() for fp in fps):
            print('resume=true but not every seed has a checkpoint; '
                  'starting fresh.')
            return
        extras = self.agent.load_seeds(fps)
        self._step = min(int(e.get('step', 0)) for e in extras)
        self._sps_anchor = self._resume_step = self._step
        self._ep_idx = np.asarray([int(e.get('ep_idx', 0)) for e in extras],
                                  np.int64)
        self._resumed = True
        print(f'Resumed fleet ({self.K} seeds) at step {self._step:,}.')
        snap = self._snapshot_path()
        if snap.exists():
            try:
                self._refill_credit = self.buffer.load_snapshot(snap)
            except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
                # a damaged snapshot must not stop the resume
                print(f'Fleet replay snapshot restore failed '
                      f'({type(e).__name__}: {e}); continuing empty.')
            else:
                print(f'Restored fleet replay snapshot ({self._refill_credit:,} '
                      'steps a seed of refill credit).')

    def _refill_done(self) -> bool:
        """After a resume, no updates and no owed updates until the restored
        policies have collected cfg.resume_refill_steps env steps, the
        snapshot's steps counted; always True on a fresh run."""
        if not self._resumed:
            return True
        gate = int(self.cfg.get('resume_refill_steps', 0) or 0)
        return self._step - self._resume_step + self._refill_credit >= gate

    def _checkpoint(self):
        if not self.cfg.save_agent:
            return
        for k in range(self.K):
            self.agent.save_seed(k, self._ckpt_path(k), extra=dict(
                step=self._step, ep_idx=int(self._ep_idx[k])))
        n_snap = int(self.cfg.get('buffer_snapshot_eps', 0) or 0)
        if n_snap > 0 and self.buffer.num_eps > 0:
            snap = self._snapshot_path()
            tmp = snap.with_name(snap.name + '.tmp')
            try:        # written whole, then renamed
                self.buffer.save_snapshot(tmp, n_snap)
                os.replace(tmp, snap)
            except OSError as e:         # snapshots are best-effort
                print(f'Fleet replay snapshot save failed '
                      f'({type(e).__name__}: {e})')

    # -- evaluation -------------------------------------------------------------

    def eval(self):
        """Greedy evaluation of every seed at once: each seed's N copies run
        episodes until every seed has cfg.eval_episodes of them."""
        K, N = self.K, self.N
        rewards = [[] for _ in range(K)]
        successes = [[] for _ in range(K)]
        lengths = [[] for _ in range(K)]
        while any(len(r) < self.cfg.eval_episodes for r in rewards):
            obs = self.env.reset()
            ep_reward = np.zeros(K * N)
            t = np.zeros(K * N, np.int64)
            active = np.ones(K * N, bool)
            while active.any():
                acts = self.agent.act(self._obs_kn(obs),
                                      t0=(t == 0).reshape(K, N), eval_mode=True)
                obs, rews, dones, infos = self.env.step(acts.reshape(K * N, -1))
                ep_reward += rews * active
                t += 1
                for j in np.flatnonzero(np.asarray(dones) & active):
                    active[j] = False
                    k = j // N
                    if len(rewards[k]) < self.cfg.eval_episodes:
                        rewards[k].append(float(ep_reward[j]))
                        successes[k].append(infos[j].get('success', 0.0))
                        lengths[k].append(int(t[j]))
                for j in np.flatnonzero(dones):
                    obs[j] = self.env.reset_at(j)
                    t[j] = 0
        return [dict(episode_reward=float(np.nanmean(rewards[k])),
                     episode_success=float(np.nanmean(successes[k])),
                     episode_length=float(np.nanmean(lengths[k])))
                for k in range(K)]

    def _log_eval(self):
        for k, em in enumerate(self.eval()):
            em.update(self.common_metrics(k))
            self.loggers[k].log(em, 'eval')
        self._checkpoint()

    # -- training ---------------------------------------------------------------

    def _drain(self, train_metrics):
        """One more N updates a seed while updates are owed."""
        if self._update_deficit > 0:
            train_metrics.update(self.agent.update_many(self.buffer, self.N))
            self._update_deficit -= self.N
            self._n_updates += self.N

    def _collect_and_update(self, obs, t0, pretrained, timer, train_metrics):
        """Actions for one vector step, this step's updates queued first
        (JAX fleet_online.py:255-341). Returns (actions [K*N, A], pretrained)."""
        cfg, K, N = self.cfg, self.K, self.N
        if (pretrained and self._step > cfg.seed_steps
                and self.buffer.num_eps > 0 and self._refill_done()):
            actions, info = self.agent.step(self.buffer, self._obs_kn(obs),
                                            t0.reshape(K, N), N)
            train_metrics.update(info)
            self._n_updates += N
            self._drain(train_metrics)
            timer.mark('act')
            return actions.reshape(K * N, -1), pretrained
        if self._step > cfg.seed_steps:
            actions = self.agent.act(self._obs_kn(obs),
                                     t0=t0.reshape(K, N)).reshape(K * N, -1)
        else:
            actions = self.env.rand_act()
        timer.mark('act')
        if self._step >= cfg.seed_steps and self._refill_done():
            if self.buffer.num_eps > 0:
                if not pretrained:
                    pretrained = True
                    # updates owed while the slowest seed finished its
                    # first episode join the burst
                    burst = cfg.seed_steps + self._update_deficit
                    self._update_deficit = 0
                    print(f'Pretraining agents on seed data ({burst} updates '
                          'a seed)...')
                    for _ in range(burst // N):
                        train_metrics.update(self.agent.update_many(self.buffer, N))
                    if burst % N:
                        train_metrics.update(
                            self.agent.update_many(self.buffer, burst % N))
                    self._n_updates += burst
                else:
                    train_metrics.update(self.agent.update_many(self.buffer, N))
                    self._n_updates += N
                    self._drain(train_metrics)
            else:
                # the gate is closed (the slowest seed has no episode yet,
                # or a resumed session's empty buffer): updates are owed
                self._update_deficit += N
        timer.mark('update')
        return actions, pretrained

    def train(self):
        cfg, K, N = self.cfg, self.K, self.N
        self.maybe_resume()
        train_metrics = {}
        next_eval_at = (self._step // cfg.eval_freq) * cfg.eval_freq
        ep_stats = [dict(r=[], s=[], l=[], t=[]) for _ in range(K)]
        pretrained = self._resumed
        obs = None
        timer = PhaseTimer(steps_per_mark=N, suffix='env-steps/s a seed')

        while self._step <= cfg.steps:
            if self._step >= next_eval_at:
                self._log_eval()
                next_eval_at += cfg.eval_freq
                obs = None      # eval interrupted the train episodes

            if obs is None:
                obs = self.env.reset()
                self._start_episodes(obs)
                t_in_ep = np.zeros(K * N, np.int64)

            timer.reset()
            actions, pretrained = self._collect_and_update(
                obs, t_in_ep == 0, pretrained, timer, train_metrics)

            obs, rewards, dones, infos = self.env.step(actions)
            timer.mark('env')
            self._record_steps(obs, actions, rewards, infos)
            t_in_ep += 1
            self._step += N

            done_idx = np.flatnonzero(dones)
            for k in range(K):
                slots = [j for j in done_idx if j // N == k]
                if not slots:
                    continue
                for j in slots:
                    if infos[j].get('terminated', 0) and not cfg.episodic:
                        raise ValueError(
                            'Termination detected but episodic=false. Set '
                            'episodic=true to enable termination support.')
                    ep_stats[k]['r'].append(float(np.nansum(self._ep_reward[j][1:])))
                    ep_stats[k]['s'].append(infos[j].get('success', 0.0))
                    ep_stats[k]['l'].append(len(self._ep_obs[j]) - 1)
                    ep_stats[k]['t'].append(infos[j].get('terminated', 0.0))
                self._flush_seed(k, slots)
                for j in slots:
                    obs[j] = self.env.reset_at(j)
                    self._reset_episode_at(j, obs[j])
                    t_in_ep[j] = 0
            timer.mark('flush')
            timer.step()

            if any(len(st['r']) >= N for st in ep_stats) or (
                    dones[0] and ep_stats[0]['r']):
                for k in range(K):
                    if not ep_stats[k]['r']:
                        continue
                    m = dict(train_metrics)
                    m.update(episode_reward=float(np.mean(ep_stats[k]['r'])),
                             episode_success=float(np.mean(ep_stats[k]['s'])),
                             episode_length=float(np.mean(ep_stats[k]['l'])),
                             episode_terminated=float(np.mean(ep_stats[k]['t'])),
                             num_episodes=len(ep_stats[k]['r']))
                    m.update(self.common_metrics(k))
                    self.loggers[k].log(m, 'train')
                    ep_stats[k] = dict(r=[], s=[], l=[], t=[])

        # the eval owed at the horizon: _step jumps by N past cfg.steps
        if next_eval_at <= cfg.steps:
            self._log_eval()
        self.finish()

    def finish(self):
        """The final checkpoint, the loggers, then the env's worker
        processes, if it has any (JAX trainer/fleet_online.py:421-428)."""
        self._checkpoint()
        for lg in self.loggers:
            lg.finish(agent=None)
        if hasattr(self.env, 'close'):
            self.env.close()
