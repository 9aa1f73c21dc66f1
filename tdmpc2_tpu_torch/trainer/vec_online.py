"""Vectorised single-task online trainer, cfg.num_envs > 1 (port of
tdmpc2_tpu/trainer/vec_online.py).

N env copies stepped together, one batched `act` per vector step (one
pass of the planner's kernels for all N envs), and N updates per vector
step, which keeps the reference's one update per env step (reference
tdmpc2/trainer/online_trainer.py:115-122). After the seed phase a
`seed_steps // n` x `update_many(n)` burst (plus the remainder as single
updates) pretrains on the seed data.

Episode boundaries are tracked per env slot: each slot flushes its own
episode (with the NaN bootstrap row) and is reset on its own. After the
burst a vector step plans and queues its updates with one `vec_step` call
(the plan's graph replay, the updates' replays, then one fetch of the
actions) before the envs step. It gives the numbers of the JAX trainer's
three schedules (vec_online.py:132-181), which are equal on the same
draws. `fused_step` and `overlap_update` are accepted, so that a JAX
recipe runs unchanged, and select nothing: the JAX agent's `act_collect`
and `update_many_fused` would be `act` and `update_many` here, the same
replays in another order, and `vec_step` measured the faster of the two
orders on the toy env (PERF.md). A failure raises: the JAX trainer's
fallback to the unfused calls (and its double count of update credit
there, ROADMAP C) has no counterpart.

Evaluation reuses the training envs; in-progress training episodes are
discarded at eval boundaries (only complete episodes enter the buffer).
`resume=true` continues as the one-env trainer does (its refill gate, no
burst after a resume; JAX vec_online.py:105-122).
"""

from __future__ import annotations

import numpy as np

from tdmpc2_tpu_torch.trainer.online import OnlineTrainer
from tdmpc2_tpu_torch.utils.phase import PhaseTimer


class VecOnlineTrainer(OnlineTrainer):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._n = self.env.num_envs

    # -- per-slot episode buffers -------------------------------------------

    def _start_episodes(self, obs):
        n = self._n
        self._ep_obs = [None] * n
        self._ep_action = [None] * n
        self._ep_reward = [None] * n
        self._ep_terminated = [None] * n
        for i in range(n):
            self._reset_episode_at(i, obs[i])

    def _reset_episode_at(self, i, obs_i):
        self._ep_obs[i] = [np.asarray(obs_i)]
        self._ep_action[i] = [np.full(self.env.action_space.shape, np.nan,
                                        np.float32)]
        self._ep_reward[i] = [np.nan]
        self._ep_terminated[i] = [np.nan]

    def _record_steps(self, obs, actions, rewards, infos):
        for i in range(self._n):
            self._ep_obs[i].append(np.asarray(obs[i]))
            self._ep_action[i].append(np.asarray(actions[i], np.float32))
            self._ep_reward[i].append(float(rewards[i]))
            self._ep_terminated[i].append(float(infos[i]['terminated']))

    def _flush_episode_at(self, i):
        return self.buffer.add(dict(
            obs=np.stack(self._ep_obs[i]),
            action=np.stack(self._ep_action[i]),
            reward=np.asarray(self._ep_reward[i], np.float32),
            terminated=np.asarray(self._ep_terminated[i], np.float32),
            valid_rows=len(self._ep_obs[i])))

    # -- evaluation -----------------------------------------------------------

    def eval(self):
        """Batched greedy evaluation: all env copies run episodes in
        parallel; slots that finish are reset and no longer counted, until
        cfg.eval_episodes episodes are counted."""
        n = self._n
        rewards, successes, lengths = [], [], []
        while len(rewards) < self.cfg.eval_episodes:
            obs = self.env.reset()
            ep_reward = np.zeros(n)
            t = np.zeros(n, np.int64)
            active = np.ones(n, bool)
            while active.any():
                actions = self.agent.act(obs, t0=(t == 0), eval_mode=True)
                obs, rews, dones, infos = self.env.step(actions)
                ep_reward += rews * active
                t += 1
                for i in np.flatnonzero(np.asarray(dones) & active):
                    active[i] = False
                    rewards.append(float(ep_reward[i]))
                    successes.append(infos[i].get('success', 0.0))
                    lengths.append(int(t[i]))
                for i in np.flatnonzero(dones):
                    obs[i] = self.env.reset_at(i)
                    t[i] = 0
        return dict(episode_reward=float(np.nanmean(rewards)),
                    episode_success=float(np.nanmean(successes)),
                    episode_length=float(np.nanmean(lengths)))

    # -- training -------------------------------------------------------------

    def _collect_and_update(self, obs, t0, pretrained, timer, train_metrics):
        """Actions for one vector step, with this step's updates queued
        before the envs step (JAX vec_online.py:126-181). Returns (actions,
        pretrained)."""
        cfg, n = self.cfg, self._n
        if pretrained and self._step > cfg.seed_steps:
            k = self._updates_due(n) if self._updates_now() else 0
            actions, info = self.agent.vec_step(self.buffer, obs, t0, k)
            if info is not None:
                train_metrics.update(info)
            timer.mark('act')
            return actions, pretrained
        if self._step > cfg.seed_steps:
            actions = self.agent.act(obs, t0=t0)
        else:
            actions = self.env.rand_act()
        timer.mark('act')
        # queue the updates before stepping the envs: they only read replay
        if self._updates_now():
            info = None
            if not pretrained:
                pretrained = True
                print('Pretraining agent on seed data...')
                for _ in range(cfg.seed_steps // n):
                    info = self.agent.update_many(self.buffer, n)
                for _ in range(cfg.seed_steps % n):
                    info = self.agent.update(self.buffer)
            else:
                k = self._updates_due(n)      # n unless update_ratio < 1
                info = self.agent.update_many(self.buffer, k) if k else None
            if info is not None:
                train_metrics.update(info)
        timer.mark('update')
        return actions, pretrained

    def train(self):
        cfg = self.cfg
        n = self._n
        self.maybe_resume()
        train_metrics = {}
        next_eval_at = (self._step // cfg.eval_freq) * cfg.eval_freq
        ep_rewards, ep_successes, ep_lengths, ep_terms = [], [], [], []
        pretrained = self._resumed      # no burst after a resume
        obs = None
        timer = PhaseTimer(steps_per_mark=n)

        while self._step <= cfg.steps:
            if self._step >= next_eval_at:
                eval_metrics = self.eval()
                eval_metrics.update(self.common_metrics())
                self.logger.log(eval_metrics, 'eval')
                self._checkpoint()
                next_eval_at += cfg.eval_freq
                obs = None  # train episodes were interrupted by eval

            if obs is None:
                obs = self.env.reset()
                self._start_episodes(obs)
                t_in_ep = np.zeros(n, np.int64)

            timer.reset()
            actions, pretrained = self._collect_and_update(
                obs, t_in_ep == 0, pretrained, timer, train_metrics)

            obs, rewards, dones, infos = self.env.step(actions)
            timer.mark('env')
            self._record_steps(obs, actions, rewards, infos)
            t_in_ep += 1
            self._step += n

            for i in np.flatnonzero(dones):
                if infos[i].get('terminated', 0) and not cfg.episodic:
                    raise ValueError(
                        'Termination detected but episodic=false. Set '
                        'episodic=true to enable termination support.')
                self._ep_idx = self._flush_episode_at(i)
                ep_rewards.append(float(np.nansum(self._ep_reward[i][1:])))
                ep_successes.append(infos[i].get('success', 0.0))
                ep_lengths.append(len(self._ep_obs[i]) - 1)
                ep_terms.append(infos[i].get('terminated', 0.0))
                obs[i] = self.env.reset_at(i)
                self._reset_episode_at(i, obs[i])
                t_in_ep[i] = 0
            timer.mark('flush')
            timer.step()

            if ep_rewards and (len(ep_rewards) >= n or dones[0]):
                train_metrics.update(
                    episode_reward=float(np.mean(ep_rewards)),
                    episode_success=float(np.mean(ep_successes)),
                    episode_length=float(np.mean(ep_lengths)),
                    episode_terminated=float(np.mean(ep_terms)),
                    num_episodes=len(ep_rewards))
                train_metrics.update(self.common_metrics())
                self.logger.log(train_metrics, 'train')
                ep_rewards, ep_successes, ep_lengths, ep_terms = [], [], [], []

        # final-boundary eval: _step advances n per iteration and can jump
        # past cfg.steps, skipping the eval owed exactly at the horizon
        if next_eval_at <= cfg.steps:
            eval_metrics = self.eval()
            eval_metrics.update(self.common_metrics())
            self.logger.log(eval_metrics, 'eval')
            self._checkpoint()

        self.finish()
