"""Single-task online trainer (port of tdmpc2_tpu/trainer/online.py;
reference tdmpc2/trainer/online_trainer.py:9-127).

Random actions for the first `seed_steps` steps, a `seed_steps`-update
pretraining burst at the first update, then updates every step by
`update_ratio`; episodes are buffered with a leading bootstrap row (NaN
action, reward and terminated); periodic evaluation. Resuming, buffer
snapshots and profiling are later parts of the port.
"""

from __future__ import annotations

from time import time

import numpy as np

from tdmpc2_tpu_torch.trainer.base import Trainer


class OnlineTrainer(Trainer):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._step = 0
        self._ep_idx = 0
        self._start_time = time()
        self._upd_credit = 0.0

    def common_metrics(self):
        elapsed = time() - self._start_time
        return dict(step=self._step, episode=self._ep_idx,
                    elapsed_time=elapsed,
                    steps_per_second=self._step / max(elapsed, 1e-9))

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

    def _checkpoint(self):
        self.logger.save_agent(
            self.agent, identifier='latest',
            extra=dict(step=self._step, ep_idx=self._ep_idx))

    def train(self):
        """Main loop (reference online_trainer.py:74-127)."""
        cfg = self.cfg
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
            if self._step >= cfg.seed_steps and self.buffer.num_eps > 0:
                if self._step == cfg.seed_steps:
                    num_updates = cfg.seed_steps
                    print('Pretraining agent on seed data...')
                else:
                    num_updates = self._updates_due(1)
                for _ in range(num_updates):
                    train_metrics.update(self.agent.update(self.buffer))

            self._step += 1

        self.finish()
