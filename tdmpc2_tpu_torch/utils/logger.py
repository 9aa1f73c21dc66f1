"""Console and CSV logger (port of tdmpc2_tpu/utils/logger.py; reference
tdmpc2/common/logger.py:13-241).

Fixed-format console lines per category, the eval CSV with the published
results schema (step,episode_reward,episode_success), the multi-task eval's
per-domain aggregate, and checkpoints through the agent's `save`. No wandb
and no video in the port (save_video=true raises in the entry points).
"""

from __future__ import annotations

import csv
from collections import defaultdict
from pathlib import Path

import numpy as np

_CAT_COLOR = {'train': '34', 'eval': '32', 'pretrain': '35'}
_PRINT_KEYS = (
    ('iteration', 'I', 'int'),
    ('step', 'S', 'int'),
    ('episode', 'E', 'int'),
    ('episode_reward', 'R', 'float'),
    ('episode_success', 'SR', 'float'),
    ('total_loss', 'L', 'float'),
    ('pi_loss', 'PL', 'float'),
    ('steps_per_second', 'SPS', 'float'),
    ('elapsed_time', 'T', 'time'),
)


def _fmt(value, ty):
    if ty == 'int':
        return f'{int(value):,}'
    if ty == 'time':
        value = float(value)
        if value < 3600:
            return f'{value / 60:.1f}m'
        return f'{value / 3600:.1f}h'
    return f'{float(value):.3f}'


class Logger:
    def __init__(self, cfg):
        self.cfg = cfg
        self._work_dir = Path(cfg.work_dir or '.')
        self._model_dir = self._work_dir / 'models'
        self._work_dir.mkdir(parents=True, exist_ok=True)
        self._eval_rows = []
        if cfg.get('resume') and (self._work_dir / 'eval.csv').exists():
            # a resumed run keeps its eval history (each flush rewrites the
            # file); a re-evaluated step's row is replaced (JAX
            # logger.py:100-109)
            with open(self._work_dir / 'eval.csv') as f:
                self._eval_rows = [
                    dict(step=int(r['step']),
                         episode_reward=float(r['episode_reward']),
                         episode_success=float(r.get('episode_success', 0.0)))
                    for r in csv.DictReader(f)]
        self.print_run()

    def print_run(self):
        cfg = self.cfg
        print('=' * 60)
        print(f'  task: {cfg.task_title}   steps: {cfg.steps:,}')
        print(f'  obs: {cfg.obs}   seed: {cfg.seed}   experiment: {cfg.exp_name}')
        print(f'  work dir: {self._work_dir}')
        print('=' * 60)

    def log(self, metrics: dict, category: str = 'train'):
        """Print one line; an eval line also goes into the CSV. Device
        tensors are converted here (one host sync per logged line)."""
        metrics = {k: (float(v) if hasattr(v, 'item') or isinstance(
            v, (int, float, np.floating, np.integer)) else v)
            for k, v in metrics.items()}
        color = _CAT_COLOR.get(category, '0')
        parts = [f'{abbrev}: {_fmt(metrics[key], ty)}'
                 for key, abbrev, ty in _PRINT_KEYS if key in metrics]
        print(f'\033[{color}m[{category:>8s}]\033[0m ' + '  '.join(parts))
        if category == 'eval' and self.cfg.save_csv and 'episode_reward' in metrics:
            step = int(metrics.get('step', metrics.get('iteration', 0)))
            self._eval_rows = [r for r in self._eval_rows if r['step'] != step]
            self._eval_rows.append(
                dict(step=step,
                     episode_reward=float(metrics['episode_reward']),
                     episode_success=float(metrics.get('episode_success', 0.0))))
            self._eval_rows.sort(key=lambda r: r['step'])
            with open(self._work_dir / 'eval.csv', 'w', newline='') as f:
                w = csv.DictWriter(
                    f, fieldnames=['step', 'episode_reward', 'episode_success'])
                w.writeheader()
                w.writerows(self._eval_rows)

    def pprint_multitask(self, metrics: dict, cfg) -> float:
        """Print the per-task eval rewards aggregated by domain, and return
        the normalized score: success x 100 on Meta-World tasks, return / 10
        elsewhere (JAX logger.py:170-189; reference logger.py:194-222)."""
        domains = defaultdict(list)
        scores = []
        for k, v in metrics.items():
            if k.startswith('episode_reward+'):
                task = k.split('+', 1)[1]
                domains[task.split('-')[0]].append(v)
                if task.startswith('mw-'):
                    scores.append(metrics.get(f'episode_success+{task}', 0.0) * 100)
                else:
                    scores.append(v / 10)
        print('-' * 40)
        for d, vals in sorted(domains.items()):
            print(f'  {d:<16s} {np.nanmean(vals):8.1f}  ({len(vals)} tasks)')
        if scores:
            print(f'  {"normalized score":<16s} {np.nanmean(scores):8.2f}')
        print('-' * 40)
        return float(np.nanmean(scores)) if scores else 0.0

    def save_agent(self, agent, identifier: str = 'final', extra=None,
                   buffer=None):
        """The agent's checkpoint `models/<identifier>.pkl`, with the
        buffer's generator state when `buffer` is given."""
        if not self.cfg.save_agent:
            return None
        fp = self._model_dir / f'{identifier}.pkl'
        agent.save(fp, extra=extra, buffer=buffer)
        return fp

    def finish(self, agent=None, buffer=None):
        """The final checkpoint (reference logger.py:167-173)."""
        if agent is not None:
            self.save_agent(agent, buffer=buffer)
