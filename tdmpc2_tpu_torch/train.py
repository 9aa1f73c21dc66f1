"""Training entry point (port of tdmpc2_tpu/train.py).

Usage:
    python -m tdmpc2_tpu_torch.train task=toy-reach
    python -m tdmpc2_tpu_torch.train task=toy-reach num_envs=8
    python -m tdmpc2_tpu_torch.train task=toy-reach-episodic episodic=true
    python -m tdmpc2_tpu_torch.train task=toy-reach steps=2000 device=cpu
    python -m tdmpc2_tpu_torch.train task=toy-reach steps=3000 resume=true
    python -m tdmpc2_tpu_torch.train task=mt30 model_size=48 data_dir=<npz dir>

Single-task configs train online: collect with the planner (the CUDA
kernels on the card, their plain versions on the CPU), store episodes in
the replay buffer and take one update per environment step after the seed
phase, each update one replay of a CUDA graph on the card. `num_envs > 1`
steps that many env copies together with one batched plan per vector step
(`VecOnlineTrainer`), as the JAX `train.py` does: one `vec_step` call a
vector step queues the plan and the step's updates on the card before the
envs step (`fused_step` and `overlap_update` are accepted and select
nothing). `profile_dir=<dir>` writes a trace of ten
updates (one env).
Multi-task configs train offline on a dataset (`OfflineTrainer`, JAX
train.py:71-72); their evaluation needs an env for every task, and the
port has envs for the toy tasks only (the mt30/mt80 tasks stop at
`make_env` until their adapters are ported, ROADMAP A11). `device`
defaults to `cuda`; without a card that raises unless `device=cpu` is
given. `resume=true` continues a run from its work_dir's checkpoints
(`maybe_resume` of the trainers). Seed fleets and eval videos
(`save_video=true`) raise.
"""

from __future__ import annotations

import sys

from tdmpc2_tpu_torch.config import load_cfg
from tdmpc2_tpu_torch.data.buffer import Buffer
from tdmpc2_tpu_torch.envs import make_env
from tdmpc2_tpu_torch.tdmpc2 import TDMPC2, device_of
from tdmpc2_tpu_torch.trainer.offline import OfflineTrainer
from tdmpc2_tpu_torch.trainer.online import OnlineTrainer
from tdmpc2_tpu_torch.trainer.vec_online import VecOnlineTrainer
from tdmpc2_tpu_torch.utils.logger import Logger
from tdmpc2_tpu_torch.utils.seed import set_seed


def train(cfg) -> OnlineTrainer:
    """Train as `cfg` says; returns the finished trainer."""
    if cfg.steps <= 0:
        raise ValueError('Must train for at least 1 step.')
    if cfg.seeds is not None:
        raise NotImplementedError('seed fleets (seeds=...) are a later part '
                                  'of the port; pass seed=<n>')
    if cfg.save_video:
        raise NotImplementedError('save_video=true: the eval video recorder '
                                  'is a later part of the port (ROADMAP A12)')
    device_of(cfg.device)       # raise before any work when there is no card
    set_seed(cfg.seed)
    env = make_env(cfg)
    agent = TDMPC2(cfg)
    if cfg.multitask:
        cls = OfflineTrainer
    elif int(cfg.num_envs or 1) > 1:
        cls = VecOnlineTrainer
    else:
        cls = OnlineTrainer
    trainer = cls(cfg=cfg, env=env, agent=agent, buffer=Buffer(cfg),
                  logger=Logger(cfg))
    trainer.train()
    print('Training completed successfully')
    return trainer


def main(argv=None) -> OnlineTrainer:
    cfg = load_cfg(overrides=(argv if argv is not None else sys.argv[1:]))
    return train(cfg)


if __name__ == '__main__':
    main()
