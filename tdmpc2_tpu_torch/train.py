"""Training entry point (port of tdmpc2_tpu/train.py).

Usage:
    python -m tdmpc2_tpu_torch.train task=toy-reach
    python -m tdmpc2_tpu_torch.train task=toy-reach num_envs=8
    python -m tdmpc2_tpu_torch.train task=toy-reach-episodic episodic=true
    python -m tdmpc2_tpu_torch.train task=toy-reach steps=2000 device=cpu
    python -m tdmpc2_tpu_torch.train task=toy-reach steps=3000 resume=true
    python -m tdmpc2_tpu_torch.train task=walker-walk obs=rgb num_envs=4
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
updates (one env). The env is any task the JAX package builds, where its
backend imports (envs/__init__.py: the toy tasks, dm_control with the 28
custom tasks, state or rgb, ManiSkill2, Meta-World, MyoSuite, Gymnasium);
`vec_mode` says where the env copies step (a rendered task's in worker
processes by default).
Multi-task configs train offline on a dataset (`OfflineTrainer`, JAX
train.py:71-72) and evaluate on the mt30/mt80 envs (dm_control, and
Meta-World for mt80). `device`
defaults to `cuda`; without a card that raises unless `device=cpu` is
given. `resume=true` continues a run from its work_dir's checkpoints
(`maybe_resume` of the trainers). `seeds=3,7,11` trains a fleet, K seeds
of the task in one process (JAX train.py:54-60, 90-126; fleet.py,
trainer/fleet_online.py), each seed's artifacts under
logs/<task>/<seed>/<exp>/; a fleet of one seed is a plain run of that
seed (state observations only: a fleet of rgb seeds raises, as in JAX).
`bf16_update=true` takes the update's products in bf16 with f32 sums. Eval
videos (`save_video=true`) raise.
"""

from __future__ import annotations

import sys

from tdmpc2_tpu_torch.config import load_cfg, parse_cfg
from tdmpc2_tpu_torch.data.buffer import Buffer
from tdmpc2_tpu_torch.data.fleet_buffer import FleetBuffer
from tdmpc2_tpu_torch.envs import make_env, make_fleet_env
from tdmpc2_tpu_torch.fleet import FleetAgent
from tdmpc2_tpu_torch.tdmpc2 import TDMPC2, device_of
from tdmpc2_tpu_torch.trainer.fleet_online import FleetOnlineTrainer
from tdmpc2_tpu_torch.trainer.offline import OfflineTrainer
from tdmpc2_tpu_torch.trainer.online import OnlineTrainer
from tdmpc2_tpu_torch.trainer.vec_online import VecOnlineTrainer
from tdmpc2_tpu_torch.utils.logger import Logger
from tdmpc2_tpu_torch.utils.seed import set_seed


def train(cfg) -> OnlineTrainer:
    """Train as `cfg` says; returns the finished trainer."""
    if cfg.steps <= 0:
        raise ValueError('Must train for at least 1 step.')
    if cfg.save_video:
        raise NotImplementedError('save_video=true: the eval video recorder '
                                  'is a later part of the port (ROADMAP A12)')
    device_of(cfg.device)       # raise before any work when there is no card
    set_seed(cfg.seed)
    seeds = _parse_seeds(cfg.seeds)
    if seeds is not None and len(seeds) == 1:
        cfg.seed, cfg.seeds = seeds[0], None   # a fleet of one is a plain run
        parse_cfg(cfg)                         # its work dir, for that seed
        seeds = None
    if seeds is not None:
        return _train_fleet(cfg, seeds)
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


def _parse_seeds(seeds):
    """None, an int, '3,7,11' or a sequence -> a list of ints (or None)."""
    if seeds is None:
        return None
    if isinstance(seeds, int):
        return [seeds]
    if isinstance(seeds, str):
        return [int(s) for s in seeds.replace(' ', '').split(',') if s]
    return [int(s) for s in seeds]


def _train_fleet(cfg, seeds) -> FleetOnlineTrainer:
    """K seeds in one process (JAX train.py:90-126), on the planner's
    kernels on the card; each seed logs as a single-seed run would."""
    if cfg.multitask:
        raise ValueError('a fleet trains one task online (single-task)')
    env = make_fleet_env(cfg, seeds)
    agent = FleetAgent(cfg, seeds)
    loggers = [Logger(cfg.replace(seed=s, work_dir=str(agent.work_dir(k))))
               for k, s in enumerate(seeds)]
    trainer = FleetOnlineTrainer(cfg=cfg, env=env, agent=agent,
                                 buffer=FleetBuffer(cfg, len(seeds)),
                                 loggers=loggers)
    trainer.train()
    print('Training completed successfully')
    return trainer


def main(argv=None) -> OnlineTrainer:
    cfg = load_cfg(overrides=(argv if argv is not None else sys.argv[1:]))
    return train(cfg)


if __name__ == '__main__':
    main()
