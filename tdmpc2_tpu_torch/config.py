"""Configuration for the PyTorch port.

A copy of the reference-facing part of ``tdmpc2_tpu/config.py``: the same
``Config`` field names and defaults (reference tdmpc2/config.yaml), the same
``MODEL_SIZE`` table and the same ``key=value`` override parser, so a recipe
that runs the JAX package runs the port unchanged. Fields that only steer
the JAX runtime (mesh, platform, Pallas gates, XLA precision, compilation),
wandb's and ``profiler_port`` (a jax.profiler trace server) are in
``REFUSED_KEYS`` with the reason the port refuses each: a value the JAX
package takes by default asks nothing and is accepted, any other raises.
The collection schedules' keys (``fused_step``, ``overlap_update``,
``update_chunk``, ``buffer_device``) and ``profile_dir`` are the JAX
package's, with its defaults (``fused_step`` and ``overlap_update`` select
nothing: the port has one schedule); ``bf16_update`` takes the update's
products with bf16 operands and f32 sums (JAX config.py:149-152), and
``seeds`` trains a fleet of seeds of one task in one process (fleet.py).
One field is added: ``device``, where the port runs (``cuda`` unless the
caller asks for ``cpu``). The multi-task sets (``mt30``, ``mt80``: the
order of a set is the task embedding's index) and the ``task_dim`` rule
are the JAX package's.

``yaml`` is imported only when a YAML path is given.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

# Model-size table: parameters (M) -> architecture dims.
# Reference: tdmpc2/common/__init__.py:1-24.
MODEL_SIZE = {
    1: dict(enc_dim=256, mlp_dim=384, latent_dim=128, num_enc_layers=2, num_q=2),
    5: dict(enc_dim=256, mlp_dim=512, latent_dim=512, num_enc_layers=2),
    19: dict(enc_dim=1024, mlp_dim=1024, latent_dim=768, num_enc_layers=3),
    48: dict(enc_dim=1792, mlp_dim=1792, latent_dim=768, num_enc_layers=4),
    317: dict(enc_dim=4096, mlp_dim=4096, latent_dim=1376, num_enc_layers=5, num_q=8),
}

# Multi-task task sets; list order defines the task-embedding index.
# Reference: tdmpc2/common/__init__.py:26-60 (a copy of the JAX package's
# TASK_SET, tdmpc2_tpu/config.py:40-71).
_DMC_19 = [
    'walker-stand', 'walker-walk', 'walker-run', 'cheetah-run', 'reacher-easy',
    'reacher-hard', 'acrobot-swingup', 'pendulum-swingup', 'cartpole-balance',
    'cartpole-balance-sparse', 'cartpole-swingup', 'cartpole-swingup-sparse',
    'cup-catch', 'finger-spin', 'finger-turn-easy', 'finger-turn-hard',
    'fish-swim', 'hopper-stand', 'hopper-hop',
]
_DMC_CUSTOM_11 = [
    'walker-walk-backwards', 'walker-run-backwards', 'cheetah-run-backwards',
    'cheetah-run-front', 'cheetah-run-back', 'cheetah-jump',
    'hopper-hop-backwards', 'reacher-three-easy', 'reacher-three-hard',
    'cup-spin', 'pendulum-spin',
]
_MW_50 = [
    'mw-assembly', 'mw-basketball', 'mw-button-press-topdown',
    'mw-button-press-topdown-wall', 'mw-button-press', 'mw-button-press-wall',
    'mw-coffee-button', 'mw-coffee-pull', 'mw-coffee-push', 'mw-dial-turn',
    'mw-disassemble', 'mw-door-open', 'mw-door-close', 'mw-drawer-close',
    'mw-drawer-open', 'mw-faucet-open', 'mw-faucet-close', 'mw-hammer',
    'mw-handle-press-side', 'mw-handle-press', 'mw-handle-pull-side',
    'mw-handle-pull', 'mw-lever-pull', 'mw-peg-insert-side',
    'mw-peg-unplug-side', 'mw-pick-out-of-hole', 'mw-pick-place',
    'mw-pick-place-wall', 'mw-plate-slide', 'mw-plate-slide-side',
    'mw-plate-slide-back', 'mw-plate-slide-back-side', 'mw-push-back',
    'mw-push', 'mw-push-wall', 'mw-reach', 'mw-reach-wall', 'mw-shelf-place',
    'mw-soccer', 'mw-stick-push', 'mw-stick-pull', 'mw-sweep-into', 'mw-sweep',
    'mw-window-open', 'mw-window-close', 'mw-bin-picking', 'mw-box-close',
    'mw-door-lock', 'mw-door-unlock', 'mw-hand-insert',
]
TASK_SET = {
    'mt30': _DMC_19 + _DMC_CUSTOM_11,
    'mt80': _DMC_19 + _DMC_CUSTOM_11 + _MW_50,
}


@dataclass
class Config:
    """Hyperparameters. Defaults mirror reference tdmpc2/config.yaml:4-91."""

    # environment
    task: str = 'dog-run'
    obs: str = 'state'
    episodic: bool = False

    # evaluation
    checkpoint: Optional[str] = None
    eval_episodes: int = 10
    eval_freq: int = 50_000

    # training
    steps: int = 10_000_000
    batch_size: int = 256
    reward_coef: float = 0.1
    value_coef: float = 0.1
    termination_coef: float = 1.0
    consistency_coef: float = 20.0
    rho: float = 0.5
    lr: float = 3e-4
    enc_lr_scale: float = 0.3
    grad_clip_norm: float = 20.0
    tau: float = 0.01
    discount_denom: float = 5
    discount_min: float = 0.95
    discount_max: float = 0.995
    buffer_size: int = 1_000_000
    exp_name: str = 'default'
    data_dir: Optional[str] = None

    # planning
    mpc: bool = True
    iterations: int = 6
    num_samples: int = 512
    num_elites: int = 64
    num_pi_trajs: int = 24
    horizon: int = 3
    min_std: float = 0.05
    max_std: float = 2.0
    temperature: float = 0.5

    # actor
    log_std_min: float = -10.0
    log_std_max: float = 2.0
    entropy_coef: float = 1e-4

    # critic
    num_bins: int = 101
    vmin: float = -10.0
    vmax: float = 10.0

    # architecture
    model_size: Optional[int] = None
    num_enc_layers: int = 2
    enc_dim: int = 256
    num_channels: int = 32
    mlp_dim: int = 512
    latent_dim: int = 512
    task_dim: int = 96
    num_q: int = 5
    dropout: float = 0.01
    simnorm_dim: int = 8

    # online training (JAX config names and defaults; multi-task configs
    # train offline, trainer/offline.py)
    update_ratio: float = 1.0
    # after a resume, no updates until the restored policy has collected
    # this many env steps (a restored buffer snapshot's steps count): a
    # trained value function updated at the usual rate on a nearly empty
    # buffer diverges (JAX config.py:182-192). The skipped updates are not
    # made up. 0 disables.
    resume_refill_steps: int = 25_000
    # > 0: at every checkpoint also save the newest K replay episodes next
    # to the model (models/buffer.npz), restored on resume (JAX
    # config.py:193-199). 0 = off.
    buffer_snapshot_eps: int = 0
    # parallel env copies for vectorised collection (trainer/vec_online.py)
    num_envs: int = 1
    # cap on updates an `update_many` call samples at once (JAX
    # config.py:162-172): each sampled batch is held on the device until
    # its update. 0 = auto, free device memory over one batch's bytes
    # (TDMPC2._auto_update_chunk; no cap where the device reports none);
    # > 0 overrides it. A capped call draws its batches one
    # sample_many(chunk) at a time.
    update_chunk: int = 0
    # the JAX trainer's collection schedule after the seed burst (JAX
    # config.py:200-216), accepted so that its recipes run; the port's
    # vectorised trainer takes `vec_step` for every value, which gives the
    # numbers of all three JAX schedules (trainer/vec_online.py)
    fused_step: bool = True
    overlap_update: bool = True
    # replay ring placement (JAX config.py:217-219): 'auto' (the 2.5x-bytes
    # rule), 'device' or 'host' (data/buffer.py)
    buffer_device: str = 'auto'
    # run the update's products with bf16 operands and f32 sums, f32
    # master weights (JAX config.py:149-152); acting stays f32
    bf16_update: bool = False
    # a fleet: 'seeds=1,2,3' trains K seeds of the task in one process
    # (fleet.py, trainer/fleet_online.py; JAX config.py:240-243)
    seeds: Any = None
    # continue from work_dir/models: 'latest.pkl' online, the newest
    # iteration checkpoint offline
    resume: bool = False

    # where the port runs: 'cuda' (the default) or 'cpu' (tests)
    device: str = 'cuda'
    # write a torch.profiler trace of ten updates after the warm-up here
    # (the one-env trainer; JAX config.py:225-226, trainer/online.py:203-210)
    profile_dir: Optional[str] = None

    # logging
    save_csv: bool = True

    # misc (save_video=true raises in train and evaluate: the port has no
    # video recorder yet)
    save_video: bool = False
    save_agent: bool = True
    seed: int = 1

    # filled by parse_cfg / the env factory
    work_dir: Optional[str] = None
    task_title: Optional[str] = None
    multitask: Optional[bool] = None
    tasks: Any = None
    obs_shape: Any = None           # dict: obs-kind -> shape tuple
    action_dim: Optional[int] = None
    episode_length: Optional[int] = None
    obs_shapes: Any = None          # multitask: per-task obs dims
    action_dims: Any = None         # multitask: per-task action dims
    episode_lengths: Any = None     # multitask: per-task episode lengths
    seed_steps: Optional[int] = None
    bin_size: Optional[float] = None

    def get(self, key, default=None):
        return getattr(self, key, default)

    def replace(self, **kwargs) -> 'Config':
        return dataclasses.replace(self, **kwargs)


_ALGEBRA_RE = re.compile(r"^(\d+)([+\-*/])(\d+)$")


def _coerce(value: str) -> Any:
    """Coerce a CLI string override to the right python type."""
    # string algebra, e.g. steps=5*1000000 (reference parser.py:44-54)
    m = _ALGEBRA_RE.match(value)
    if m:
        out = eval(m.group(1) + m.group(2) + m.group(3))  # noqa: S307 — digits only
        if isinstance(out, float) and out.is_integer():
            out = int(out)
        return out
    low = value.lower()
    if low in ('true', 'yes'):
        return True
    if low in ('false', 'no'):
        return False
    if low in ('none', 'null'):
        return None
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    return value


def parse_overrides(args) -> dict:
    """Parse a list of 'key=value' CLI overrides."""
    out = {}
    for a in args:
        if '=' not in a:
            raise ValueError(f"Override '{a}' is not of the form key=value")
        k, v = a.split('=', 1)
        out[k.strip()] = _coerce(v)
    return out


def parse_cfg(cfg: Config) -> Config:
    """Fill derived fields; mirrors reference parse_cfg (parser.py:29-80)."""
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, str) and _ALGEBRA_RE.match(v):
            setattr(cfg, f.name, _coerce(v))

    cfg.work_dir = str(Path.cwd() / 'logs' / cfg.task / str(cfg.seed) / cfg.exp_name)
    cfg.task_title = cfg.task.replace('-', ' ').title()
    cfg.bin_size = (cfg.vmax - cfg.vmin) / (cfg.num_bins - 1)

    if cfg.model_size is not None:
        if cfg.model_size not in MODEL_SIZE:
            raise ValueError(
                f'Invalid model size {cfg.model_size}. Must be one of {list(MODEL_SIZE)}')
        for k, v in MODEL_SIZE[cfg.model_size].items():
            setattr(cfg, k, v)
        if cfg.task == 'mt30' and cfg.model_size == 19:
            cfg.latent_dim = 512  # published mt30/19M checkpoint quirk (parser.py:67-68)

    cfg.multitask = cfg.task in TASK_SET
    if cfg.multitask:
        cfg.task_title = cfg.task.upper()
        # task_dim inconsistency across published mt experiments (parser.py:75)
        cfg.task_dim = 96 if (cfg.task == 'mt80' or (cfg.model_size or 5) in (1, 317)) else 64
    else:
        cfg.task_dim = 0
    cfg.tasks = TASK_SET.get(cfg.task, [cfg.task])
    return cfg


# JAX config keys the port refuses: {key: (the values that ask nothing,
# the JAX default first; the reason any other is refused)}
REFUSED_KEYS = {
    'profiler_port': ((None,), 'profiler_port starts a jax.profiler trace '
                      'server, which torch has no counterpart of; set '
                      'profile_dir for a torch.profiler trace of ten updates '
                      'instead'),
    'mesh_shape': ((None,), 'mesh_shape shards the model over a device mesh: '
                   'data parallelism and FSDP on torch.distributed are '
                   'ROADMAP A10, not ported yet'),
    'vec_mode': (('auto', 'inproc'), 'vec_mode=subproc steps the env copies in '
                 'worker processes, which serve the rendered dm_control rgb '
                 'tasks; they come with those tasks (ROADMAP A11), and the '
                 "port's env copies step in this process (inproc)"),
    'compile': ((True,), 'compile: the JAX package always jits; the port '
                'captures CUDA graphs of the plan and the update on the card '
                'and has no switch for them'),
    'use_pallas': ((True,), "use_pallas=false asks for the JAX package's plain "
                   'XLA planner; the port plans through its CUDA kernels on '
                   'the card and has no plain planner there'),
    'platform': ((None,), 'platform selects a JAX backend; the port runs where '
                 'device= says (cuda or cpu)'),
    'matmul_precision': (('default',), "matmul_precision sets XLA's f32 matmul "
                         "precision; the port's f32 products are f32 (TF32 "
                         'off), and bf16_update=true takes bf16 operands in '
                         'the update'),
    'enable_wandb': ((False,), 'the port logs to the console and csv files; '
                     'it has no wandb logger'),
    'wandb_project': ((None,), 'the port has no wandb logger'),
    'wandb_entity': ((None,), 'the port has no wandb logger'),
    'wandb_silent': ((False,), 'the port has no wandb logger'),
}


def load_cfg(yaml_path: Optional[str] = None, overrides=()) -> Config:
    """Build a Config from an optional YAML file + CLI overrides, then parse."""
    cfg = Config()
    values = {}
    if yaml_path:
        import yaml
        with open(yaml_path) as f:
            values.update(yaml.safe_load(f) or {})
    values.update(parse_overrides(list(overrides)))
    known = {f.name for f in dataclasses.fields(Config)}
    for k, v in values.items():
        if k in REFUSED_KEYS:
            accepted, reason = REFUSED_KEYS[k]
            if not any(v == a and type(v) is type(a) for a in accepted):
                raise ValueError(f'{k}={v!r}: {reason}')
            continue
        if k not in known:
            raise ValueError(f'Unknown config key: {k}')
        setattr(cfg, k, v)
    return parse_cfg(cfg)
