"""Record real observations for the checkpoint checks (CPU, JAX package).

    JAX_PLATFORMS=cpu python tests/data/record_observations.py          # both
    JAX_PLATFORMS=cpu python tests/data/record_observations.py state
    JAX_PLATFORMS=cpu python tests/data/record_observations.py pixels

For each committed checkpoint named in TASKS, the JAX agent loaded from it
plays its dm_control task greedily (eval-mode planning) for ROWS steps from
a seeded reset, and the trajectory is written to tests/data/observations.npz
as '<task>/obs' [ROWS + 1, obs_dim], '<task>/action' [ROWS, A] and
'<task>/reward' [ROWS]. `chip_smoke.py` and the checkpoint tests feed these
observations to the planner on the trained weights, and build update
batches from them: the card machine has no dm_control. This script imports
the JAX package and dm_control, so it is not part of the port.

`pixels` does the same for the pixel checkpoints in PIXEL_TASKS (obs=rgb:
each observation a [9, 64, 64] uint8 stack of three rendered frames, the
JAX `PixelObs`; MuJoCo renders offscreen with MUJOCO_GL=egl) for
PIXEL_ROWS steps, into tests/data/pixel_observations.npz: '<task>/obs'
[PIXEL_ROWS + 1, 9, 64, 64] uint8, '<task>/action', '<task>/reward'.
"""

import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
os.environ.setdefault('MUJOCO_GL', 'egl')

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')

from tdmpc2_tpu.config import Config, parse_cfg  # noqa: E402
from tdmpc2_tpu.envs import make_env  # noqa: E402
from tdmpc2_tpu.tdmpc2 import TDMPC2  # noqa: E402

TASKS = {'acrobot-swingup': 'results/checkpoints/acrobot-swingup-s1.pkl.gz',
         'hopper-hop': 'results/checkpoints/full/hopper-hop-s1-r5.pkl.gz'}
ROWS = 256
PIXEL_TASKS = {'walker-walk': 'results/checkpoints/walker-walk-rgb-s1.pkl.gz'}
PIXEL_ROWS = 64
SEED = 1


def record(task, ckpt, rows=ROWS, obs_kind='state'):
    cfg = parse_cfg(Config(task=task, seed=SEED, obs=obs_kind))
    env = make_env(cfg)
    agent = TDMPC2(cfg)
    agent.load(str(ROOT / ckpt))
    dtype = np.uint8 if obs_kind == 'rgb' else np.float32
    obs = [np.asarray(env.reset(), dtype)]
    actions, rewards = [], []
    for t in range(rows):
        a = np.asarray(agent.act(obs[-1], t0=(t == 0), eval_mode=True))
        o, r, done, _ = env.step(a)
        actions.append(a.astype(np.float32))
        rewards.append(np.float32(r))
        obs.append(np.asarray(env.reset() if done else o, dtype))
    print(f'{task} ({obs_kind}): {rows} steps, return {float(np.sum(rewards)):.1f}')
    return {f'{task}/obs': np.stack(obs), f'{task}/action': np.stack(actions),
            f'{task}/reward': np.asarray(rewards, np.float32)}


def main(which=('state', 'pixels')):
    if 'state' in which:
        out = {}
        for task, ckpt in TASKS.items():
            out.update(record(task, ckpt))
        np.savez_compressed(Path(__file__).with_name('observations.npz'), **out)
    if 'pixels' in which:
        out = {}
        for task, ckpt in PIXEL_TASKS.items():
            out.update(record(task, ckpt, PIXEL_ROWS, 'rgb'))
        np.savez_compressed(Path(__file__).with_name('pixel_observations.npz'),
                            **out)


if __name__ == '__main__':
    main(sys.argv[1:] or ('state', 'pixels'))
