"""Record real observations for the checkpoint checks (CPU, JAX package).

    JAX_PLATFORMS=cpu python tests/data/record_observations.py

For each committed checkpoint named in TASKS, the JAX agent loaded from it
plays its dm_control task greedily (eval-mode planning) for ROWS steps from
a seeded reset, and the trajectory is written to tests/data/observations.npz
as '<task>/obs' [ROWS + 1, obs_dim], '<task>/action' [ROWS, A] and
'<task>/reward' [ROWS]. `chip_smoke.py` and the checkpoint tests feed these
observations to the planner on the trained weights, and build update
batches from them: the card machine has no dm_control. This script imports
the JAX package and dm_control, so it is not part of the port.
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
SEED = 1


def record(task, ckpt):
    cfg = parse_cfg(Config(task=task, seed=SEED))
    env = make_env(cfg)
    agent = TDMPC2(cfg)
    agent.load(str(ROOT / ckpt))
    obs = [np.asarray(env.reset(), np.float32)]
    actions, rewards = [], []
    for t in range(ROWS):
        a = np.asarray(agent.act(obs[-1], t0=(t == 0), eval_mode=True))
        o, r, done, _ = env.step(a)
        actions.append(a.astype(np.float32))
        rewards.append(np.float32(r))
        obs.append(np.asarray(env.reset() if done else o, np.float32))
    print(f'{task}: {ROWS} steps, return {float(np.sum(rewards)):.1f}')
    return {f'{task}/obs': np.stack(obs), f'{task}/action': np.stack(actions),
            f'{task}/reward': np.asarray(rewards, np.float32)}


def main():
    out = {}
    for task, ckpt in TASKS.items():
        out.update(record(task, ckpt))
    np.savez_compressed(Path(__file__).with_name('observations.npz'), **out)


if __name__ == '__main__':
    main()
