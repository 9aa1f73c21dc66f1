"""PyTorch port: entry point, config, env copy and import hygiene (CPU).

The port must import neither JAX nor the JAX package; its copies of the
JAX-free modules (config, toy env) must behave as the originals; and
`evaluate` must run on the CPU only when asked to."""

import ast
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tdmpc2_tpu.config import load_cfg as jload_cfg
from tdmpc2_tpu.envs.toy import make_env as jmake_env
from tdmpc2_tpu_torch.config import MODEL_SIZE, load_cfg
from tdmpc2_tpu_torch.envs import make_env
from tdmpc2_tpu_torch.evaluate import evaluate, main
from tdmpc2_tpu_torch.ops import cem, value
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / 'tdmpc2_tpu_torch').rglob('*.py')) + [ROOT / 'chip_smoke.py']
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tdmpc2_tpu'}
SMALL = ['task=toy-reach', 'device=cpu', 'eval_episodes=1', 'mlp_dim=64',
         'latent_dim=32', 'enc_dim=32', 'num_samples=64', 'num_elites=8',
         'num_pi_trajs=8', 'iterations=2']


@pytest.mark.parametrize('path', PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_no_jax(path):
    src = path.read_text()
    assert not re.search(r'^\s*(import|from)\s+(jax|tdmpc2_tpu)\b', src, re.M)
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or '']
        else:
            continue
        for n in names:
            assert n.split('.')[0] not in FORBIDDEN, f'{path}: imports {n}'


def test_port_runs_without_jax_loaded():
    code = ('import sys, tdmpc2_tpu_torch.evaluate, tdmpc2_tpu_torch.interop, '
            'tdmpc2_tpu_torch.ops.cem; '
            'bad = sorted(m for m in sys.modules '
            "if m.split('.')[0] in ('jax', 'tdmpc2_tpu')); "
            'assert not bad, bad')
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize('mpc', ['true', 'false'])
def test_evaluate_on_cpu(mpc):
    wrappers = (value.value_estimate, value.value_sampled, cem.pi_rollout,
                cem.elite_moments)
    for w in wrappers:
        w.launches = 0
    res = evaluate(load_cfg(overrides=SMALL + [f'mpc={mpc}']))['toy-reach']
    assert math.isfinite(res['reward']) and res['plans'] == 50
    # on the CPU every step ran the plain versions: no kernel launched
    assert all(w.launches == 0 for w in wrappers)


@pytest.mark.parametrize('mismatch', ['mlp_dim=48', 'num_bins=51', 'num_q=2', None])
def test_evaluate_checks_the_checkpoint_architecture(tmp_path, mismatch):
    """`checkpoint=` goes through `TDMPC2.load`, which refuses a checkpoint
    whose architecture differs from the config's, as the JAX `evaluate`
    does (tdmpc2_tpu/evaluate.py:33, tdmpc2.py:230-241)."""
    from tdmpc2_tpu_torch.tdmpc2 import TDMPC2
    cfg = load_cfg(overrides=SMALL)
    make_env(cfg)
    fp = tmp_path / 'ckpt.pkl'
    TDMPC2(cfg).save(fp)
    argv = SMALL + [f'checkpoint={fp}'] + ([mismatch] if mismatch else [])
    if mismatch:
        with pytest.raises(ValueError, match=mismatch.split('=')[0]):
            evaluate(load_cfg(overrides=argv))
    else:
        assert math.isfinite(evaluate(load_cfg(overrides=argv))['toy-reach']['reward'])


def test_evaluate_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device works here')
    with pytest.raises(RuntimeError, match='device=cpu'):
        main([o for o in SMALL if not o.startswith('device=')])


@pytest.mark.parametrize('overrides', [
    [], ['model_size=1'], ['model_size=19', 'steps=5*1000'],
    ['horizon=5', 'num_samples=256', 'episodic=true'],
])
def test_config_matches_jax_config(overrides):
    got = load_cfg(overrides=['task=walker-walk'] + overrides)
    ref = jload_cfg(overrides=['task=walker-walk'] + overrides)
    for k in vars(got):
        if k == 'device':
            continue
        assert getattr(got, k) == getattr(ref, k), k
    assert got.device == 'cuda'


def test_config_refuses_unknown_keys_and_multitask():
    """Unknown keys raise. A multi-task config is taken (its offline
    training is ported), but its envs are not: the port has envs for the
    toy tasks only, so `make_env` refuses mt30 as the JAX factory does
    without dm_control."""
    with pytest.raises(ValueError):
        load_cfg(overrides=['no_such_key=1'])
    cfg = load_cfg(overrides=['task=mt30'])
    assert cfg.multitask and len(cfg.tasks) == 30 and cfg.task_dim == 64
    with pytest.raises(ValueError, match='Failed to make environment'):
        make_env(cfg)
    assert set(MODEL_SIZE) == {1, 5, 19, 48, 317}


@pytest.mark.parametrize('task', ['toy-reach', 'toy-reach-episodic'])
def test_toy_env_copy_matches_jax_env(task):
    cfg, jcfg = load_cfg(overrides=[f'task={task}']), jload_cfg(overrides=[f'task={task}'])
    env, jenv = make_env(cfg), jmake_env(jcfg)
    assert cfg.obs_shape == {'state': (6,)} and cfg.action_dim == 2
    assert cfg.episode_length == 50
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(env.reset(), jenv.reset())
    for _ in range(60):
        a = rng.uniform(-1, 1, 2).astype(np.float32)
        out, jout = env.step(a), jenv.step(a)
        np.testing.assert_array_equal(out[0], jout[0])
        assert out[1:] == jout[1:]
        if out[2]:
            np.testing.assert_array_equal(env.reset(), jenv.reset())
