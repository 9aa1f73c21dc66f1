"""PyTorch port vs the JAX package: the environment adapters (CPU).

Each case builds an env in both packages from the same config and seed and
drives both with the same numpy-seeded actions: observations, rewards,
dones, infos and spaces bit for bit, and the config fields the factories
fill (with the Gymnasium tasks' discount_max/rho mutation).

- dm_control suite tasks (walker-walk, cartpole-swingup, quadruped-run,
  dog-run) through both factories, and walker-walk's rgb frames;
- all 28 custom tasks, through each package's own task factories (in a
  process that imports both packages the suite keeps the factories of the
  package that registered first, envs/tasks/__init__.py), and the three
  model variants' XML; a process that imports only the port builds all 28
  through its env factory, registered by the port, and matches the JAX
  task factories' first steps;
- the Gymnasium tasks whose backends import here;
- Meta-World, ManiSkill2 and MyoSuite through the JAX suite's mocks of
  their packages (tests/test_env_adapters_mocked.py), with the calls each
  adapter makes into its backend;
- mt30 and mt80 (mt80's Meta-World tasks on the mock): per-task dims and
  episode lengths, and reset(task_idx) with steps on a few tasks;
- the factory's error for an unknown task, and for a missing backend, with
  dm_control, MuJoCo and Gymnasium blocked from importing.

A family skips only where its backend does not import, as the JAX tests
do.
"""

import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import test_env_adapters_mocked as mocks
from tdmpc2_tpu.config import Config as JConfig, parse_cfg as jparse
from tdmpc2_tpu.envs import make_env as jmake_env
from tdmpc2_tpu_torch.config import TASK_SET, Config, parse_cfg
from tdmpc2_tpu_torch.envs import make_env
from test_env_adapters_mocked import ms_modules, mw_modules, myo_modules  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
SUITE_TASKS = ['walker-walk', 'cartpole-swingup', 'quadruped-run', 'dog-run']
# the 28 custom tasks: (suite domain, task name)
CUSTOM = (
    [('cheetah', t) for t in ('run_backwards', 'stand_front', 'stand_back', 'jump',
                              'run_front', 'run_back', 'lie_down', 'legs_up', 'flip',
                              'flip_backwards')]
    + [('walker', t) for t in ('walk_backwards', 'run_backwards', 'arabesque',
                               'lie_down', 'legs_up', 'headstand', 'flip', 'backflip')]
    + [('hopper', t) for t in ('hop_backwards', 'flip', 'flip_backwards')]
    + [('reacher', t) for t in ('three_easy', 'three_hard', 'four_easy', 'four_hard')]
    + [('ball_in_cup', 'spin'), ('pendulum', 'spin'), ('fish', 'obstacles')])
CUSTOM_STEPS = 10
GYM_TASKS = {'mujoco-walker': 'mujoco', 'mujoco-halfcheetah': 'mujoco',
             'bipedal-walker': 'Box2D', 'lunarlander-continuous': 'Box2D'}


def _cfgs(task, **kw):
    return (parse_cfg(Config(task=task, device='cpu', **kw)),
            jparse(JConfig(task=task, **kw)))


def _fields(cfg, multitask=False):
    keys = ('obs_shape', 'action_dim', 'episode_length', 'seed_steps',
            'discount_max', 'rho')
    keys += ('obs_shapes', 'action_dims', 'episode_lengths') if multitask else ()
    return {k: cfg.get(k) for k in keys}


def _same(x, y):
    """Bit for bit, with the same type (arrays: dtype and shape)."""
    assert type(x) is type(y), (type(x), type(y))
    if isinstance(x, dict):
        assert x.keys() == y.keys()
        for k in x:
            _same(x[k], y[k])
    elif isinstance(x, (np.ndarray, np.generic)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    else:
        assert x == y, (x, y)


def _same_space(a, b):
    assert tuple(a.shape) == tuple(b.shape) and np.dtype(a.dtype) == np.dtype(b.dtype)
    np.testing.assert_array_equal(a.low, b.low)
    np.testing.assert_array_equal(a.high, b.high)


def _hold(env, jenv, steps, seed=0, lo=-1.0, hi=1.0, reset=True):
    """The two envs' spaces, then `steps` steps of the same seeded actions
    (a reset after each episode's end), everything bit for bit."""
    _same_space(env.observation_space, jenv.observation_space)
    _same_space(env.action_space, jenv.action_space)
    assert env.max_episode_steps == jenv.max_episode_steps
    if reset:
        _same(env.reset(), jenv.reset())
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        a = rng.uniform(lo, hi, env.action_space.shape).astype(np.float32)
        out, jout = env.step(a), jenv.step(a)
        for x, y in zip(out, jout):
            _same(x, y)
        if out[2]:
            _same(env.reset(), jenv.reset())
    return out


# ----------------------------------------------------------------- dm_control


@pytest.mark.parametrize('task', SUITE_TASKS)
def test_suite_task_matches_jax(task):
    pytest.importorskip('dm_control')
    cfg, jcfg = _cfgs(task, seed=3)
    env, jenv = make_env(cfg), jmake_env(jcfg)
    assert _fields(cfg) == _fields(jcfg)
    _hold(env, jenv, 20)
    _same(env.rand_act(), jenv.rand_act())


def test_walker_rgb_frames_match_jax():
    pytest.importorskip('dm_control')
    cfg, jcfg = _cfgs('walker-walk', obs='rgb', seed=2)
    env, jenv = make_env(cfg), jmake_env(jcfg)
    assert _fields(cfg) == _fields(jcfg) and cfg.obs_shape == {'rgb': (9, 64, 64)}
    obs = _hold(env, jenv, 6)[0]
    assert obs.dtype == np.uint8 and obs.any()
    _same(env.render(width=32, height=32), jenv.render(width=32, height=32))


def _task_factories(package):
    """{(domain, task): task factory} of a package's custom tasks, taken
    from its register_all calls (its suite registration is not consulted)."""
    import importlib
    found = {}
    for name in ('locomotion', 'manipulation'):
        mod = importlib.import_module(f'{package}.envs.tasks.{name}')
        saved = mod.register
        mod.register = lambda suite_mod, task, make: found.__setitem__(
            (suite_mod.__name__.rsplit('.', 1)[-1], task), make)
        try:
            mod.register_all()
        finally:
            mod.register = saved
    return found


def _custom_env(package, make_task, domain, seed):
    """The adapter stack `dmcontrol.make_env` puts around a suite task, of
    `package`, around `make_task`'s control.Environment."""
    import importlib
    from dm_control.suite.wrappers import action_scale
    dmc = importlib.import_module(f'{package}.envs.dmcontrol')
    base = importlib.import_module(f'{package}.envs.base')
    env = make_task(None, seed, {})
    env.task.visualize_reward = False        # as suite.load sets it
    env = dmc.DMControlAdapter(action_scale.Wrapper(env, minimum=-1.0, maximum=1.0),
                               domain)
    return base.NormalizeInfo(base.Timeout(env, max_episode_steps=dmc.EPISODE_STEPS))


def _custom_steps(env, steps, seed):
    rng = np.random.default_rng(seed)
    rows = [env.reset()]
    rewards = []
    for _ in range(steps):
        o, r, _, _ = env.step(rng.uniform(-1, 1, env.action_space.shape).astype(np.float32))
        rows.append(o)
        rewards.append(r)
    return np.stack(rows), np.asarray(rewards)


@pytest.mark.parametrize('domain,task', CUSTOM, ids=[f'{d}-{t}' for d, t in CUSTOM])
def test_custom_task_factory_matches_jax(domain, task):
    """Each of the 28 custom tasks: the port's task factory against the JAX
    package's, each in its own package's adapter stack, CUSTOM_STEPS steps
    bit for bit."""
    pytest.importorskip('dm_control')
    port, jax_ = _task_factories('tdmpc2_tpu_torch'), _task_factories('tdmpc2_tpu')
    assert sorted(port) == sorted(jax_) == sorted(CUSTOM)
    i = CUSTOM.index((domain, task))
    env = _custom_env('tdmpc2_tpu_torch', port[domain, task], domain, 5 + i)
    jenv = _custom_env('tdmpc2_tpu', jax_[domain, task], domain, 5 + i)
    _hold(env, jenv, CUSTOM_STEPS, seed=i)


@pytest.mark.parametrize('variant', ['cheetah', 'walker', 'fish', 'reacher3', 'reacher4'])
def test_custom_model_xml_matches_jax(variant):
    pytest.importorskip('dm_control')
    from tdmpc2_tpu.envs.tasks import _models as jm
    from tdmpc2_tpu_torch.envs.tasks import _models as m
    call = {'cheetah': lambda x: x.widened_arena('cheetah', 'ground', 200),
            'walker': lambda x: x.widened_arena('walker', 'floor', 500),
            'fish': lambda x: x.fish_with_walls(),
            'reacher3': lambda x: x.multilink_reacher(3),
            'reacher4': lambda x: x.multilink_reacher(4)}[variant]
    assert call(m) == call(jm)


PORT_ONLY = '''
import json, sys
import numpy as np
from dm_control import suite
from tdmpc2_tpu_torch.config import Config, parse_cfg
from tdmpc2_tpu_torch.envs import make_env
tasks = json.loads(sys.argv[1])
out = {}
for i, (domain, task) in enumerate(tasks):
    name = {'ball_in_cup': 'cup'}.get(domain, domain) + '-' + task.replace('_', '-')
    env = make_env(parse_cfg(Config(task=name, seed=5 + i, device='cpu')))
    rng = np.random.default_rng(i)
    rows, rewards = [env.reset()], []
    for _ in range(int(sys.argv[2])):
        o, r, _, _ = env.step(rng.uniform(-1, 1, env.action_space.shape).astype(np.float32))
        rows.append(o)
        rewards.append(float(r))
    out[name] = [np.stack(rows).tolist(), rewards]
custom = {tuple(t) for t in tasks}
assert custom <= set(suite.ALL_TASKS) and custom <= set(suite._get_tasks('custom'))
owners = {suite._DOMAINS[d].SUITE[t].__module__ for d, t in custom}
assert owners == {'tdmpc2_tpu_torch.envs.tasks._register'}, owners
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'tdmpc2_tpu'))
assert not bad, bad
print(json.dumps(out))
'''


def test_custom_tasks_through_the_port_factory_alone():
    """A process that imports only the port registers the 28 custom tasks
    itself (its task factories own the suite's entries), and its env
    factory builds each: 3 steps against the JAX task factories' here, bit
    for bit (through float64 JSON, which keeps every float32)."""
    pytest.importorskip('dm_control')
    steps = 3
    res = subprocess.run(
        [sys.executable, '-c', PORT_ONLY, json.dumps(CUSTOM), str(steps)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.splitlines()[-1])
    jax_ = _task_factories('tdmpc2_tpu')
    for i, (domain, task) in enumerate(CUSTOM):
        name = {'ball_in_cup': 'cup'}.get(domain, domain) + '-' + task.replace('_', '-')
        rows, rewards = _custom_steps(
            _custom_env('tdmpc2_tpu', jax_[domain, task], domain, 5 + i), steps, i)
        np.testing.assert_array_equal(np.asarray(got[name][0], np.float32), rows, err_msg=name)
        np.testing.assert_array_equal(np.asarray(got[name][1], np.float32), rewards,
                                      err_msg=name)


# ----------------------------------------------------------------- Gymnasium


@pytest.mark.parametrize('task', sorted(GYM_TASKS))
def test_gym_task_matches_jax(task):
    """The episodic Gymnasium tasks: the config mutation, true `terminated`,
    lunarlander's success, per-task timeouts. The adapters reset the
    backend unseeded (as the reference does), so both backends are seeded
    the same here first."""
    pytest.importorskip('gymnasium')
    pytest.importorskip(GYM_TASKS[task])
    cfg, jcfg = _cfgs(task, episodic=True)
    env, jenv = make_env(cfg), jmake_env(jcfg)
    assert _fields(cfg) == _fields(jcfg)
    assert (cfg.discount_max, cfg.rho) == (0.99, 0.7)
    for e in (env, jenv):
        e._env.reset(seed=11)
        e._env.action_space.seed(11)
    _same(env.rand_act(), jenv.rand_act())
    out = _hold(env, jenv, 40)
    assert isinstance(out[3]['terminated'], float)


# ------------------------------------------------- Meta-World, ManiSkill2, MyoSuite


def _both(task, made, **kw):
    """Both packages' envs of `task`, each with what its adapter asked of
    the mocked backend (the fixture's record after each build)."""
    cfg, jcfg = _cfgs(task, **kw)
    env = make_env(cfg)
    calls = dict(made)
    jenv = jmake_env(jcfg)
    jcalls = dict(made)
    assert calls['env'] is not jcalls['env']
    assert _fields(cfg) == _fields(jcfg)
    return env, jenv, calls, jcalls


def test_metaworld_matches_jax(mw_modules):  # noqa: F811
    env, jenv, calls, jcalls = _both('mw-assembly', mw_modules)
    mock, jmock = calls['env'], jcalls['env']
    assert mock.seed_arg == jmock.seed_arg
    np.testing.assert_array_equal(mock.model.cam_pos, jmock.model.cam_pos)
    assert mock._freeze_rand_vec is jmock._freeze_rand_vec is False
    _hold(env, jenv, 105)
    assert len(mock.actions) == len(jmock.actions)
    for a, b in zip(mock.actions, jmock.actions):
        _same(a, b)
    np.random.seed(0)
    a = env.rand_act()
    np.random.seed(0)
    _same(a, jenv.rand_act())


@pytest.mark.parametrize('task', ['lift-cube', 'pick-cube', 'stack-cube', 'pick-ycb',
                                  'turn-faucet'])
@pytest.mark.parametrize('done_at', [10 ** 9, 3])
def test_maniskill_matches_jax(ms_modules, task, done_at):  # noqa: F811
    ms_modules['done_at'] = done_at
    env, jenv, calls, jcalls = _both(task, ms_modules)
    assert (calls['env_id'], calls['kwargs']) == (jcalls['env_id'], jcalls['kwargs'])
    _hold(env, jenv, 12, lo=-2.0, hi=2.0)
    assert calls['env'].n_steps == jcalls['env'].n_steps
    _same(env.rand_act(), jenv.rand_act())


@pytest.mark.parametrize('task', ['myo-reach', 'myo-reach-hard', 'myo-pose', 'myo-pose-hard',
                                  'myo-obj-hold', 'myo-obj-hold-hard', 'myo-key-turn',
                                  'myo-key-turn-hard', 'myo-pen-twirl', 'myo-pen-twirl-hard'])
def test_myosuite_matches_jax(myo_modules, task):  # noqa: F811
    env, jenv, calls, jcalls = _both(task, myo_modules)
    assert calls['env_id'] == jcalls['env_id']
    out = _hold(env, jenv, 102, lo=0.0, hi=1.0)
    assert calls['env'].n_steps == jcalls['env'].n_steps and out[3]['success'] == 1.0


def test_mocked_backends_refuse_rgb(mw_modules, myo_modules):  # noqa: F811
    for task in ('mw-assembly', 'myo-reach'):
        cfg, jcfg = _cfgs(task, obs='rgb')
        with pytest.raises(ValueError) as e:
            make_env(cfg)
        with pytest.raises(ValueError) as je:
            jmake_env(jcfg)
        assert str(e.value) == str(je.value)


# ------------------------------------------------------------------ mt30, mt80


@pytest.fixture
def mw_all(monkeypatch):
    """The Meta-World mock with every mt80 Meta-World task registered."""
    envs_mod = types.ModuleType('metaworld.envs')
    envs_mod.ALL_V2_ENVIRONMENTS_GOAL_OBSERVABLE = {
        t.split('-', 1)[1] + '-v2-goal-observable': mocks._MockMWEnv
        for t in TASK_SET['mt80'] if t.startswith('mw-')}
    pkg = types.ModuleType('metaworld')
    pkg.envs = envs_mod
    monkeypatch.setitem(sys.modules, 'metaworld', pkg)
    monkeypatch.setitem(sys.modules, 'metaworld.envs', envs_mod)


def _hold_multitask(task, task_ids):
    cfg, jcfg = _cfgs(task)
    env, jenv = make_env(cfg), jmake_env(jcfg)
    assert _fields(cfg, multitask=True) == _fields(jcfg, multitask=True)
    assert len(cfg.obs_shapes) == len(TASK_SET[task])
    _same_space(env.observation_space, jenv.observation_space)
    _same_space(env.action_space, jenv.action_space)
    rng = np.random.default_rng(1)
    for i in task_ids:
        _same(env.reset(i), jenv.reset(i))
        assert env.task == jenv.task == TASK_SET[task][i]
        assert env.max_episode_steps == jenv.max_episode_steps
        for _ in range(5):
            a = rng.uniform(-1, 1, env.action_space.shape).astype(np.float32)
            for x, y in zip(env.step(a), jenv.step(a)):
                _same(x, y)
    return cfg


def test_mt30_matches_jax():
    pytest.importorskip('dm_control')
    cfg = _hold_multitask('mt30', [0, 8, 16, 21, 29])
    assert cfg.obs_shape == {'state': (24,)} and cfg.action_dim == 6


def test_mt80_matches_jax(mw_all):
    pytest.importorskip('dm_control')
    cfg = _hold_multitask('mt80', [3, 30, 79])
    assert cfg.obs_shapes[30:] == [39] * 50 and cfg.episode_lengths[30:] == [100] * 50


# ------------------------------------------------------------------ the factory


def test_unknown_task_error_matches_jax():
    cfg, jcfg = _cfgs('nonexistent-task-xyz')
    with pytest.raises(ValueError, match='Failed to make environment') as e:
        make_env(cfg)
    with pytest.raises(ValueError) as je:
        jmake_env(jcfg)
    assert str(e.value) == str(je.value)


BLOCKED = '''
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('dm_control', 'mujoco', 'gymnasium'):
            raise ImportError(f'No module named {name!r} (blocked)')
sys.meta_path.insert(0, Block())
import tdmpc2_tpu_torch.envs, tdmpc2_tpu_torch.envs.dmcontrol, tdmpc2_tpu_torch.envs.subproc
from tdmpc2_tpu_torch.config import Config, parse_cfg
from tdmpc2_tpu_torch.envs import make_env
for task, backend in (('walker-walk', 'dm_control'), ('cheetah-run-backwards', 'dm_control'),
                      ('mujoco-walker', 'gymnasium')):
    try:
        make_env(parse_cfg(Config(task=task, device='cpu')))
    except ValueError as e:
        assert 'Failed to make environment' in str(e) and backend in str(e), e
    else:
        raise AssertionError(task)
make_env(parse_cfg(Config(task='toy-reach', num_envs=2, device='cpu')))
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('dm_control', 'mujoco', 'gymnasium'))
assert not bad, bad
print('ok')
'''


def test_envs_import_and_degrade_without_backends():
    """With dm_control, MuJoCo and Gymnasium unimportable, the port's env
    modules import, the toy tasks build, and a dm_control or Gymnasium task
    raises the factory's ValueError naming the missing backend."""
    res = subprocess.run([sys.executable, '-c', BLOCKED], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip().endswith('ok'), res.stderr[-3000:]
