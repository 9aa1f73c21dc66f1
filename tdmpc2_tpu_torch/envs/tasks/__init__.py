"""Custom dm_control task registrations (a copy of
tdmpc2_tpu/envs/tasks/__init__.py).

The reference ships 28 custom DMControl tasks across 7 domains plus modified
MuJoCo XMLs (reference: tdmpc2/envs/tasks/*). `register_all()` registers
ours into `dm_control.suite` under the 'custom' tag so `suite.load` finds
them; `envs.dmcontrol.make_env` calls it before it queries the suite, so
importing this package imports no dm_control (the JAX package registers
when its package is imported). Models are derived programmatically from
the stock suite XMLs (see `_models`); rewards live in `locomotion` (cheetah
10, walker 8, hopper 3) and `manipulation` (reacher 4, cup-spin,
pendulum-spin, fish-obstacles).

A task name is registered once per process: where the JAX package's
copies registered first (a test process that imports both), the suite
keeps those, which build the same tasks.
"""

_REGISTERED = False


def register_all():
    global _REGISTERED
    if _REGISTERED:
        return
    from dm_control import suite

    from tdmpc2_tpu_torch.envs.tasks import locomotion, manipulation
    locomotion.register_all()
    manipulation.register_all()
    custom = suite._get_tasks('custom')
    new = [t for t in custom if t not in suite.ALL_TASKS]
    suite.ALL_TASKS = suite.ALL_TASKS + tuple(new) if isinstance(
        suite.ALL_TASKS, tuple) else suite.ALL_TASKS + new
    suite.TASKS_BY_DOMAIN = suite._get_tasks_by_domain(suite.ALL_TASKS)
    _REGISTERED = True
