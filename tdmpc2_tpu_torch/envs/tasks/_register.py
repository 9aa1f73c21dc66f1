"""Registration machinery for custom DMControl task variants (a copy of
tdmpc2_tpu/envs/tasks/_register.py)."""

from __future__ import annotations


def torso_angmom(physics):
    """Angular momentum of the torso subtree about the world y-axis
    (used by the flip tasks; reference envs/tasks/cheetah.py:121-126)."""
    return physics.named.data.subtree_angmom['torso'][1]


def body_z(physics, name: str) -> float:
    """World z-coordinate of a named body frame."""
    return physics.named.data.xpos[name, 'z']


def register(suite_module, name: str, make_task) -> None:
    """Register `make_task` as task `name` in a dm_control domain SUITE.

    `make_task(time_limit, random, environment_kwargs) -> control.Environment`.
    Idempotent: re-registration is a no-op.
    """
    if name in suite_module.SUITE:
        return

    def factory(time_limit=None, random=None, environment_kwargs=None):
        return make_task(time_limit, random, environment_kwargs or {})

    factory.__name__ = name
    suite_module.SUITE.add('custom')(factory)
