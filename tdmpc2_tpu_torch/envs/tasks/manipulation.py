"""Custom non-locomotion task variants: reacher (4), cup (1), pendulum (1),
fish (1) (a copy of tdmpc2_tpu/envs/tasks/manipulation.py).

Behavioral parity with the reference's custom DMControl tasks (reference:
tdmpc2/envs/tasks/{reacher,ball_in_cup,pendulum,fish}.py): 3-/4-link reachers
on programmatically generated arm chains, ball-in-cup spin with collision-free
random ball init, pendulum spin, and fish swim-to-target among four obstacle
walls.
"""

from __future__ import annotations

from collections import OrderedDict
from functools import partial

import numpy as np
from dm_control.rl import control
from dm_control.suite import ball_in_cup, base, common, fish, pendulum, reacher
from dm_control.utils import rewards

from tdmpc2_tpu_torch.envs.tasks import _models
from tdmpc2_tpu_torch.envs.tasks._register import register

_INF = float('inf')

# ---------------------------------------------------------------------------
# reacher: three/four links x easy/hard — reference envs/tasks/reacher.py
# ---------------------------------------------------------------------------


def _make_reacher(links, target_size, time_limit, random, env_kwargs):
    physics = reacher.Physics.from_xml_string(
        _models.multilink_reacher(links), common.ASSETS)
    task = reacher.Reacher(target_size=target_size, random=random)
    return control.Environment(
        physics, task, time_limit=20 if time_limit is None else time_limit,
        **env_kwargs)


_REACHER_TASKS = {  # name -> (links, target radius)
    'three_easy': (3, .05),
    'three_hard': (3, .015),
    'four_easy': (4, .05),
    'four_hard': (4, .015),
}

# ---------------------------------------------------------------------------
# ball_in_cup: spin — reference envs/tasks/ball_in_cup.py
# ---------------------------------------------------------------------------

_CUP_DIST = 0.5
_CUP_SPEED = 6.


def _ball_to_target(physics):
    target = physics.named.data.site_xpos['target', ['x', 'z']]
    ball = physics.named.data.xpos['ball', ['x', 'z']]
    return target - ball


def _ball_in_target(physics) -> float:
    gap = np.abs(_ball_to_target(physics))
    target_size = physics.named.model.site_size['target', [0, 2]]
    ball_size = physics.named.model.geom_size['ball', 0]
    return float(np.all(gap < target_size - ball_size))


class _CupSpin(ball_in_cup.BallInCup):
    """Keep the ball circling the target: far from it and fast, never inside."""

    def initialize_episode(self, physics):
        # Rejection-sample a collision-free ball position; with p=0.9 require
        # it to start inside the target (so "leave the cup" is part of the
        # task), with p=0.1 anywhere valid.
        must_start_in_target = self.random.uniform() >= 0.1
        while True:
            physics.named.data.qpos['ball_x'] = self.random.uniform(-.2, .2)
            physics.named.data.qpos['ball_z'] = self.random.uniform(.2, .5)
            physics.after_reset()
            if physics.data.ncon > 0:
                continue
            if _ball_in_target(physics) or not must_start_in_target:
                break
        base.Task.initialize_episode(self, physics)

    def get_observation(self, physics):
        obs = OrderedDict()
        obs['position'] = physics.position()
        obs['velocity'] = physics.velocity()
        return obs

    def get_reward(self, physics):
        far = rewards.tolerance(np.linalg.norm(_ball_to_target(physics)),
                                bounds=(_CUP_DIST, _INF), margin=_CUP_DIST / 2,
                                value_at_margin=0.5, sigmoid='linear')
        speed = float(np.hypot(physics.named.data.qvel['ball_x'].item(),
                               physics.named.data.qvel['ball_z'].item()))
        fast = rewards.tolerance(speed, bounds=(_CUP_SPEED, _INF),
                                 margin=_CUP_SPEED / 2, value_at_margin=0.5,
                                 sigmoid='linear')
        outside = 1 - _ball_in_target(physics)
        return outside * (far + 2 * fast) / 3


def _make_cup(time_limit, random, env_kwargs):
    physics = ball_in_cup.Physics.from_xml_string(
        _models.stock_xml('ball_in_cup'), common.ASSETS)
    task = _CupSpin(random=random)
    return control.Environment(
        physics, task, time_limit=20 if time_limit is None else time_limit,
        control_timestep=.02, **env_kwargs)


# ---------------------------------------------------------------------------
# pendulum: spin — reference envs/tasks/pendulum.py
# ---------------------------------------------------------------------------

_PEND_SPEED = 9.


class _PendulumSpin(pendulum.SwingUp):
    def get_reward(self, physics):
        return rewards.tolerance(
            np.linalg.norm(physics.angular_velocity()),
            bounds=(_PEND_SPEED, _INF), margin=_PEND_SPEED / 2,
            value_at_margin=0.5, sigmoid='linear')


def _make_pendulum(time_limit, random, env_kwargs):
    physics = pendulum.Physics.from_xml_string(
        _models.stock_xml('pendulum'), common.ASSETS)
    task = _PendulumSpin(random=random)
    return control.Environment(
        physics, task, time_limit=20 if time_limit is None else time_limit,
        **env_kwargs)


# ---------------------------------------------------------------------------
# fish: obstacles — reference envs/tasks/fish.py
# ---------------------------------------------------------------------------

_FISH_JOINTS = ('tail1', 'tail_twist', 'tail2', 'finright_roll',
                'finright_pitch', 'finleft_roll', 'finleft_pitch')
_WALLS = ('wall0', 'wall1', 'wall2', 'wall3')


def _near_wall(physics, name: str, min_distance: float) -> bool:
    pos = physics.named.data.geom_xpos[name][:2]
    return any(
        np.min(np.abs(pos - physics.named.data.geom_xpos[w][:2])) < min_distance
        for w in _WALLS)


class _FishObstacles(fish.Swim):
    """Swim to a random target while avoiding four walls."""

    def initialize_episode(self, physics):
        while True:
            quat = self.random.randn(4)
            physics.named.data.qpos['root'][3:7] = quat / np.linalg.norm(quat)
            for joint in _FISH_JOINTS:
                physics.named.data.qpos[joint] = self.random.uniform(-.2, .2)
            physics.named.model.geom_pos['target', 'x'] = self.random.uniform(-.4, .4)
            physics.named.model.geom_pos['target', 'y'] = self.random.uniform(-.4, .4)
            physics.named.model.geom_pos['target', 'z'] = self.random.uniform(.1, .3)
            physics.after_reset()
            if not _near_wall(physics, 'target', 0.08):
                break
        base.Task.initialize_episode(self, physics)

    def get_reward(self, physics):
        radii = physics.named.model.geom_size[['mouth', 'target'], 0].sum()
        in_target = rewards.tolerance(
            np.linalg.norm(physics.mouth_to_target()),
            bounds=(0, radii), margin=2 * radii)
        upright = 0.5 * (physics.upright() + 1)
        clear_of_walls = 1. - _near_wall(physics, 'torso', 0.06)
        return clear_of_walls * (7 * in_target + upright) / 8


def _make_fish(time_limit, random, env_kwargs):
    physics = fish.Physics.from_xml_string(
        _models.fish_with_walls(), common.ASSETS)
    task = _FishObstacles(random=random)
    return control.Environment(
        physics, task, time_limit=40 if time_limit is None else time_limit,
        control_timestep=.04, **env_kwargs)


# ---------------------------------------------------------------------------


def register_all():
    for name, (links, size) in _REACHER_TASKS.items():
        register(reacher, name, partial(_make_reacher, links, size))
    register(ball_in_cup, 'spin', _make_cup)
    register(pendulum, 'spin', _make_pendulum)
    register(fish, 'obstacles', _make_fish)
