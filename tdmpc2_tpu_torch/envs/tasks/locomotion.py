"""Custom locomotion task variants: cheetah (10), walker (8), hopper (3)
(a copy of tdmpc2_tpu/envs/tasks/locomotion.py).

Behavioral parity with the reference's custom DMControl tasks
(reference: tdmpc2/envs/tasks/{cheetah,walker,hopper}.py) — identical reward
shaping terms and model deltas — organized as data-driven reward tables over
stock dm_control Task classes instead of per-goal subclasses. Models come
from `_models.widened_arena` (longer ground planes so backwards locomotion
never leaves the arena).
"""

from __future__ import annotations

from functools import partial

from dm_control.rl import control
from dm_control.suite import cheetah, common, hopper, walker
from dm_control.utils import rewards

from tdmpc2_tpu_torch.envs.tasks import _models
from tdmpc2_tpu_torch.envs.tasks._register import body_z, register, torso_angmom

_INF = float('inf')

# ---------------------------------------------------------------------------
# cheetah — reference envs/tasks/cheetah.py
# ---------------------------------------------------------------------------

_CH_JUMP_H = 1.2     # torso/foot height for full stand/jump reward
_CH_LIE_H = 0.25     # torso height below which lie-down reward is full
_CH_SPIN = 8         # angular momentum for full flip reward
_CH_RUN = cheetah._RUN_SPEED  # 10


def _ch_speed_at_least(physics, speed, sign=1.0):
    return rewards.tolerance(sign * physics.speed(), bounds=(speed, _INF),
                             margin=speed, value_at_margin=0,
                             sigmoid='linear')


def _ch_run_backwards(physics, ms):
    return rewards.tolerance(physics.speed(), bounds=(-_INF, -ms), margin=ms,
                             value_at_margin=0, sigmoid='linear')


def _ch_stand_one_foot(physics, ms, air_foot):
    """Stand with `air_foot` off the ground, torso high, roughly still."""
    height = (body_z(physics, 'torso') + body_z(physics, air_foot)) / 2
    high = rewards.tolerance(height, bounds=(_CH_JUMP_H, _INF),
                             margin=_CH_JUMP_H / 2)
    slow = rewards.tolerance(physics.speed(), bounds=(-ms, ms), margin=ms,
                             value_at_margin=0, sigmoid='linear')
    return (5 * high + slow) / 6


def _ch_jump(physics, ms):
    return (_ch_stand_one_foot(physics, ms, 'bfoot')
            + _ch_stand_one_foot(physics, ms, 'ffoot')) / 2


def _ch_run_one_foot(physics, ms, air_foot):
    """Move at >= ms with `air_foot` and the torso held high."""
    torso_up = rewards.tolerance(body_z(physics, 'torso'),
                                 bounds=(_CH_JUMP_H, _INF),
                                 margin=_CH_JUMP_H / 2)
    foot_up = rewards.tolerance(body_z(physics, air_foot),
                                bounds=(_CH_JUMP_H, _INF),
                                margin=_CH_JUMP_H / 2)
    up = (3 * foot_up + 2 * torso_up) / 5
    if ms == 0:
        return up
    return up * (5 * _ch_speed_at_least(physics, ms) + 1) / 6


def _ch_lie_down(physics, ms):
    feet = (body_z(physics, 'ffoot') + body_z(physics, 'bfoot')) / 2
    low = partial(rewards.tolerance, bounds=(-_INF, _CH_LIE_H),
                  margin=_CH_LIE_H, value_at_margin=0, sigmoid='linear')
    return (3 * low(body_z(physics, 'torso')) + low(feet)) / 4


def _ch_legs_up(physics, ms):
    torso_down = rewards.tolerance(body_z(physics, 'torso'),
                                   bounds=(-_INF, _CH_LIE_H),
                                   margin=_CH_LIE_H / 2)
    return (5 * torso_down + _ch_run_one_foot(physics, 0, 'bfoot')) / 6


def _ch_flip(physics, ms, sign=1.0):
    spin = rewards.tolerance(sign * torso_angmom(physics),
                             bounds=(_CH_SPIN, _INF), margin=_CH_SPIN,
                             value_at_margin=0, sigmoid='linear')
    return (2 * spin + _ch_speed_at_least(physics, ms, sign)) / 3


# task name -> (reward_fn(physics, move_speed), move_speed)
_CHEETAH_TASKS = {
    'run_backwards': (_ch_run_backwards, _CH_RUN * 0.8),
    'stand_front': (partial(_ch_stand_one_foot, air_foot='bfoot'), 0.5),
    'stand_back': (partial(_ch_stand_one_foot, air_foot='ffoot'), 0.5),
    'jump': (_ch_jump, 0.5),
    'run_front': (partial(_ch_run_one_foot, air_foot='bfoot'), _CH_RUN * 0.6),
    'run_back': (partial(_ch_run_one_foot, air_foot='ffoot'), _CH_RUN * 0.6),
    'lie_down': (_ch_lie_down, 0),
    'legs_up': (_ch_legs_up, 0),
    'flip': (partial(_ch_flip, sign=1.0), _CH_RUN),
    'flip_backwards': (partial(_ch_flip, sign=-1.0), _CH_RUN * 0.8),
}


class _RewardTask(cheetah.Cheetah):
    """Cheetah with an externally supplied reward function."""

    def __init__(self, reward_fn, random=None):
        super().__init__(random=random)
        self._reward_fn = reward_fn

    def get_reward(self, physics):
        return self._reward_fn(physics)


def _make_cheetah(reward_fn, ms, time_limit, random, env_kwargs):
    xml = _models.widened_arena('cheetah', 'ground', 200)
    physics = cheetah.Physics.from_xml_string(xml, common.ASSETS)
    task = _RewardTask(partial(reward_fn, ms=ms), random=random)
    return control.Environment(
        physics, task,
        time_limit=cheetah._DEFAULT_TIME_LIMIT if time_limit is None else time_limit,
        **env_kwargs)


# ---------------------------------------------------------------------------
# walker — reference envs/tasks/walker.py
# ---------------------------------------------------------------------------

_WK_STAND_H = 1.0    # yoga stand height (< walker._STAND_HEIGHT=1.2)
_WK_LIE_H = 0.08
_WK_LEGS_UP_H = 1.1


def _wk_feet_z(physics):
    return ((body_z(physics, 'left_foot') + body_z(physics, 'right_foot')) / 2)


def _wk_thigh_z(physics):
    return ((body_z(physics, 'left_thigh') + body_z(physics, 'right_thigh')) / 2)


def _wk_move(physics, ms):
    """Signed-speed shaping term shared by backwards/flip tasks."""
    bounds = (ms, _INF) if ms > 0 else (-_INF, ms)
    return rewards.tolerance(physics.horizontal_velocity(), bounds=bounds,
                             margin=abs(ms) / 2, value_at_margin=0.5,
                             sigmoid='linear')


def _wk_backwards(physics, ms):
    standing = rewards.tolerance(physics.torso_height(),
                                 bounds=(walker._STAND_HEIGHT, _INF),
                                 margin=walker._STAND_HEIGHT / 2)
    upright = (1 + physics.torso_upright()) / 2
    stand = (3 * standing + upright) / 4
    if ms == 0:
        return stand
    return stand * (5 * _wk_move(physics, -ms) + 1) / 6


def _wk_arabesque(physics, ms):
    standing = rewards.tolerance(physics.torso_height(),
                                 bounds=(_WK_STAND_H, _INF),
                                 margin=_WK_STAND_H / 2)
    foot_down = rewards.tolerance(body_z(physics, 'left_foot'),
                                  bounds=(-_INF, _WK_LIE_H),
                                  margin=_WK_STAND_H / 2)
    foot_up = rewards.tolerance(body_z(physics, 'right_foot'),
                                bounds=(_WK_STAND_H, _INF),
                                margin=_WK_STAND_H / 2)
    inverted = (1 - physics.torso_upright()) / 2
    return (3 * standing + foot_down + foot_up + inverted) / 6


def _wk_lie_down(physics, ms):
    low = partial(rewards.tolerance, bounds=(-_INF, _WK_LIE_H),
                  margin=_WK_LIE_H / 2)
    inverted = (1 - physics.torso_upright()) / 2
    return (3 * low(physics.torso_height()) + low(_wk_thigh_z(physics))
            + inverted) / 5


def _wk_legs_up(physics, ms):
    low = partial(rewards.tolerance, bounds=(-_INF, _WK_LIE_H),
                  margin=_WK_LIE_H / 2)
    legs_up = rewards.tolerance(_wk_feet_z(physics),
                                bounds=(_WK_LEGS_UP_H, _INF),
                                margin=_WK_LEGS_UP_H / 2)
    inverted = (1 - physics.torso_upright()) / 2
    return (3 * low(physics.torso_height()) + 2 * legs_up
            + low(_wk_thigh_z(physics)) + inverted) / 7


def _wk_flip(physics, ms):
    thigh_up = rewards.tolerance(_wk_thigh_z(physics),
                                 bounds=(_WK_STAND_H, _INF),
                                 margin=_WK_STAND_H / 2)
    legs_up = rewards.tolerance(_wk_feet_z(physics),
                                bounds=(_WK_LEGS_UP_H, _INF),
                                margin=_WK_LEGS_UP_H / 2)
    upside_down = (3 * legs_up + 2 * thigh_up) / 5
    if ms == 0:
        return upside_down
    return upside_down * (5 * _wk_move(physics, ms) + 1) / 6


_WALKER_TASKS = {
    'walk_backwards': (_wk_backwards, walker._WALK_SPEED),
    'run_backwards': (_wk_backwards, walker._RUN_SPEED),
    'arabesque': (_wk_arabesque, 0),
    'lie_down': (_wk_lie_down, 0),
    'legs_up': (_wk_legs_up, 0),
    'headstand': (_wk_flip, 0),
    'flip': (_wk_flip, walker._RUN_SPEED * 0.75),
    'backflip': (_wk_flip, -walker._RUN_SPEED * 0.75),
}


class _WalkerTask(walker.PlanarWalker):
    def __init__(self, reward_fn, random=None):
        super().__init__(0, random)
        self._reward_fn = reward_fn

    def get_reward(self, physics):
        return self._reward_fn(physics)


def _make_walker(reward_fn, ms, time_limit, random, env_kwargs):
    xml = _models.widened_arena('walker', 'floor', 500)
    physics = walker.Physics.from_xml_string(xml, common.ASSETS)
    task = _WalkerTask(partial(reward_fn, ms=ms), random=random)
    return control.Environment(
        physics, task,
        time_limit=walker._DEFAULT_TIME_LIMIT if time_limit is None else time_limit,
        control_timestep=walker._CONTROL_TIMESTEP, **env_kwargs)


# ---------------------------------------------------------------------------
# hopper — reference envs/tasks/hopper.py
# ---------------------------------------------------------------------------

_HP_STAND_H = 0.6
_HP_HOP = 2
_HP_SPIN = 5


def _hp_hop_backwards(physics):
    standing = rewards.tolerance(physics.height(), (_HP_STAND_H, 2))
    hopping = rewards.tolerance(physics.speed(),
                                bounds=(-_INF, -_HP_HOP / 2),
                                margin=_HP_HOP / 4, value_at_margin=0.5,
                                sigmoid='linear')
    return standing * hopping


def _hp_flip(physics, sign=1.0):
    return rewards.tolerance(sign * torso_angmom(physics),
                             bounds=(_HP_SPIN, _INF), margin=_HP_SPIN / 2,
                             value_at_margin=0, sigmoid='linear')


_HOPPER_TASKS = {
    'hop_backwards': _hp_hop_backwards,
    'flip': partial(_hp_flip, sign=1.0),
    'flip_backwards': partial(_hp_flip, sign=-1.0),
}


class _HopperTask(hopper.Hopper):
    def __init__(self, reward_fn, random=None):
        super().__init__(None, random)
        self._reward_fn = reward_fn

    def get_reward(self, physics):
        return self._reward_fn(physics)


def _make_hopper(reward_fn, time_limit, random, env_kwargs):
    physics = hopper.Physics.from_xml_string(
        _models.stock_xml('hopper'), common.ASSETS)
    task = _HopperTask(reward_fn, random=random)
    return control.Environment(
        physics, task, time_limit=20 if time_limit is None else time_limit,
        control_timestep=0.02, **env_kwargs)


# ---------------------------------------------------------------------------


def register_all():
    for name, (fn, ms) in _CHEETAH_TASKS.items():
        register(cheetah, name, partial(_make_cheetah, fn, ms))
    for name, (fn, ms) in _WALKER_TASKS.items():
        register(walker, name, partial(_make_walker, fn, ms))
    for name, fn in _HOPPER_TASKS.items():
        register(hopper, name, partial(_make_hopper, fn))
