"""Worker-process vectorised environment (tdmpc2_tpu/envs/subproc.py).

No reference counterpart (the reference steps ONE env synchronously,
reference: tdmpc2/trainer/online_trainer.py:74-127). Each worker process
owns one env copy: its own MuJoCo state and EGL render context (EGL
contexts are thread-affine, so threads of one process cannot render in
parallel). Commands are pipelined: `step` sends all N actions before
receiving any result, so physics and rendering overlap across workers and
with the caller's device work. `vec_mode=auto` picks these workers for a
rendered (obs=rgb) dm_control task (envs.make_env).

A worker is a fresh interpreter, `python -m tdmpc2_tpu_torch.envs.subproc
FD`, as a `spawn` start gives, and not a fork: nothing of the parent's
CUDA context reaches it. It imports the port's envs and the env's backend,
and never torch: multiprocessing's spawn would import the parent's
`__main__` in each worker, which for `python -m tdmpc2_tpu_torch.train`
imports torch. It talks to the parent by pickled messages over its end of
a socket pair (FD, `multiprocessing.connection`): the config first, then
commands, and exits at 'close' or when the parent's end closes.
"""

from __future__ import annotations

import os
import subprocess
import sys
from copy import deepcopy
from multiprocessing.connection import Connection, Pipe
from pathlib import Path

import numpy as np

_ROOT = str(Path(__file__).resolve().parents[2])   # holds tdmpc2_tpu_torch/
CLOSE_TIMEOUT_S = 5


def _serve(remote):
    """A worker's loop: build the env from the config it is sent, report
    its spaces (or the exception that building it raised), then serve
    commands until 'close'."""
    from tdmpc2_tpu_torch.envs import _make_single_env
    try:
        try:
            env = _make_single_env(remote.recv())
        except Exception as e:     # reported to the parent, which raises it
            remote.send(('error', e))
            return
        remote.send(('ok', (env.observation_space, env.action_space,
                            env.max_episode_steps)))
        while True:
            cmd, data = remote.recv()
            if cmd == 'step':
                remote.send(env.step(data))
            elif cmd == 'reset':
                remote.send(env.reset())
            elif cmd == 'rand_act':
                remote.send(env.rand_act())
            elif cmd == 'render':
                remote.send(env.render(**(data or {})))
            elif cmd == 'close':
                break
    except (EOFError, KeyboardInterrupt):
        pass
    finally:
        remote.close()


class SubprocVecEnv:
    """N same-task env copies in worker processes; VecEnv's interface.
    `procs` are the workers' `subprocess.Popen`s; `close` ends them."""

    def __init__(self, cfg, num_envs=None, seed_list=None):
        seeds = (list(seed_list) if seed_list is not None
                 else [cfg.seed + 1000 * i   # decorrelated init, like vec.py
                       for i in range(int(num_envs or cfg.num_envs))])
        if not seeds:
            raise ValueError('SubprocVecEnv needs at least one env')
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [_ROOT] + [p for p in [os.environ.get('PYTHONPATH')] if p]))
        self._remotes, self.procs = [], []
        try:
            for s in seeds:
                c = deepcopy(cfg)
                c.seed, c.num_envs = int(s), 1
                parent, child = Pipe()
                fd = child.fileno()
                self.procs.append(subprocess.Popen(
                    [sys.executable, '-m', 'tdmpc2_tpu_torch.envs.subproc', str(fd)],
                    pass_fds=(fd,), env=env, stdin=subprocess.DEVNULL))
                child.close()
                self._remotes.append(parent)
                parent.send(c)
            metas = []
            for r in self._remotes:     # every copy built, or the first error
                status, meta = r.recv()
                if status == 'error':
                    raise meta
                metas.append(meta)
        except BaseException:
            self.close()
            raise
        (self.observation_space, self.action_space,
         self.max_episode_steps) = metas[0]

    @property
    def num_envs(self) -> int:
        return len(self._remotes)

    def reset(self):
        for r in self._remotes:
            r.send(('reset', None))
        return np.stack([r.recv() for r in self._remotes])

    def reset_at(self, i: int):
        """Reset one env copy (per-env episode boundaries, episodic tasks)."""
        self._remotes[i].send(('reset', None))
        return self._remotes[i].recv()

    def step(self, actions):
        actions = np.asarray(actions)
        for r, a in zip(self._remotes, actions):
            r.send(('step', a))
        obs, rewards, dones, infos = zip(*[r.recv() for r in self._remotes])
        return (np.stack(obs), np.asarray(rewards, np.float32),
                np.asarray(dones), list(infos))

    def rand_act(self):
        for r in self._remotes:
            r.send(('rand_act', None))
        return np.stack([r.recv() for r in self._remotes])

    def render(self, **kwargs):
        self._remotes[0].send(('render', kwargs))
        return self._remotes[0].recv()

    def close(self):
        """Ask each worker to exit, wait for it (killing one that has not
        exited within CLOSE_TIMEOUT_S) and close the pipes; idempotent."""
        for r in self._remotes:
            try:
                r.send(('close', None))
            except OSError:       # the worker is gone, or the pipe closed
                pass
        for p in self.procs:
            try:
                p.wait(timeout=CLOSE_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for r in self._remotes:
            r.close()


if __name__ == '__main__':
    _serve(Connection(int(sys.argv[1])))
