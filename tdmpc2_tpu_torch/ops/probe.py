"""Kernel-engine canary: the port of the TPU canary `k`
(tdmpc2_tpu/ops/pallas_rollout.py:233, run by `mosaic_engine_alive` :242).

`add_one` is the kernel `csrc/probe.cu` (out = x + 1) on a CUDA tensor and
its plain version on a CPU tensor. `kernel_engine_alive` answers whether
this process can build, load and run the port's kernels on the card: it
builds the library here, then launches the kernel on an [8, 128] tile in a
child process that can be killed, because a card that is wedged
hangs a launch instead of raising. Only after the child succeeded does the
parent launch it once itself. The verdict is cached per process.

There is no fallback behind it: `TDMPC2` raises on a False verdict.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from tdmpc2_tpu_torch.ops import _build

SHAPE = (8, 128)

# The child's program: launch the canary once and check it.
_CHILD_SRC = """
import torch
from tdmpc2_tpu_torch.ops.probe import check_once
check_once(torch.device('cuda'))
print('KERNEL_OK')
"""

# Per-process verdict: None until the first call, then a dict with
# 'ok', 'reason' and the child's 'seconds'.
_verdict = None


def add_one_plain(x):
    return x + 1.0


def add_one(x):
    """The canary kernel on a CUDA tensor, its plain version on a CPU one.
    Any contiguous f32 tensor, a view with a storage offset too."""
    dev = x.device
    if dev.type == 'cpu':
        return add_one_plain(x)
    if dev.type != 'cuda':
        raise ValueError(f'add_one: unsupported device {dev}')
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError('add_one: needs a contiguous f32 tensor')
    out = torch.empty_like(x)
    if add_one.launch is None:
        add_one.launch = _build.library('probe').tdm_probe
    rc = add_one.launch(x.data_ptr(), out.data_ptr(), x.numel(),
                        torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        _build.check(_build.library('probe'), rc, 'probe kernel')
    add_one.launches += 1
    return out


add_one.launches = 0
add_one.launch = None     # the library's launch function, once loaded


def check_once(device):
    """Run the canary on a zero tile and raise unless it sums to 1024."""
    y = add_one(torch.zeros(SHAPE, dtype=torch.float32, device=device))
    total = float(y.sum())   # synchronises: a fault in the run shows here
    if total != SHAPE[0] * SHAPE[1]:
        raise RuntimeError(f'canary kernel computed a sum of {total}, '
                           f'not {SHAPE[0] * SHAPE[1]}')


def kernel_engine_alive(device='cuda', timeout: float = 150.0) -> bool:
    """True when the port's kernels build and run on `device`.

    The CPU runs the plain versions and answers True without a child. On
    the card the verdict of the first call is kept for the process;
    `verdict()` gives its reason and the child's time."""
    global _verdict
    if torch.device(device).type == 'cpu':
        return True
    if _verdict is not None:
        return _verdict['ok']
    _build.build(('probe',))
    repo = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env['PYTHONPATH'] = repo + os.pathsep + env.get('PYTHONPATH', '')
    t0 = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, '-c', _CHILD_SRC],
                           capture_output=True, text=True, timeout=timeout,
                           env=env)
    except subprocess.TimeoutExpired:
        _verdict = dict(ok=False, seconds=time.perf_counter() - t0,
                        reason=f'the canary child timed out after {timeout} s')
        return False
    seconds = time.perf_counter() - t0
    ok = r.returncode == 0 and 'KERNEL_OK' in r.stdout
    if ok:
        check_once(torch.device(device))    # raises if it fails here
    reason = ('ok' if ok else f'the canary child exited with rc={r.returncode}: '
              f'{r.stderr.strip()[-500:]}')
    _verdict = dict(ok=ok, seconds=seconds, reason=reason)
    return ok


def verdict():
    """The cached verdict dict ('ok', 'reason', 'seconds'), or None."""
    return _verdict
