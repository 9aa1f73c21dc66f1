"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \\
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

into a plain-C shared library that `ctypes` loads. `<hash>` covers every
source under `csrc/` and the flags, so an edit rebuilds and an unchanged
tree reuses the library. `_build/` is listed in `.gitignore`. The sources
are compiled in parallel, one `nvcc` each. A missing `nvcc`, a failed build
or a failed load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
SOURCES = ('value', 'cem', 'rollout', 'probe')
WIDE_SOURCES = ('value', 'cem', 'rollout')   # the ones that include mlp_wide.cuh
FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3', '-std=c++17',
         '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
_PTRS, _INTS = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
_LONGS = ctypes.POINTER(ctypes.c_long)
# (library, function) -> argtypes; every function returns a cudaError_t as int
SIGNATURES = {
    ('value', 'tdm_value'): (_PTRS, _INTS, _F, _F, _I, _I, _I, _P, _L, _L, _P,
                             _L, _L, _L, _P, _I, _P, _L, _P, _L, _P, _L, _P,
                             _L, _P, _P, _P),
    ('value', 'tdm_value_sampled'): (_PTRS, _INTS, _F, _F, _I, _I, _I, _P, _L, _L,
                                     _P, _L, _P, _L, _P, _L, _P, _L, _I, _P,
                                     _P, _I, _P, _L, _P, _L, _P, _L, _P, _L,
                                     _P, _P, _P),
    ('value', 'tdm_value_wide'): (_PTRS, _INTS, _F, _F, _I, _I, _I, _P, _L, _L,
                                  _P, _L, _L, _L, _P, _I, _P, _L, _P, _L, _P,
                                  _L, _P, _L, _P, _P, _PTRS, _LONGS, _INTS,
                                  _P),
    ('value', 'tdm_value_sampled_wide'): (_PTRS, _INTS, _F, _F, _I, _I, _I, _P,
                                          _L, _L, _P, _L, _P, _L, _P, _L, _P,
                                          _L, _I, _P, _P, _I, _P, _L, _P, _L,
                                          _P, _L, _P, _L, _P, _P, _PTRS,
                                          _LONGS, _INTS, _P),
    ('value', 'tdm_value_plan'): (_INTS, _INTS),
    ('value', 'tdm_wide_stage'): (_INTS, _I, _I, _I, _I, _P, _L, _L, _P, _L, _P, _L,
                                  _P, _L, _P, _L, _I, _P, _P, _L, _P, _L, _P, _P,
                                  _P, _P, _P, _INTS, _P),
    ('cem', 'tdm_pi_rollout_plan'): (_INTS, _INTS),
    ('cem', 'tdm_pi_rollout'): (_PTRS, _INTS, _F, _F, _I, _I, _P, _L, _P, _L,
                                _P, _I, _P, _L, _P, _P),
    ('cem', 'tdm_pi_rollout_wide'): (_PTRS, _INTS, _F, _F, _I, _I, _P, _L, _P,
                                     _L, _P, _I, _P, _L, _P, _PTRS, _LONGS,
                                     _P, _INTS, _P),
    ('cem', 'tdm_elite'): (_P, _P, _P, _L, _I, _I, _I, _I, _I, _F, _F, _F, _P,
                           _P, _P, _P),
    ('rollout', 'tdm_rollout'): (_PTRS, _INTS, _I, _P, _L, _P, _L, _L, _P,
                                 _P, _P, _PTRS, _LONGS, _INTS, _P),
    ('rollout', 'tdm_wide_gemm'): (_INTS, _I, _I, _P, _L, _I, _P, _L, _I, _P, _L,
                                   _L, _P, _I, _P, _I, _P, _L, _P, _L, _INTS,
                                   _INTS, _P),
    ('rollout', 'tdm_wide_rows'): (_INTS, _I, _I, _I, _P, _L, _I, _I, _PTRS, _LONGS,
                                   _F, _F, _INTS, _INTS, _P),
    ('rollout', 'tdm_wide_fold_u'): (_INTS, _I, _P, _L, _I, _P, _L, _I, _P, _L, _INTS,
                                     _INTS, _P),
    ('rollout', 'tdm_wide_fold_hidden'): (_INTS, _I, _I, _P, _L, _P, _L, _P, _L, _L,
                                          _I, _P, _L, _P, _I, _P, _P, _P, _L, _INTS,
                                          _INTS, _P),
    ('probe', 'tdm_probe'): (_P, _P, _L, _P),
}

_loaded: dict = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get('CUDA_HOME'):
        cands.append(str(Path(os.environ['CUDA_HOME']) / 'bin' / 'nvcc'))
    if shutil.which('nvcc'):
        cands.append(shutil.which('nvcc'))
    cands.append('/usr/local/cuda/bin/nvcc')
    for c in cands:
        if Path(c).is_file():
            return c
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH)')


def _digest() -> str:
    h = hashlib.sha256(' '.join(FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def target(name: str, defines=()) -> Path:
    tag = ''.join(f'-{d.lower()}' for d in defines)
    return BUILD_DIR / f'{name}{tag}-{_digest()}.so'


def build(names=SOURCES, defines=()) -> dict:
    """Compile every library of `names` that is not built yet, all at once,
    with the preprocessor `defines` (a variant of its own, such as
    TDM_CYCLES: csrc/mlp_rows.cuh's cycle counters).

    Returns {name: (seconds, ptxas report)} for the ones it compiled."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not target(n, defines).exists()]
    if not todo:
        return {}
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = BUILD_DIR / f'{n}.{os.getpid()}.tmp.so'
        cmd = [exe, *FLAGS, *[f'-D{d}' for d in defines], '-o', str(tmp),
               str(CSRC / f'{n}.cu')]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    report, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'{n}.cu (nvcc exit {proc.returncode}):\n{out}')
            continue
        os.replace(tmp, target(n, defines))
        target(n, defines).with_suffix('.ptxas.txt').write_text(out)
        report[n] = (time.perf_counter() - t0, out)
    if failed:
        raise RuntimeError('CUDA build failed:\n' + '\n'.join(failed))
    return report


def ptxas_report(name: str) -> str:
    """The `-Xptxas -v` report of the built library `name` ('' if none)."""
    p = target(name).with_suffix('.ptxas.txt')
    return p.read_text() if p.exists() else ''


def library(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library `name` (built with `defines`), built first if
    needed."""
    lib = _loaded.get((name, defines))
    if lib is None:
        build((name,), defines)
        lib = ctypes.CDLL(str(target(name, defines)))
        for (lname, fn), argtypes in SIGNATURES.items():
            if lname == name:
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
        lib.tdm_error_name.argtypes = (ctypes.c_int,)
        lib.tdm_error_name.restype = ctypes.c_char_p
        if name in WIDE_SOURCES:   # csrc/mlp_wide.cuh's report functions
            lib.tdm_wide_plan.argtypes = (_INTS, _I, _INTS)
            lib.tdm_engine.argtypes = (_INTS,)
            lib.tdm_wide_plan.restype = lib.tdm_engine.restype = ctypes.c_int
        _loaded[(name, defines)] = lib
    return lib


# Returned by a launch function when its engine does not take the model's
# widths (csrc/mlp_rows.cuh kNoPlan).
NO_PLAN = 10000


def check(lib: ctypes.CDLL, rc: int, what: str, dims=None):
    """Raise if a launch function returned an error: ValueError naming the
    widths (`dims`, csrc/mlp_rows.cuh's Dims order) when its engine does not
    take them, RuntimeError for a CUDA error."""
    if rc == NO_PLAN:
        names = ('L', 'M', 'A', 'B', 'num_q', 'simnorm_dim', 'H')
        widths = ', '.join(f'{k}={v}' for k, v in zip(names, dims or ()))
        raise ValueError(f'{what}: no engine takes the widths ({widths}): '
                         'the accumulators or shared memory are too small')
    if rc != 0:
        raise RuntimeError(
            f'{what}: {lib.tdm_error_name(rc).decode()} ({rc}) at launch')


def _template_ints(s: str) -> list:
    """The integer and bool arguments, nested ones too, of the template
    argument list `I ... E` that the mangled text s starts with ([] if it
    starts with none)."""
    if not s.startswith('I'):
        return []
    depth, i, vals = 0, 0, []
    while i < len(s):
        lit = re.match(r'L[ib](\d+)E', s[i:])
        if lit:
            vals.append(lit.group(1))
            i += lit.end()
            continue
        if s[i].isdigit():                 # a length-prefixed identifier
            n = re.match(r'\d+', s[i:])
            i += n.end() + int(n.group())
            continue
        if s[i] in 'IN':
            depth += 1
        elif s[i] == 'E':
            depth -= 1
            if depth == 0:
                break
        i += 1
    return vals


def _short(mangled: str) -> str:
    """`value_kernel<32,4,1>` for a function of namespace tdm (its integer
    and bool template arguments, the row tile and the mode, or the product's
    tile, `gemm_kernel<2,256>`, in brackets); other names as they are."""
    k = re.search(r'tdm(\d+)', mangled)   # namespace tdm, then the name
    if not k:
        return mangled
    end = k.end() + int(k.group(1))
    shape = ','.join(_template_ints(mangled[end:]))
    return mangled[k.end():end] + (f'<{shape}>' if shape else '')


def ptxas_usage(report: str) -> dict:
    """{function: (registers, spill store bytes, spill load bytes)} from an
    `nvcc -Xptxas -v` report, for kernels and the device functions they
    call (registers None for the latter: ptxas reports them per kernel)."""
    usage, fn, entry = {}, None, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = _short(m.group(1))
        m = re.search(r'Function properties for (\w+)', line)
        if m:
            fn = _short(m.group(1))
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
        if m and fn:
            usage[fn] = (usage.get(fn, (None,))[0], int(m.group(1)), int(m.group(2)))
        m = re.search(r'Used (\d+) registers', line)
        if m and entry:
            usage[entry] = (int(m.group(1)), *usage.get(entry, (None, 0, 0))[1:])
    return usage
