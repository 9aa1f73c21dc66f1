#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare DIR [PAIRS]  # kernel times against the port in DIR
    python3 chip_smoke.py --cycles        # value, elite and row kernels: block 0 cycles
    python3 chip_smoke.py --rows          # the build, then the row phase alone
    python3 chip_smoke.py --stage         # the build, the staging and the fold's kernels
    python3 chip_smoke.py --pixels        # the build, the canary, the pixel phases
    python3 chip_smoke.py --bf16-fleet    # the build, the canary, bf16 updates, the fleet
    python3 chip_smoke.py --envs          # the build, the canary, the env phases

Builds the port's CUDA kernels from `tdmpc2_tpu_torch/csrc` with nvcc,
runs the kernel-engine canary, holds every kernel against its plain
PyTorch version at the default 5M model's full width, then drives the
port's paths through the entry points a user calls, with random weights
drawn from a seed, each with the launch counters set to 0 just before it
and read just after:

- evaluate: `tdmpc2_tpu_torch.evaluate` on `toy-reach` (the planner);
- rollout: `ops.rollout.fused_value_rollout`, the reward+dynamics
  rollout's own entry point;
- train: `tdmpc2_tpu_torch.train` on `toy-reach`, 1,200 steps (1,000
  random, a 1,000-update burst, then planned steps with one update each),
  which constructs the agent and so runs the canary;
- vec train (the vectorised path): the same with `num_envs=8`, 1,200 env
  steps in vector steps of 8 (1,000 random, the 1,000-update burst as 125
  x `update_many(8)`, planned vector steps of one 8-env plan and 8
  updates, and the batched eval on the training envs);
- the env phases (`env_phases`, also alone with `--envs`): `train
  toy-reach num_envs=4` at the default 5M config, 1,200 env steps, with
  the env copies in worker processes (`vec_mode=subproc`: each a `python
  -m tdmpc2_tpu_torch.envs.subproc` that never loads torch) and then in
  this process (`inproc`), the same seed: the episode rewards, the replay
  buffer's contents and the final parameters bit for bit, the same launch
  counts, env-steps/s of each, and every worker ended; then the env
  factory on this machine: which of dm_control, Gymnasium and MuJoCo
  import, and without dm_control `make_env(task=walker-walk)` raising the
  factory's ValueError naming it (with it, `evaluate` of the committed
  acrobot-swingup checkpoint for one episode on its real env);
- episodic train: `train task=toy-reach-episodic episodic=true`, one env
  and `num_envs=8`, 1,200 env steps each (the value kernel's termination
  gate in every plan, the termination loss in every update; the task ends
  an episode on reaching the goal), and episodic evaluate: `evaluate` on
  the same task from the `num_envs=8` run's checkpoint;
- offline mt30 (multi-task, model_size 48, task_dim 64, the dataset's
  per-task dims): `OfflineTrainer` for 128 iterations on 8 seeded chunks of
  datasets/mt30_medium's geometry written to a temporary directory (eval
  past the last iteration: the card has no dm_control), then `act_tasks`
  over the 30 tasks for 5 lockstep steps on observations from the data;
- toy multi-task: `train` on a toy multi-task config (two toy tasks, the
  default 5M model): offline training, then the lockstep eval over its
  envs, and `evaluate` from its checkpoint;
- offline mt80 at model_size 317 (the published 317M model: mlp_dim 4096,
  latent 1376, 8 Q heads, task_dim 96; 80 tasks, mt30's then 50 Meta-World
  tasks of obs 39 and action 4): `OfflineTrainer` for 16 iterations on 2
  seeded chunks of the mt80 dataset's geometry (101-row episodes), then
  `act_tasks` over the 80 tasks for 3 lockstep steps, each a graph replay of
  the 13 planner calls and their 385 launches of the wide engine;
- bf16 train: `train bf16_update=true` on `toy-reach`, one env, 1,200
  steps (the update's products in bf16, acting f32 on the kernels);
- the fleet: `train seeds=3,7,11` on `toy-reach` at the default 5M config
  with 2 env copies a seed and with one, and on `toy-reach-episodic`
  (`fleet_phases`), each seed's plans on its own kernels' graphs.

Beside each of the five update graphs held (5M state and episodic, the
walker pixel model, mt30/48, mt80/317) a `bf16_update=true` agent on the
same state and batch (`bf16_twin_hold`): its graph against its eager body
bit for bit, one bf16 update against one f32 update under JAX's contract
(each loss within 5% of max(|f32|, 1), weights within 2e-3), its plan the
f32 agent's bit for bit, its times. The fleet's seed k is held against
the single agent of seed k bit for bit (plans and updates).

At model_size 317 no row tile fits, and the value step and the pi rollout
take the layer-per-launch engine (csrc/mlp_wide.cuh, ops/wide.py); the
rollout kernel takes it at every width. The wide engine is held against
the plain versions there: the value step (given actions, and episodic
under the gate rule, or, where two plain versions, the CPU's and the
card's, break the rule too, on no more rows than they do), the sampled
step (exactly the given-actions launch on its actions), the pi rollout and
the rollout, at one env and at N=8 tasks; N=8 and N=80 tasks against
one-task launches bit for bit; `act_tasks`' graph against its eager body;
and the rollout at model_size 1, 5, 19 and 48 in the width sweep. The
wide engine's product (`gemm_kernel`: wgmma fed by a TMA ring) is also
held alone, through the library's `tdm_wide_gemm` entry (`ops/wide.py`
`gemm`), at every distinct product of the 317M model at 512, 4,096 and
40,960 rows, the pi rollout's at 80 x 24 rows and the 5M rollout's at 512
rows, against the plain product within 1e-4 of |x| @ |W| (x's columns
past K NaN), N=8 against a one-env launch bit for bit, timed beside
`torch.matmul` on the same bf16 operands (cuBLAS; never called by the
port) and against its bound; its built kernels' SASS is counted
(cuobjdump: wgmma and TMA instructions, no mma.sync, no cp.async). Its
row kernel is held alone too (the row phase), through the library's
`tdm_wide_rows` (`ops/wide.py` `rows`): each template (LayerNorm + Mish,
with a head per env too; LayerNorm + SimNorm; the two-hot decode into G, q
and the value; the policy's action; the termination gate) at the 317M
model's widths on 512, 1,920, 4,096 and 40,960 rows, the narrow outputs as
8 partial rows of a split product, against `rows_plain` on the same rows
(bf16 outputs within one bf16 step, f32 outputs within 1e-4, the gate's
flags exactly), N=8 against one-env launches bit for bit, timed by CUDA
events and by its own device time against both bytes bounds (the
function's, and as launched with the partial rows), beside its plain
version and `torch.nn.functional.layer_norm` on the same f32 rows (a
yardstick that computes a part of the function); LayerNorm + SimNorm also
at SimNorm's groups 2, 4 and 16. Its cases and their check are
tests/row_cases.py, loaded by its path (the card tests share it). The
staging of each step (`stage_kernel`) is held alone through the library's
`tdm_wide_stage` (`ops/wide.py` `stage`) in each mode its launches take
(step 0 with the latent broadcast or one a row, a later step's actions,
and the folded step 0 that writes each env's latent once into zb) at 512,
4,096 and 40,960 rows against `stage_plain`, the z||a rows, zb and the
sampled actions bit for bit, N=8 against a one-env launch, and timed
against the bytes each mode's function must move. The folded first
layer's two kernels are held alone too (the fold phase, `fold_phase`;
with the staging under `--stage`): the u product (`fold_u_kernel`, the
envs' latents packed into shared wgmma tiles, K split into partial rows;
`ops/wide.py` `fold_u`) at 1, 8 and 80 envs against `fold_u_plain` within
1e-4 of |zb| @ |Wz|, timed beside `torch.mm(..., out_dtype=torch.float32)`
and `torch.matmul`; and the fused layer (`fold_hidden_kernel`: the rows'
action columns times the action block plus u's row of the env with its
task's bias row, LayerNorm + Mish, the bf16 row out; `fold_hidden`) at
512, 4,096 and 40,960 rows against `fold_hidden_plain`
within one bf16 step, timed beside the product + row kernel pair it
replaces on the same operands; N=8 against one-env launches bit for bit
in both.

The planner's kernels are also held on the task axis at mt30/model_size 48,
N = 30 tasks with mixed action dims (each env's task id picks its rows of
the prep's first-layer bias tables, its mask its action columns): the pi
rollout step by step on the kernel's own trajectory (PI_TOL; the
free-running error logged beside a CPU plain rollout's), the sampled value
step (VALUE_TOL, and exactly against the given-actions launch), the elite
step (ELITE_TOL), each N=30 launch against 30 one-task launches bit for
bit; the episodic value step under the gate rule at the default widths on
8 of the tasks, and exactly (with its statistics against the plain step,
and those of two plain versions, logged) at N=30.

The elite kernel is also held at its edges (S = 77, 2048; HA = 114; E = 1
and E = S; ties across the boundary, all tied, NaN, inf and +-3e38) and
the canary at sizes 1, 3 and 1027 and at a storage offset; the canary's and
`torch.add`'s device times are medians of interleaved profiler readings.
The value kernel's sampled mode (the planner's step: the CEM sampling
done where the kernel stages the actions) is held exactly, at one env, N=8
and episodic N=8: its actions against `sample_actions_plain`, its values
and flags against the given-actions launch on those actions. The three
planner kernels are also held at N=8 envs, against their plain versions
and, bit for bit, against 8 one-env launches, and the whole 8-env plan
against the plain loop. The agent's plan, one CUDA graph replay, is held
bit for bit against its eager body at n=1 and N=8, episodic too; each
path's launch counts show 1 + 2 x 6 planner launches and one graph replay
(or a capture's eager run) a plan. The value kernel's episodic branch is
held at one env and at N=8 under the gate rule (see VALUE_TOL), its N=8
launch against 8 one-env launches, and the episodic 8-env plan against
the plain loop. The row-tile kernels' plans (rows per block, shared
memory, ring stages, blocks per SM) and `-Xptxas -v` registers and spills
are printed, and the value kernel (both branches) and the pi rollout are
held against their plain versions at the widths of model_size 1, 5, 19 and
48 (one env), with the weight prep's packing timed. Then one update on the
card, a replay of its CUDA graph, is held against the same update on the
CPU (and one episodic update), and the training paths are timed
(update steps/s, env-steps/s, and the shares of an env step spent in
`act` and in `update`; plans/s of batched `act` at N = 1, 8, 16).
The update graph (the whole `_update` a replay) is held against its eager
body bit for bit, from the same state on the same batch and draws (every
info value, the parameters, target heads, both Adam states, the scale),
on the 5M state and episodic models, the walker pixel model, mt30 at
model_size 48 and mt80 at 317; `update_many(8)` against 8 eager steps;
`vec_step` against `act` + `update_many` at N=8, with 8 updates and with
none (actions, info, train state, warm starts); each update timed as the
eager body and as the graph (CUDA events, device busy and activities by
torch.profiler), its capture and its graph's pool; the N=8 loop with
`vec_step` (the trainer's), with `act` then `update_many`, and with the
host waiting for the updates. Every training path counts one update graph
replay an update, or a capture's eager warm-up; the vectorised paths
count their `vec_step` calls; `profile_dir` writes the one-env trainer's
trace of ten update replays. Phases
print one progress line each. It ends with the card's name and power
limit, one JSON line of per-kernel numbers (launches on each path, error
against the plain version, kernel, plain and library times at N=8 and
one env by CUDA events, each kernel's own device time by torch.profiler,
the card's least time for the same work), the prep refresh's host and
device time, and last
`{"ok": true, "device": {...}}`. Any failed phase exits non-zero before
that line; so does a machine without CUDA, or a directory without the
port's package. A watchdog turns a hang into an exit with a traceback.

`--compare DIR` times the tensor-core kernels (value, its episodic branch,
pi rollout, rollout; one env and N=8), the elite kernel (one env and N=8),
the canary, one update of the 5M model on a fixed batch and draws
(`update_5m`: the graph's replay where the version has one, its info and
parameters the outputs compared), the planner's value step (the sampled mode where the version
has it; also mt30's N=30 tasks at model_size 48, with the pi rollout, and
mt80's at model_size 317 at one env, N=8 and N=80 tasks, with the pi
rollout at one env and N=80) and
the agent's `plan_vec` (one env and N=8), and the walker pixel model's
`plan_vec` (one env and N=8) and one update (`update_pixels`, where both
versions have the update graph) of another version of the port,
unpacked in DIR, against this
tree's on the same inputs, in PAIRS (2 unless given) pairs of processes,
alternating as DIR, this, this, DIR, DIR, this, ..., and prints the median
and range of the pairs' ratios by CUDA events (plan_vec: by the host clock,
each call synchronised) and by own device time, and whether each kernel's
outputs are the same bits in both versions.
`--cycles` builds the value, elite and row kernels with their cycle
counters (TDM_CYCLES: csrc/mlp_rows.cuh, csrc/cem.cu, csrc/mlp_wide.cuh)
and prints where block 0 of each spends its cycles: the value and elite
kernels at the default model, the row kernel's LayerNorm templates at the
317M model's widths (waiting for a row, its statistics, its activation and
stores). `--rows` runs the build and the row phase alone.
"""

from __future__ import annotations

import faulthandler
import hashlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

WATCHDOG_S = 1000          # the whole run is expected well under 600 s
TRAIN_STEPS = 1200         # make_env sets seed_steps to 1000 on toy-reach
N_ENVS = 8                 # the vectorised path's env count
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12        # dense bf16 tensor-core peak
F32_FLOPS = 67e12          # f32 outside the tensor cores
SEED = 1
EP_TASK = 'toy-reach-episodic'
EP_ARGS = [f'task={EP_TASK}', 'episodic=true']
MAX_EP_LEN = 50            # toy-reach's time limit
EP_EVAL_EPISODES = 16      # episodic evaluate: the trained agent ends some early
SWEEP_SIZES = (1, 5, 19, 48)  # model sizes whose widths the kernels must run
# mt30's per-task dims, in the task set's order (config.TASK_SET['mt30']):
# the action and observation columns each task uses in the in-repo dataset
# datasets/mt30_medium (tests/test_torch_multitask.py holds them against
# chunk_0.npz); every task's episodes are 500 steps. The card has no
# dm_control, so the offline path sets them as the JAX suite does
# (tests/test_agent.py:182-183).
MT30_ACTION_DIMS = [6, 6, 6, 6, 2, 2, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 5, 4, 4, 6,
                    6, 6, 6, 6, 6, 4, 3, 3, 2, 1]
MT30_OBS_DIMS = [24, 24, 24, 17, 6, 6, 6, 3, 5, 5, 5, 5, 8, 9, 12, 12, 24, 15, 15,
                 24, 24, 17, 17, 17, 17, 15, 8, 8, 8, 3]
MT30_EPISODE_LENGTH = 500
# mt80 (config.TASK_SET['mt80']): mt30's 30 tasks, then the 50 Meta-World v2
# tasks, each with a 39-column observation and 4 action columns (the JAX
# adapter takes them from the env's spaces, tdmpc2_tpu/envs/metaworld.py:
# 26-27; its contract test's env has these, tests/test_env_adapters_mocked.py:
# 53-54) and 100-step episodes (metaworld.py EPISODE_STEPS). The mt80
# dataset's episodes are 100 steps for every task (the offline buffer's
# geometry, trainer/offline.py).
MW_OBS_DIM, MW_ACTION_DIM, MW_EPISODE_LENGTH = 39, 4, 100
MT80_ACTION_DIMS = MT30_ACTION_DIMS + [MW_ACTION_DIM] * 50
MT80_OBS_DIMS = MT30_OBS_DIMS + [MW_OBS_DIM] * 50
MT80_EPISODE_LENGTHS = [MT30_EPISODE_LENGTH] * 30 + [MW_EPISODE_LENGTH] * 50
MT80_DATA_EPISODE = 100
MT_CHUNKS, MT_EPISODES = 8, 150   # the in-repo mt30 set's size: 601,200 transitions
MT_STEPS = 128             # offline iterations at mt30/48 (16 x update_many(8))
MT_ACT_STEPS = 4           # lockstep act_tasks steps after the capturing one
MT_GATE_TASKS = [0, 4, 6, 12, 16, 17, 26, 29]  # action dims 6, 2, 1, 2, 5, 4, 3, 1
TOY_MT_STEPS = 64          # the toy multi-task path's iterations, then its eval
# The 317M model (mt80's published size) on the wide engine: offline
# training cut to 16 iterations (2 x update_many(8)) on 2 seeded chunks of
# 80 episodes (one of each task), then act_tasks over the 80 tasks for 3
# lockstep steps (the capturing one and 2 replays).
WIDE_SIZE = 317
WIDE_STEPS = 16
WIDE_CHUNKS, WIDE_EPISODES = 2, 80
WIDE_ACT_STEPS = 2
# the N=8 checks' tasks: action dims 6, 2, 1, 5, 3, 1, 4, 4 (two Meta-World)
WIDE_TASKS = [0, 4, 6, 16, 26, 29, 30, 79]
# The committed checkpoints the card reads (the copy of the tree sent to
# the card keeps these two of results/), both of the default 5M model:
# task -> (file, obs dim, action dim). The observations the planner sees on them were recorded from each
# trained agent on its dm_control task by tests/data/record_observations.py
# (the card has no dm_control).
CHECKPOINTS = {
    'acrobot-swingup': ('results/checkpoints/acrobot-swingup-s1.pkl.gz', 6, 1),
    'hopper-hop': ('results/checkpoints/full/hopper-hop-s1-r5.pkl.gz', 15, 4)}
OBS_FILE = 'tests/data/observations.npz'
BLOCKED = ('jax', 'jaxlib', 'optax', 'ml_dtypes')   # unimportable while reading them
FULL_ADAM_COUNT, FULL_SCALE = 1440484, 15.452264    # the hopper-hop train state's
SNAPSHOT_EPS = 3           # the train paths' replay snapshot: 3 x 50 = 150 steps
RESUME_STEPS = 1400        # the resumed toy-reach runs go on from TRAIN_STEPS
RESUME_REFILL = 200        # the snapshot's 150 steps of credit open it 50 steps in
TOY_MT_RESUME = 128        # the toy multi-task run resumed at TOY_MT_STEPS
# The pixel phases (obs=rgb, `pixel_phases`): the committed walker-walk pixel
# model (the default 5M config; a conv encoder of 32 channels on 64 x 64 x 9
# uint8 stacks, whose 4 x 4 x 32 output is the latent, 512; action 6) on the
# frames its trained agent saw (PIXEL_OBS_FILE, recorded by
# tests/data/record_observations.py: the card has no dm_control), and pixel
# agents of the same widths (action 2) trained from seeded weights on
# PixelObs(point mass), the port's toy env rendered at 64 x 64.
PIXEL_CKPT = ('walker-walk', 'results/checkpoints/walker-walk-rgb-s1.pkl.gz', 6)
PIXEL_OBS_FILE = 'tests/data/pixel_observations.npz'
PIXEL_SHAPE = (9, 64, 64)
PIXEL_STEPS, PIXEL_SEED_STEPS = 300, 100        # one env: the burst, then 200 planned
# num_envs=8: planned vector steps from env step 168; the first episodes end
# at 8 x 50 = 400, where the 160-update burst runs, then 8 updates a vector step
PIXEL_VEC_STEPS, PIXEL_VEC_SEED_STEPS = 480, 160
# The bf16 update (bf16_update=true, `bf16_twin_hold`): beside each of the
# five f32 update graphs held above, a bf16 agent on the same state and
# batch. JAX's contract for it (tests/test_bf16_update.py:52-71): each loss
# within 5% of max(|f32|, 1), the f32 master weights within 2e-3 of the f32
# update's.
BF16_LOSS_SHARE, BF16_PARAM_ATOL = 0.05, 2e-3
BF16_LOSSES = ('total_loss', 'consistency_loss', 'reward_loss', 'value_loss',
               'pi_loss', 'grad_norm')
# The seed fleet (`seeds=`, `fleet_phases`): K = 3 seeds of toy-reach at the
# default 5M config, 2 env copies a seed (and one), each seed's agent on its
# own plan and update graphs; the seed phase cut to 200 steps (the burst of
# 200 updates a seed there), evals (and checkpoints) at 0 and 400. The
# episodic fleet's seed phase ends at 20, before its slowest seed's first
# episode: the updates owed meanwhile join the burst.
FLEET_SEEDS = (3, 7, 11)
FLEET_ENVS = 2
FLEET_STEPS, FLEET_SEED_STEPS = 400, 200
FLEET_EP_STEPS, FLEET_EP_SEED_STEPS = 200, 20
FLEET_LOOP_STEPS = 20      # timed vector steps of the trained fleet

# Bands of kernel against plain version. Both round every dot input to
# bf16 and accumulate in f32; they differ in summation order and in the
# transcendental routines, and a last-bit difference ahead of a bf16
# rounding can move an activation by one bf16 step (2^-8 relative). The
# elite kernel has no dot and is held at 1e-4; sampling is exact.
# The gate rule (episodic value step, ops.value.gate_check): the
# termination gate is a step function of the logit, so a logit within a
# bf16 step of 0 can set the flag in one version and not the other, which
# zeroes that row's later reward and Q. So the value is held in VALUE_TOL
# on every row whose flags agree; a row whose flags differ is allowed only
# if the plain (f32-accumulated) logit is within GATE_NEAR of 0 at the
# first step where they differ, and such rows may be at most
# GATE_FLIP_SHARE of the rows. Any other row outside the band fails. At
# 4096 columns (model_size 317) two plain versions' logits, the CPU's and
# the card's, differ by up to ~0.2: there a flip is allowed where the plain
# |logit| is within that spread, measured on the same inputs.
VALUE_TOL = dict(rtol=2e-2, atol=2e-2)
GATE_NEAR = 1e-2
GATE_FLIP_SHARE = 0.01
# The episodic checks need the flag to split the rows: between 5% and 95%
# of them flagged at t=H.
FLAG_SPLIT = (0.05, 0.95)
PI_TOL = dict(rtol=2e-2, atol=2e-2)
# The fused kernel's sampled actions are sample_actions_plain's, bit for
# bit, and its values the given-actions launch's on them.
SAMPLE_TOL = dict(rtol=0.0, atol=0.0)
ELITE_TOL = dict(rtol=1e-4, atol=1e-4)
# The whole loop: an elite swap at the boundary (values within the value
# band of each other) moves the softmax-weighted mean by about 1/E of an
# action's range per swap, and later iterations sample around that mean.
CEM_TOL = dict(rtol=0.0, atol=0.15)
# Plain value estimate in f32 against the model heads in f32 (the JAX
# agent's plain branch): the same function in another factoring.
REF_TOL = dict(rtol=1e-4, atol=1e-4)
# The rollout kernel is the value kernel's row-block code without the
# policy and Q tail: its return G is held at the value band, and z_H (a
# SimNorm output in [0, 1]) at the same absolute band.
ROLLOUT_TOL = dict(rtol=2e-2, atol=2e-2)
# x + 1 in f32 is exact on both sides.
PROBE_TOL = dict(rtol=0.0, atol=0.0)
# The elite kernel's guarded values are a select of the input: exact.
GUARD_TOL = dict(rtol=0.0, atol=0.0)
# An N-env launch is held against N one-env launches with torch.equal:
# every env's blocks run the one-env code on the same data.
# One update on the card against the CPU, both f32 with TF32 off, on a
# state that has trained (so Adam's step is not a sign of a tiny
# gradient): sums in another order, 1e-4 as the CPU parity with JAX.
UPDATE_TOL = dict(rtol=1e-4, atol=1e-4)
# The conv encoder on the card (cuDNN, f32: TF32 off around the stack)
# against the CPU's, the same arithmetic in another order; ShiftAug is a
# gather, exact.
ENC_TOL = dict(rtol=1e-4, atol=1e-4)


# The elite kernel's edges: values in registers (S <= 512) or in shared
# memory (2048), actions staged in shared memory (HA = 6) or read from L2
# (HA = 114, A = 38), each at N=NE_EDGE envs.
ELITE_EDGE_SHAPES = ((77, 6, 2), (2048, 6, 2), (512, 114, 38))
NE_EDGE = 4
# Interleaved profiler readings of the canary's and torch.add's device time.
PROBE_READINGS = 7


def log(msg):
    print(msg, flush=True)


class ImportBlocker:
    """A meta path finder that makes the JAX stack (BLOCKED) unimportable
    in this process."""

    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError(f'{name} is blocked in chip_smoke')
        return None


def elite_edge_values(kind, n, S, g):
    """[n, S] values: distinct, integer ties across the elite boundary, all
    tied, or normal values with NaN, +-inf, +-3e38 and 3.3e38 among them."""
    import torch
    dev = g.device
    if kind == 'boundary ties':
        return torch.randint(-3, 4, (n, S), device=dev, generator=g).float()
    if kind == 'all tied':
        return torch.full((n, S), 0.25, device=dev)
    v = torch.randn(n, S, device=dev, generator=g)
    if kind == 'guarded':
        v[:, ::7] = float('nan')
        v[:, 1::9] = float('inf')
        v[:, 2::11] = -float('inf')
        v[:, 3::5] = 3.0e38
        v[:, 4::13] = -3.0e38
        v[:, 5::17] = 3.3e38
    return v


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f'[phase] {self.name} ...')
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        log(f'[phase] {self.name} {"ok" if exc is None else "FAILED"} '
            f'({dt:.1f} s)')
        return False


def nvidia_smi_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def hold(name, got, want, tol):
    """Raise unless |got - want| <= atol + rtol * |want| everywhere."""
    import torch
    err = max_err(got, want)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f'{name}: non-finite kernel output')
    bad = (got.float() - want.float()).abs() > (
        tol['atol'] + tol['rtol'] * want.float().abs())
    if bool(bad.any()):
        raise AssertionError(f'{name}: max |err| {err:.3g} outside {tol}')
    room = tol['atol'] + tol['rtol'] * want.float().abs()
    use = (f', {float(((got.float() - want.float()).abs() / room).max()):.3f} of the '
           'band at its tightest' if tol['atol'] > 0 else '')
    log(f'  {name}: max |err| {err:.3g} within {tol}{use}')
    return err


def time_ms(fn, reps):
    """Mean ms of fn() over `reps` runs on the current stream (CUDA events),
    after one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps):
    """Mean ms of fn() over `reps` runs by the host clock, synchronised at
    both ends, after one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def device_share(fn, reps, tries=8, keep=6):
    """(device-busy ms, device activities, top activities) per call of fn,
    from the kernel and copy events of a torch.profiler trace of `reps`
    calls; top is [(ms, count, name)] of the `keep` largest by time. A trace
    now and then comes back with its device events missing or cut short
    (after many traces in one process, every other one), so two traces
    are taken and the one with more device events is kept; every fn given
    here launches at least one device activity a call, so while the kept
    trace has fewer events than calls, more are taken, up to `tries` in
    all. (None, 0, []) when none had as many."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    dev = []
    for i in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        got = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(got) < reps:
            log(f'  (trace {i + 1} of {tries}: {len(got)} device events for {reps} '
                'calls, cut short)')
        if len(got) > len(dev):
            dev = got
        if i >= 1 and len(dev) >= reps:
            break
    if len(dev) < reps:
        return None, 0, []
    by_name = {}
    for e in dev:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3 / reps,
                           n + 1 / reps)
    top = sorted(((t, n, k) for k, (t, n) in by_name.items()), reverse=True)
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / reps
    return busy, len(dev) / reps, top[:keep]


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes, flops, peak_flops, f32_flops=0):
    """The card's least time for `n_bytes` moved and `flops` at
    `peak_flops` (plus `f32_flops` at the f32 rate)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / peak_flops + f32_flops / F32_FLOPS) * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


def perturbed(params, gen, scale=0.05):
    """Every leaf plus scale * N(0, 1), so the zero-init reward and Q heads
    give distinct sample values."""
    import torch
    if isinstance(params, dict):
        return {k: perturbed(v, gen, scale) for k, v in params.items()}
    if isinstance(params, tuple):
        return tuple(perturbed(v, gen, scale) for v in params)
    return params + scale * torch.randn(params.shape, generator=gen)


def split_termination(agent, g, rows=2048):
    """Spread and centre the agent's termination head in place: its last
    layer scaled so that the logit of one-step latents has std 4, and its
    bias moved so that about half of the H-step rollouts end flagged
    (rollouts of random SimNorm latents and actions drawn from `g`, not the
    rows that are then checked)."""
    import torch
    from tdmpc2_tpu_torch.models.layers import simnorm
    from tdmpc2_tpu_torch.ops import value
    cfg, dev = agent.cfg, agent.device
    z = simnorm(torch.randn(1, rows, cfg.latent_dim, device=dev, generator=g),
                cfg.simnorm_dim)
    acts = torch.rand(1, cfg.horizon, rows, cfg.action_dim, device=dev,
                      generator=g) * 2 - 1
    prep32 = value.prepare_value_params(agent.params, cfg, torch.float32)
    # a multi-task agent's discounts are per task: task 0's, with its bias rows
    discs = agent.discs[None] if agent.discs.dim() == 1 else agent.discs[:1]
    logits, _ = value.termination_trace_plain(prep32, z, acts, discs,
                                              cfg.simnorm_dim)
    last = agent.params['termination'][-1]
    scale = 4.0 / float(logits[:, 0].std())
    last['w'].mul_(scale)
    last['b'].mul_(scale).sub_(float((scale * logits).amax(1).median()))
    agent._prep = None


def sweep_scale(mlp_dim):
    """The width sweep's perturbation: 0.05 at the default mlp_dim 512,
    scaled by sqrt(512 / mlp_dim) so that every width's logits have the
    default model's spread. A fixed 0.05 grows the bins' logits with the
    square root of the width, and symexp amplifies each bf16 flip with
    them, until the band between two versions that round alike measures
    the weights' conditioning rather than the kernel."""
    return 0.05 * math.sqrt(512 / mlp_dim)


def flag_shares(term_at, horizon):
    """Share of the rows flagged by step t, for t = 1..H."""
    return [float(((term_at > 0) & (term_at <= t)).float().mean())
            for t in range(1, horizon + 1)]


def hold_gated(name, got, want, got_at, want_at, logits, tol):
    """Hold an episodic value step under the gate rule (VALUE_TOL's note);
    returns the max |err| over the rows whose flags agree."""
    from tdmpc2_tpu_torch.ops.value import gate_check
    flips, bad = gate_check(got, want, got_at, want_at, logits, **tol,
                            near=GATE_NEAR)
    agree = (got_at == want_at)[..., None]
    err = max_err(got[agree], want[agree])
    log(f'  {name}: max |err| {err:.3g} on the {int(agree.sum())} rows whose '
        f'flags agree (band {tol}); {flips} rows flip with |logit| < {GATE_NEAR}, '
        f'{bad} rows break the rule')
    if bad or flips > GATE_FLIP_SHARE * want.numel():
        raise AssertionError(f'{name}: {bad} rows outside the gate rule, {flips} '
                             f'flips (at most {GATE_FLIP_SHARE:.0%} allowed)')
    return err


def hold_sampled(label, args, heads, episodic=False, task=None, gate_rule=True):
    """The value kernel's sampled mode (value_sampled) on `args` against
    sample_actions_plain and the given-actions launch (value_estimate) on
    those actions, with the same mask on the terminal policy: actions,
    values and, when episodic, the termination flags, bit for bit. `task`
    (int32 [n] or None) is each env's task. Returns (the values' max |err|
    against the plain step (value_sampled_plain), held in VALUE_TOL or,
    episodic, under the gate rule, or only logged with gate_rule=False;
    the values; the actions)."""
    import torch
    from tdmpc2_tpu_torch.ops import value
    n, S = args[1].shape[:2]
    H = args[-1].shape[-1] - 1
    A = args[6].shape[-1]
    k_at = torch.empty(n, S, dtype=torch.int32, device=args[1].device)
    at, p_at = torch.empty_like(k_at), torch.empty_like(k_at)
    v, acts = value.value_sampled(*args, **heads, episodic=episodic, term_at=k_at,
                                  task=task)
    hold(f'sampled actions, {label}', acts, value.sample_actions_plain(*args[2:7]),
         SAMPLE_TOL)
    given = (args[0], args[1], acts.view(n, S, H, A).permute(0, 2, 1, 3), *args[7:])
    ref = value.value_estimate(*given, **heads, episodic=episodic, term_at=at,
                               task=task, amask=args[6])
    if not (torch.equal(v, ref) and torch.equal(k_at, at)):
        raise AssertionError(f'{label}: the sampled launch differs from the '
                             'given-actions launch on its actions')
    v_p, _ = value.value_sampled_plain(*args, **heads, episodic=episodic, term_at=p_at,
                                       task=task)
    if episodic and not gate_rule:
        logits, _ = value.termination_trace_plain(*given[:3], args[-1],
                                                  heads['simnorm_dim'], task=task)
        flips, bad = value.gate_check(v, v_p, k_at, p_at, logits, **VALUE_TOL,
                                      near=GATE_NEAR)
        err = max_err(v[(k_at == p_at)[..., None]], v_p[(k_at == p_at)[..., None]])
        log(f'  value sampled episodic, {label}, against the plain step (not held '
            f'here): max |err| {err:.3g} where the flags agree, {flips} flips with '
            f'|logit| < {GATE_NEAR}, {bad} rows outside the gate rule, of {v.numel()}')
    elif episodic:
        logits, _ = value.termination_trace_plain(*given[:3], args[-1],
                                                  heads['simnorm_dim'], task=task)
        err = hold_gated(f'value sampled episodic, {label}', v, v_p, k_at, p_at,
                         logits, VALUE_TOL)
    else:
        err = hold(f'value sampled, {label}', v, v_p, VALUE_TOL)
    log(f'  {label}: actions equal sample_actions_plain\'s and values (and flags) '
        'the given-actions launch\'s on them, bit for bit')
    return err, v, acts


def pi_rollout_forced(prep, z0, pi_eps, acts, heads, task=None, amask=None):
    """The plain pi rollout with each step's latent advanced on the kernel's
    actions `acts` [N, n_pi, H*A]: each step's plain action computed from
    the kernel's own trajectory. A free-running comparison carries a bf16
    flip of one step into the next step's latent, where the policy's
    exp(log_std) (up to e^2) amplifies it; this one holds every step's
    arithmetic on its own."""
    import torch
    from tdmpc2_tpu_torch.ops import value
    A = prep['pWm'].shape[1]
    z = z0.float().expand(*pi_eps.shape[:-1], z0.shape[-1])
    m = 1.0 if amask is None else value.mask_rows(amask, A)
    out = []
    for t in range(pi_eps.shape[-1] // A):
        sl = slice(t * A, (t + 1) * A)
        mean, ls = value.pi_head_plain(prep, z, heads['log_std_min'],
                                       heads['log_std_dif'], task)
        out.append(value.pi_action_plain(mean, ls, pi_eps[..., sl], m))
        z = value.dynamics_plain(prep, z, acts[..., sl], heads['simnorm_dim'], task)
    return torch.cat(out, -1)


def hold_pi_orders(name, got, prep, z0, pi_eps, heads):
    """The pi rollout `got` [N, n_pi, H*A] held step by step in PI_TOL
    against the plain rollout on its own trajectory (`pi_rollout_forced`)
    in three orders of the f32 sums: on the card over the N envs at once,
    on the card one env a call, and on the CPU; each env against the order
    nearest to it. Where a policy sits at its log-std cap (the trained
    walker pixel model: means up to ~17), an f32 sum that lands within its
    last bit of a bf16 midpoint rounds a pi hidden unit up in one order and
    down in another, and that one flip moves a mean by up to ~0.1, an
    action by up to ~0.04: two plain versions then differ by as much as
    the kernel does from either (PERF.md §6). Returns the max |err|
    against the nearest order."""
    import torch
    N = got.shape[0]
    cpu = {k: x.cpu() for k, x in prep.items()}
    orders = {
        f'the card over {N} envs': pi_rollout_forced(prep, z0, pi_eps, got, heads),
        'the card one env a call': torch.cat([
            pi_rollout_forced(prep, z0[i:i + 1], pi_eps[i:i + 1], got[i:i + 1], heads)
            for i in range(N)]),
        'the CPU': pi_rollout_forced(cpu, z0.cpu(), pi_eps.cpu(), got.cpu(),
                                     heads).to(got.device)}
    use = torch.stack([((got - w).abs() / (PI_TOL['atol'] + PI_TOL['rtol'] * w.abs()))
                       .reshape(N, -1).amax(1) for w in orders.values()])   # [order, env]
    near = use.argmin(0)
    want = torch.stack(list(orders.values()))[near, torch.arange(N, device=got.device)]
    err = max_err(got, want)
    if not bool(torch.isfinite(got).all()) or bool((use.amin(0) > 1).any()):
        raise AssertionError(f'{name}: max |err| {err:.3g} outside {PI_TOL} of every order '
                             'of the plain rollout')
    each = '; '.join(f'{k} {max_err(got, w):.3g} ({int((use[i] > 1).sum())} envs outside)'
                     for i, (k, w) in enumerate(orders.items()))
    log(f'  {name}, step by step: max |err| {err:.3g} within {PI_TOL} of the nearest order '
        f'of the plain rollout, {float(use.amin(0).max()):.3f} of the band at its tightest '
        f'(nearest: {[int((near == i).sum()) for i in range(len(orders))]} envs of '
        f'{list(orders)}); against each order: {each}')
    return err


def hold_plan_graph(label, ag, n, eval_mode, seed, obs=None):
    """One plan of `ag` through its CUDA graph (captured by a first plan of
    (n, eval_mode) if need be) against the eager body on the same draws
    and warm starts, with mixed episode starts and a negative warm start:
    actions, means, every row of prev_mean and its sign bits equal; the
    replay counted once, with the eager body's launches. `obs` [n, obs]
    (host) replaces the observations drawn from `seed`."""
    import numpy as np
    import torch
    from tdmpc2_tpu_torch.tdmpc2 import PLAN_WRAPPERS
    from tdmpc2_tpu_torch.utils.cuda_graph import Graph
    if obs is None:
        obs = np.random.default_rng(seed).normal(
            size=(n, ag.cfg.obs_shape['state'][0])).astype(np.float32)
    obs = torch.from_numpy(obs)
    t0 = np.arange(n) % 3 == 0
    ag.plan_vec(obs, t0, eval_mode=eval_mode)
    pm = ag.prev_mean.clone()
    pm[0, :, 0] = -0.5
    ag.prev_mean = pm
    ag.generator.manual_seed(seed)
    counts = [w.launches for w in PLAN_WRAPPERS]
    replays = Graph.replays.get('plan', 0)
    a, m = (x.clone() for x in ag.plan_vec(obs, t0, eval_mode=eval_mode))
    launched = [w.launches - c for w, c in zip(PLAN_WRAPPERS, counts)]
    pm_graph = ag.prev_mean.clone()
    ag.prev_mean = pm
    ag.generator.manual_seed(seed)
    a_e, m_e = ag._plan_body(ag.prep, obs.to(ag.device),
                             torch.tensor(t0, device=ag.device), ag.draw_noise(n),
                             eval_mode)
    I = ag.iterations
    if Graph.replays['plan'] != replays + 1 or launched != [1, I, I]:
        raise AssertionError(f'plan graph {label}: {Graph.replays["plan"] - replays} '
                             f'replays, launches {launched}')
    if not (torch.equal(a, a_e) and torch.equal(m, m_e)
            and torch.equal(pm_graph, ag.prev_mean)
            and torch.equal(torch.signbit(pm_graph), torch.signbit(ag.prev_mean))):
        raise AssertionError(f'plan graph {label}: the replay differs from the eager '
                             f'body (max |err| actions {max_err(a, a_e):.3g}, means '
                             f'{max_err(m, m_e):.3g})')
    log(f'  {label}, eval_mode={eval_mode}: one replay ({launched} launches of '
        f'pi_rollout, value_sampled, elite_moments) equals the eager body bit for bit')


def elite_inputs(ag, n, g):
    """The elite step's operands at `ag`'s widths for n envs, drawn from the
    card generator g: the value kernel's values of uniform actions, the
    actions, the action mask; and the step's keywords."""
    import torch
    from tdmpc2_tpu_torch.models.layers import simnorm
    from tdmpc2_tpu_torch.ops import value
    cfg, dev = ag.cfg, torch.device('cuda')
    H, S, A, L = cfg.horizon, cfg.num_samples, cfg.action_dim, cfg.latent_dim
    acts = torch.rand(n, S, H * A, device=dev, generator=g) * 2 - 1
    z = simnorm(torch.randn(n, S, L, device=dev, generator=g), cfg.simnorm_dim)
    v = value.value_estimate(
        ag.prep, z, acts.view(n, S, H, A).permute(0, 2, 1, 3),
        torch.randn(n, S, A, device=dev, generator=g),
        torch.tensor([[1, 3]] * n, dtype=torch.int32, device=dev), ag.discs.expand(n, -1),
        log_std_min=ag.model.log_std_min, log_std_dif=ag.model.log_std_dif,
        simnorm_dim=cfg.simnorm_dim)
    kw = dict(num_elites=cfg.num_elites, temperature=cfg.temperature,
              min_std=cfg.min_std, max_std=cfg.max_std)
    return (v, acts, ag.amask), kw


# The outputs `--time-kernels ROOT OUT` keeps for `--compare`'s differences:
# the 317 value step (folded) and its unfolded launch, the pi rollout (no
# fold), and one seeded act_tasks step over the 80 tasks.
KEPT_OUTPUTS = ('value_step_317_n1', f'value_step_317_n{N_ENVS}', 'value_step_317_n80',
                f'value_317_rows_n{N_ENVS}', 'pi_rollout_317_n80', 'act_tasks_317_n80')


def time_kernels(root, out_path=None) -> int:
    """`--time-kernels ROOT [OUT]`: time the row-tile kernels, the rollout, the
    elite kernel, the canary, the planner's value step and `plan_vec` of the
    port at ROOT (this tree, or an older one unpacked elsewhere) on the main
    paths' inputs, on mt30's at model_size 48 (N = 30 tasks) and on mt80's
    at model_size 317 (one env, N = 8 and 80 tasks, and `act_tasks` over
    the 80 tasks), made from SEED, through the entry points that every
    version has; prints one JSON line {name: [ms by CUDA events (plan_vec,
    act_tasks: by the host clock, each call synchronised), own device ms by
    torch.profiler, a digest of the kernel's output bits (None for
    plan_vec and act_tasks)]}; with OUT, also torch.saves the outputs of
    KEPT_OUTPUTS there (act_tasks': the actions of one step from a seeded
    generator)."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from tdmpc2_tpu_torch import __file__ as pkg_file
    from tdmpc2_tpu_torch.config import load_cfg
    from tdmpc2_tpu_torch.envs import make_env
    from tdmpc2_tpu_torch.models.layers import simnorm
    from tdmpc2_tpu_torch.ops import cem, probe, rollout, value
    from tdmpc2_tpu_torch.tdmpc2 import TDMPC2
    from tdmpc2_tpu_torch.utils import tree
    if not pkg_file.startswith(os.path.abspath(root)):
        raise AssertionError(f'imported {pkg_file}, not the tree at {root}')
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(SEED)
    g = torch.Generator(device=dev).manual_seed(SEED)
    agents = {}
    for label, args in (('', ['task=toy-reach']), ('episodic', EP_ARGS)):
        c = load_cfg(overrides=args + [f'seed={SEED}'])
        make_env(c)
        ag = TDMPC2(c, device='cuda')
        ag.load_params(perturbed(ag.model.init(gen), gen))
        if label:
            split_termination(ag, g)
        agents[label] = ag
    ag, cfg = agents[''], agents[''].cfg
    H, S, A, L, n_pi = (cfg.horizon, cfg.num_samples, cfg.action_dim,
                        cfg.latent_dim, cfg.num_pi_trajs)
    heads = dict(log_std_min=ag.model.log_std_min, log_std_dif=ag.model.log_std_dif,
                 simnorm_dim=cfg.simnorm_dim)

    def value_args(a, n):
        return (a.prep, simnorm(torch.randn(n, S, L, device=dev, generator=g),
                                cfg.simnorm_dim),
                torch.rand(n, H, S, A, device=dev, generator=g) * 2 - 1,
                torch.randn(n, S, A, device=dev, generator=g),
                torch.stack([torch.randperm(cfg.num_q, device=dev, generator=g)[:2]
                             for _ in range(n)]).to(torch.int32),
                a.discs.expand(n, -1))
    obs = torch.randn(N_ENVS, cfg.obs_shape['state'][0], device=dev, generator=g)
    z_n = ag.model.encode(ag.params, obs)[:, None]
    pi_eps = ag.draw_noise(N_ENVS).pi_eps[:, :n_pi]
    prep_r = rollout.prepare_rollout_params(ag.params['dynamics'], ag.params['reward'],
                                            L, cfg.vmin, cfg.vmax)
    r_args = (prep_r, value_args(ag, 1)[1][0], value_args(ag, 1)[2][0])
    ep = dict(heads, episodic=True)
    calls = {
        'value_n1': (value.value_estimate, value_args(ag, 1), heads),
        f'value_n{N_ENVS}': (value.value_estimate, value_args(ag, N_ENVS), heads),
        'value_episodic_n1': (value.value_estimate, value_args(agents['episodic'], 1), ep),
        f'value_episodic_n{N_ENVS}': (value.value_estimate,
                                      value_args(agents['episodic'], N_ENVS), ep),
        'pi_rollout_n1': (cem.pi_rollout, (ag.prep, z_n[:1], pi_eps[:1]), heads),
        f'pi_rollout_n{N_ENVS}': (cem.pi_rollout, (ag.prep, z_n, pi_eps), heads),
        'rollout': (rollout.rollout_prepared, r_args,
                    dict(horizon=H, discount=ag.discount, simnorm_dim=cfg.simnorm_dim)),
    }
    for n in (1, N_ENVS):
        e_args, e_kw = elite_inputs(ag, n, g)
        calls[f'elite_n{n}'] = (cem.elite_moments, e_args, e_kw)
    calls['probe'] = (probe.add_one, (torch.randn(probe.SHAPE, device=dev, generator=g),),
                      {})
    # The planner's value step on the same actions: a tree with the sampled
    # mode launches it (sampling included); an older one the value kernel on
    # actions sampled before (its sample kernel not timed).
    noise = ag.draw_noise(N_ENVS)
    mean = torch.rand(N_ENVS, H * A, device=dev, generator=g) * 0.4 - 0.2
    std = torch.rand(N_ENVS, H * A, device=dev, generator=g) * 1.9 + 0.1
    pa = cem.pi_rollout(ag.prep, z_n, noise.pi_eps[:, :n_pi], **heads)
    step = (ag.prep, z_n.expand(N_ENVS, S, L), mean, std, noise.sample[:, 0], pa, ag.amask,
            noise.eps[:, 0], noise.qidx[:, 0], ag.discs.expand(N_ENVS, -1))
    for n in (1, N_ENVS):
        args = tuple(a if a is ag.prep or a is ag.amask else a[:n] for a in step)
        if hasattr(value, 'value_sampled'):
            calls[f'value_step_n{n}'] = (value.value_sampled, args, heads)
        else:
            acts = cem.sample_actions_plain(*args[2:7])
            calls[f'value_step_n{n}'] = (
                value.value_estimate, (args[0], args[1], acts.view(n, S, H, A).permute(
                    0, 2, 1, 3), *args[7:]), heads)
    # the agent's whole plan (a graph replay where the tree has one), in eval
    # mode, each call waited for as act waits for it: its call time by the
    # host clock (back to back, the plan is device-bound on either tree)
    c8 = load_cfg(overrides=['task=toy-reach', f'seed={SEED}', f'num_envs={N_ENVS}'])
    make_env(c8)
    ag8 = TDMPC2(c8, device='cuda')
    ag8.load_params(tree.map(torch.clone, ag.params))
    obs8 = torch.randn(N_ENVS, c8.obs_shape['state'][0], device=dev, generator=g)
    for n in (1, N_ENVS):
        t0 = np.zeros(n, bool)
        calls[f'plan_vec_n{n}'] = (ag8.plan_vec, (obs8[:n], t0), dict(eval_mode=True))
    calls['plan_vec_episodic_n1'] = (agents['episodic'].plan_vec, (obs8[:1], np.zeros(1, bool)),
                                     dict(eval_mode=True))
    # mt30 at model_size 48, N = 30 tasks: the planner's value step and pi rollout
    mcfg = mt30_cfg(load_cfg)
    mag = TDMPC2(mcfg, device='cuda')
    mgen = torch.Generator().manual_seed(SEED + 48)
    mag.load_params(perturbed(mag.model.init(mgen), mgen, sweep_scale(mcfg.mlp_dim)))
    NT = len(MT30_ACTION_DIMS)
    tt = torch.arange(NT, dtype=torch.int32, device=dev)
    m_amask = mag.amask[tt.long()].contiguous()
    m_obs = torch.randn(NT, mcfg.obs_shape['state'][0], device=dev, generator=g)
    m_z = mag.model.encode(mag.params, m_obs, tt.long())[:, None]
    m_noise = mag.draw_noise(NT)
    m_heads = dict(heads, task=tt)
    m_pi = (mag.prep, m_z, m_noise.pi_eps[:, :mcfg.num_pi_trajs])
    m_pa = cem.pi_rollout(*m_pi, **m_heads, amask=m_amask)
    m_HA = mcfg.horizon * mcfg.action_dim
    calls[f'pi_rollout_mt30_n{NT}'] = (cem.pi_rollout, m_pi, dict(m_heads, amask=m_amask))
    calls[f'value_step_mt30_n{NT}'] = (value.value_sampled, (
        mag.prep, m_z.expand(NT, mcfg.num_samples, mcfg.latent_dim),
        torch.rand(NT, m_HA, device=dev, generator=g) * 1.6 - 0.8,
        torch.rand(NT, m_HA, device=dev, generator=g) * 1.9 + 0.1, m_noise.sample[:, 0],
        m_pa, m_amask, m_noise.eps[:, 0], m_noise.qidx[:, 0], mag.discs[tt.long()]),
        m_heads)
    del mag
    # mt80 at model_size 317 (the wide engine): the planner's value step at
    # one env, N = 8 and N = 80 tasks, and the pi rollout at one env and N = 80
    wcfg = mt30_cfg(load_cfg, model_size=WIDE_SIZE, task='mt80')
    wag = TDMPC2(wcfg, device='cuda')
    wgen = torch.Generator().manual_seed(SEED + WIDE_SIZE)
    wag.load_params(perturbed(wag.model.init(wgen), wgen, sweep_scale(wcfg.mlp_dim)))
    WT = len(MT80_ACTION_DIMS)
    wt = torch.arange(WT, dtype=torch.int32, device=dev)
    w_amask = wag.amask[wt.long()].contiguous()
    w_z = wag.model.encode(wag.params, torch.randn(
        WT, wcfg.obs_shape['state'][0], device=dev, generator=g), wt.long())[:, None]
    w_noise = wag.draw_noise(WT)
    w_HA, w_pi = wcfg.horizon * wcfg.action_dim, wcfg.num_pi_trajs
    w_pa = cem.pi_rollout(wag.prep, w_z, w_noise.pi_eps[:, :w_pi], **heads, task=wt,
                          amask=w_amask)
    w_step = (wag.prep, w_z.expand(WT, wcfg.num_samples, wcfg.latent_dim),
              torch.rand(WT, w_HA, device=dev, generator=g) * 1.6 - 0.8,
              torch.rand(WT, w_HA, device=dev, generator=g) * 1.9 + 0.1,
              w_noise.sample[:, 0], w_pa, w_amask, w_noise.eps[:, 0], w_noise.qidx[:, 0],
              wag.discs[wt.long()])
    for n in (1, N_ENVS, WT):
        calls[f'value_step_317_n{n}'] = (
            value.value_sampled, tuple(a if a is wag.prep else a[:n] for a in w_step),
            dict(heads, task=wt[:n]))
    # the value step unfolded (a latent a row): its products and row
    # kernels are the ones the fold leaves as they were
    w_L, w_S, w_H, w_A = (wcfg.latent_dim, wcfg.num_samples, wcfg.horizon,
                          wcfg.action_dim)
    calls[f'value_317_rows_n{N_ENVS}'] = (value.value_estimate, (
        wag.prep, simnorm(torch.randn(N_ENVS, w_S, w_L, device=dev, generator=g),
                          wcfg.simnorm_dim),
        torch.rand(N_ENVS, w_H, w_S, w_A, device=dev, generator=g) * 2 - 1,
        torch.randn(N_ENVS, w_S, w_A, device=dev, generator=g), w_noise.qidx[:N_ENVS, 0],
        wag.discs[wt[:N_ENVS].long()]), dict(heads, task=wt[:N_ENVS]))
    for n in (1, WT):
        calls[f'pi_rollout_317_n{n}'] = (
            cem.pi_rollout, (wag.prep, w_z[:n], w_noise.pi_eps[:n, :w_pi]),
            dict(heads, task=wt[:n], amask=w_amask[:n]))
    # act_tasks over the 80 tasks: one lockstep step, a graph replay after
    # the capturing first call (its call time by the host clock, each call
    # synchronised, as for plan_vec)
    w_obs = torch.randn(WT, wcfg.obs_shape['state'][0], device=dev, generator=g).cpu().numpy()
    tasks = np.arange(WT)
    _, w_pm = wag.act_tasks(w_obs, np.zeros((WT, wcfg.horizon, wcfg.action_dim), np.float32),
                            True, tasks)
    w_pm0 = w_pm.clone()
    calls[f'act_tasks_317_n{WT}'] = (wag.act_tasks, (w_obs, w_pm, False, tasks), {})
    # one update of the 5M model on a fixed batch and draws, from the same
    # state: a replay of the update graph where the tree has one (`_step`;
    # captured first on a copy of the state), else the eager body; its
    # outputs are the info values and the parameters after it
    T, B = cfg.horizon, cfg.batch_size
    u_batch = (torch.randn(T + 1, B, cfg.obs_shape['state'][0], device=dev, generator=g),
               torch.rand(T, B, A, device=dev, generator=g) * 2 - 1,
               torch.rand(T, B, 1, device=dev, generator=g),
               torch.zeros(T, B, 1, device=dev))
    u_noise = ag.draw_update_noise()
    step = getattr(ag, '_step', None)
    if step is not None:
        with_update_graph(ag, u_batch)

    def one_update():
        info = (step(u_batch, u_noise) if step is not None
                else ag._update(ag.state, *u_batch, u_noise))
        return tuple(info[k] for k in sorted(info)) + tuple(tree.leaves(ag.state.params))
    calls['update_5m'] = (one_update, (), {})
    # the walker pixel model (random weights from SEED): its plan at one env
    # and N=8 (timed as plan_vec above) and one update on random frames,
    # batch 256, fixed draws (a graph replay where the tree has one)
    p_task, _, p_act = PIXEL_CKPT
    pcfg = pixel_cfg(f'num_envs={N_ENVS}', action_dim=p_act, task=p_task)
    pag = TDMPC2(pcfg, device='cuda')
    pag.load_params(perturbed(pag.model.init(gen), gen))
    p_obs = torch.randint(0, 256, (N_ENVS, *PIXEL_SHAPE), device=dev, generator=g,
                          dtype=torch.uint8)
    for n in (1, N_ENVS):
        calls[f'plan_vec_pixels_n{n}'] = (pag.plan_vec, (p_obs[:n], np.zeros(n, bool)),
                                          dict(eval_mode=True))
    T, B, pA = pcfg.horizon, pcfg.batch_size, pcfg.action_dim
    p_batch = (torch.randint(0, 256, (T + 1, B, *PIXEL_SHAPE), device=dev, generator=g,
                             dtype=torch.uint8),
               torch.rand(T, B, pA, device=dev, generator=g) * 2 - 1,
               torch.rand(T, B, 1, device=dev, generator=g),
               torch.zeros(T, B, 1, device=dev))
    p_noise = pag.draw_update_noise()

    def pixel_update():
        info = pag._step(p_batch, p_noise)
        return tuple(info[k] for k in sorted(info)) + tuple(tree.leaves(pag.state.params))
    if step is not None:
        with_update_graph(pag, p_batch)
        calls['update_pixels'] = (pixel_update, (), {})

    def digest(x):
        h = hashlib.sha256()
        for t in as_tuple(x):
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    out, kept = {}, {}
    for name, (fn, args, kw) in calls.items():
        # a kernel's output bits on these inputs (a plan's depend on its draws)
        whole = name.startswith(('plan_vec', 'act_tasks'))
        dg = None if whole else digest(fn(*args, **kw))
        if out_path is not None and name in KEPT_OUTPUTS:
            if whole:
                wag.generator.manual_seed(SEED + 80)
                kept[name] = (torch.as_tensor(wag.act_tasks(w_obs, w_pm0.clone(), False,
                                                            tasks)[0]),)
            else:
                kept[name] = tuple(t.detach().cpu() for t in as_tuple(fn(*args, **kw)))
        reps = 10 if '317_n80' in name else 50
        if whole:
            ms = host_ms(lambda: (fn(*args, **kw), torch.cuda.synchronize()), reps)
        else:
            ms = time_ms(lambda: fn(*args, **kw), reps)
        out[name] = [ms, device_share(lambda: fn(*args, **kw), reps // 5 * 2)[0], dg]
    if out_path is not None:
        torch.save(kept, out_path)
    print(json.dumps(out), flush=True)
    return 0


def cycles() -> int:
    """`--cycles`: where one block of the value kernel and of the elite
    kernel spends its cycles, at the default 5M model (one env and N=8,
    S=512; the value kernel non-episodic and episodic), and the wide row
    kernel's LayerNorm templates at the 317M model's widths (512 and 40,960
    rows; at 40,960 also the launch with every row read from row 0, and
    PyTorch's cast of the same rows to bf16, the same bytes moved) and the
    fused folded layer (512 and 40,960 rows): the
    kernels built with their TDM_CYCLES counters
    (csrc/mlp_rows.cuh, csrc/cem.cu, csrc/mlp_wide.cuh; block 0, thread 0),
    driven through `value_estimate`, `elite_moments` and `ops/wide.py`
    `rows`."""
    import ctypes
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    from tdmpc2_tpu_torch.config import load_cfg
    from tdmpc2_tpu_torch.envs import make_env
    from tdmpc2_tpu_torch.models.layers import simnorm
    from tdmpc2_tpu_torch.ops import _build, cem, value
    from tdmpc2_tpu_torch.tdmpc2 import TDMPC2
    flags = ('TDM_CYCLES',)
    library = _build.library
    _build.library = lambda name, defines=(): library(
        name, flags if name in ('value', 'cem', 'rollout') else defines)
    lib = _build.library('value')
    lib.tdm_cycles.argtypes = (ctypes.POINTER(ctypes.c_ulonglong),)
    lib.tdm_cycles.restype = ctypes.c_int
    elib = _build.library('cem')
    elib.tdm_elite_cycles.argtypes = (ctypes.POINTER(ctypes.c_ulonglong),)
    elib.tdm_elite_cycles.restype = ctypes.c_int
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(SEED)
    g = torch.Generator(device=dev).manual_seed(SEED)
    names = ('kernel', 'waiting for weight stages', 'wide K loops (waits included)',
             'wide epilogues', 'LayerNorm row statistics')
    agents = []
    for label, args in (('', ['task=toy-reach']), ('episodic ', EP_ARGS)):
        cfg = load_cfg(overrides=args + [f'seed={SEED}'])
        make_env(cfg)
        ag = TDMPC2(cfg, device='cuda')
        ag.load_params(perturbed(ag.model.init(gen), gen))
        agents.append(ag)
        heads = dict(log_std_min=ag.model.log_std_min,
                     log_std_dif=ag.model.log_std_dif, simnorm_dim=cfg.simnorm_dim,
                     episodic=bool(label))
        H, S, A, L = cfg.horizon, cfg.num_samples, cfg.action_dim, cfg.latent_dim
        for n in (1, N_ENVS):
            v_args = (ag.prep, simnorm(torch.randn(n, S, L, device=dev, generator=g),
                                       cfg.simnorm_dim),
                      torch.rand(n, H, S, A, device=dev, generator=g) * 2 - 1,
                      torch.randn(n, S, A, device=dev, generator=g),
                      torch.tensor([[1, 3]] * n, dtype=torch.int32, device=dev),
                      ag.discs.expand(n, -1))
            value.value_estimate(*v_args, **heads)
            torch.cuda.synchronize()
            out = (ctypes.c_ulonglong * 5)()
            _build.check(lib, lib.tdm_cycles(out), 'cycle counters')
            value.value_estimate(*v_args, **heads)
            torch.cuda.synchronize()
            _build.check(lib, lib.tdm_cycles(out), 'cycle counters')
            ms = time_ms(lambda: value.value_estimate(*v_args, **heads), 20)
            log(f'[cycles] value kernel, {label}N={n}: {ms:.4f} ms a launch with the '
                'counters (CUDA events); block 0: ' + ', '.join(
                    f'{k} {out[i]} ({100 * out[i] / out[0]:.1f}%)'
                    for i, k in enumerate(names)))
    enames = ('kernel', 'guard and extrema', 'selection and bisection',
              'boundary counts and score', 'moments')
    for n in (1, N_ENVS):
        e_args, e_kw = elite_inputs(agents[0], n, g)
        out = (ctypes.c_ulonglong * 5)()
        for _ in range(2):      # the second launch's counts are kept
            cem.elite_moments(*e_args, **e_kw)
            torch.cuda.synchronize()
            _build.check(elib, elib.tdm_elite_cycles(out), 'cycle counters')
        ms = time_ms(lambda: cem.elite_moments(*e_args, **e_kw), 50)
        log(f'[cycles] elite kernel, N={n}, S={e_args[1].shape[1]}, '
            f'HA={e_args[1].shape[2]}: {ms:.4f} ms a call with the counters (CUDA '
            'events); block 0: ' + ', '.join(
                f'{k} {out[i]} ({100 * out[i] / out[0]:.1f}%)'
                for i, k in enumerate(enames)))
    # the wide engine's row kernel (ops/wide.py rows) at the 317M model's widths
    from tdmpc2_tpu_torch.ops import wide
    rc = row_cases()
    rlib = _build.library('rollout')
    rlib.tdm_row_cycles.argtypes = (ctypes.POINTER(ctypes.c_ulonglong),)
    rlib.tdm_row_cycles.restype = ctypes.c_int
    rnames = ('kernel', 'waiting for a row', 'row statistics', 'activation and stores')
    for R, S in (ROW_ROWS[0], ROW_ROWS[-1]):
        for label, mode, heads in rc.ROW_CASES[:3]:
            kw, per_row, per_env = rc.row_operands(mode, R, S, g, WIDE_DIMS, heads)
            y = kw.pop('y')
            out = (ctypes.c_ulonglong * 5)()
            for _ in range(2):      # the second launch's counts are kept
                wide.rows(mode, y, WIDE_DIMS, S, **kw)
                torch.cuda.synchronize()
                _build.check(rlib, rlib.tdm_row_cycles(out), 'cycle counters')
            ms = time_ms(lambda: wide.rows(mode, y, WIDE_DIMS, S, **kw), 10)
            log(f'[cycles] row kernel, {label}, {R} rows: {ms:.4f} ms a launch with the '
                f'counters (CUDA events); block 0, thread 0, over {out[4]} row(s): '
                + ', '.join(f'{k} {out[i]} ({100 * out[i] / max(out[0], 1):.1f}%)'
                            for i, k in enumerate(rnames)))
            if mode == 'hidden' and not heads and R == ROW_ROWS[-1][0]:
                # what bounds it: the same launch with every row read from
                # row 0 (a zero row stride: from L2, not device memory), and
                # one PyTorch call that moves the same bytes (the f32 rows
                # to bf16)
                y0 = y[:1].expand(R, -1)
                yc = y[:, :WIDE_DIMS[1]].contiguous()
                log(f'[cycles] row kernel, {label}, {R} rows, every row read from row 0: '
                    f'{time_ms(lambda: wide.rows(mode, y0, WIDE_DIMS, S, **kw), 10):.4f} ms '
                    'a launch with the counters; torch y.to(torch.bfloat16) on the same f32 '
                    f'rows: {time_ms(lambda: yc.to(torch.bfloat16), 10):.4f} ms (CUDA events)')
                del yc, y0
            del kw, y
    # the fused folded layer (ops/wide.py fold_hidden) on one env's and 80
    # envs' rows, the counters in the same slots a row step (one or two rows)
    fnames = ('kernel', 'the action product', 'row statistics', 'activation and stores')
    Lp, Mp = -(-WIDE_DIMS[0] // 16) * 16, -(-WIDE_DIMS[1] // 16) * 16
    for n in (1, FOLD_HEADLINE):
        wT, zb, x, b0, task, gain, beta = fold_operands(n, 512, g)
        u, _ = wide.fold_u(zb, wT[:, :Lp], WIDE_DIMS)
        dst = torch.empty(n * 512, Mp, device=dev, dtype=torch.bfloat16)

        def fused():
            wide.fold_hidden(x[:, Lp:], wT[:, Lp:], u, b0, gain, beta, WIDE_DIMS, 512,
                             task=task, dst=dst)
        out = (ctypes.c_ulonglong * 5)()
        for _ in range(2):      # the second launch's counts are kept
            fused()
            torch.cuda.synchronize()
            _build.check(rlib, rlib.tdm_row_cycles(out), 'cycle counters')
        log(f'[cycles] fused folded layer, {n * 512} rows: {time_ms(fused, 10):.4f} ms a '
            f'launch with the counters (CUDA events); block 0, thread 0, over {out[4]} '
            'row(s): ' + ', '.join(f'{k} {out[i]} ({100 * out[i] / max(out[0], 1):.1f}%)'
                                   for i, k in enumerate(fnames)))
    log(nvidia_smi_line())
    return 0


def pixels_only() -> int:
    """`--pixels`: the build, the canary, then the pixel phases alone
    (pixel_phases), for a quick check of the pixel path on the card."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    from tdmpc2_tpu_torch.ops import _build, probe
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    for name, (secs, _) in _build.build().items():
        log(f'  {name}.cu built in {secs:.1f} s')
    if not probe.kernel_engine_alive(torch.device('cuda')):
        raise AssertionError(f'canary: {probe.verdict()["reason"]}')
    _, zero_counts, read_counts, check_plan_counts = plan_counters(
        pixel_cfg().iterations)
    errs, paths, metrics = pixel_phases(zero_counts, read_counts, check_plan_counts, {})
    log(f'[done] {time.perf_counter() - t_start:.1f} s')
    log(smi)
    log(json.dumps({'pixels': metrics, 'max_abs_err_trained': errs, 'launches': paths}))
    return 0


def rows_only() -> int:
    """`--rows`: the build, then the row kernel alone (row_phase), for a
    quick check of it on the card; prints the card and the records."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    from tdmpc2_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    for name, (secs, _) in _build.build().items():
        log(f'  {name}.cu built in {secs:.1f} s')
    for fn, (regs, st, ld) in _build.ptxas_usage(_build.ptxas_report('rollout')).items():
        if fn.startswith('row'):
            log(f'    rollout.cu {fn}: {regs} registers, {st} bytes spill stores, '
                f'{ld} bytes spill loads')
    with Phase('the wide engine\'s row kernel alone against rows_plain'):
        records, worst = row_phase()
    log(f'  largest share of a tolerance used: {worst[0]:.3f}, max |err| {worst[1]:.3g}')
    log(nvidia_smi_line())
    log(json.dumps({'rows': records}))
    return 0


def compare(prev_root, pairs=2) -> int:
    """`--compare PREV [PAIRS]`: the kernels of the tree at PREV (an older
    version unpacked into a gitignored directory) against this tree's, in
    2 * PAIRS processes on the same card, PREV and this alternating as
    PREV, this, this, PREV, PREV, this, ... Prints each run's times and, per
    kernel, the ratios PREV / this of the pairs by CUDA events and by own
    device time: their median and range; and, from the first pair, the
    differences of the KEPT_OUTPUTS between PREV's and this tree's (the
    largest |this - PREV| and its share of the largest |PREV|)."""
    import torch
    here = os.path.dirname(os.path.abspath(__file__))
    keep_dir = tempfile.mkdtemp(prefix='chip_smoke_compare_')
    runs = []
    for i in range(pairs):
        pair = {}
        for root in ((prev_root, here) if i % 2 == 0 else (here, prev_root)):
            label = 'prev' if root == prev_root else 'this'
            cmd = [sys.executable, os.path.abspath(__file__), '--time-kernels', root]
            if i == 0:
                cmd.append(os.path.join(keep_dir, f'{label}.pt'))
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
            if r.returncode != 0:
                print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
                return 1
            pair[label] = json.loads(r.stdout.strip().splitlines()[-1])
            log(f'[compare] pair {i}, {label} ({root}): {json.dumps(pair[label])}')
        runs.append(pair)
    ratios, same = {}, {}
    for name in runs[0]['prev']:
        bits = {label: {p[label][name][2] for p in runs if len(p[label][name]) > 2}
                for label in ('prev', 'this')}
        if bits['prev'] and None not in bits['prev']:
            same[name] = len(bits['prev'] | bits['this']) == 1
            log(f'[compare] {name}: outputs of prev and this '
                + ('equal bit for bit' if same[name] else f'differ ({bits})'))
        ratios[name] = {}
        for k, kind in enumerate(('events', 'device')):
            rs = sorted(p['prev'][name][k] / p['this'][name][k] for p in runs
                        if p['prev'][name][k] and p['this'][name][k])
            if not rs:
                continue
            med = statistics.median(rs)
            ratios[name][kind] = {'median': med, 'range': [rs[0], rs[-1]]}
            log(f'[compare] {name}, {kind}: prev {[p["prev"][name][k] for p in runs]} ms, '
                f'this {[p["this"][name][k] for p in runs]} ms; prev/this median '
                f'{med:.3f}x, range {rs[0]:.3f}-{rs[-1]:.3f}x over {len(rs)} pairs')
    kept = {k: torch.load(os.path.join(keep_dir, f'{k}.pt')) for k in ('prev', 'this')}
    shutil.rmtree(keep_dir, ignore_errors=True)
    diffs = {}
    for name in KEPT_OUTPUTS:
        a, b = kept['prev'].get(name), kept['this'].get(name)
        if a is None or b is None:
            continue
        d = max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b))
        top = max(float(x.double().abs().max()) for x in a)
        diffs[name] = {'max_abs_diff': d, 'share_of_max_abs': d / top if top else None}
        log(f'[compare] {name}: largest |this - prev| {d:.4g} ({diffs[name]["share_of_max_abs"]}'
            ' of the largest |prev|)')
    log(nvidia_smi_line())
    log(json.dumps({'compare': ratios, 'equal_outputs': same, 'output_differences': diffs}))
    return 0


def plan_counters(I):
    """The kernel wrappers by name, and (zero_counts, read_counts,
    check_plan_counts) over their launch counters and the plan graphs'
    replays and captures, for plans of I iterations."""
    from tdmpc2_tpu_torch.ops import cem, probe, rollout, value, wide
    from tdmpc2_tpu_torch.utils.cuda_graph import Graph
    wrappers = {'value': value.value_estimate,
                'value_sampled': value.value_sampled,
                'cem_pi_rollout': cem.pi_rollout,
                'cem_elite': cem.elite_moments,
                'rollout': rollout.rollout_prepared,
                'probe': probe.add_one,
                # the wide engine's device launches (ops/wide.py), of any wrapper,
                # and the products, row kernels, stagings, u products and fused
                # folded layers among them, each counted where the library
                # launches it
                'wide': wide.engine_launches, 'wide_gemm': wide.gemm_launches,
                'wide_row': wide.row_launches, 'wide_stage': wide.stage_launches,
                'wide_fold_u': wide.fold_u_launches,
                'wide_fold_hidden': wide.fold_hidden_launches}

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0
        for kind in ('plan', 'update'):
            Graph.replays[kind] = Graph.captures[kind] = 0

    def read_counts():
        return {**{k: w.launches for k, w in wrappers.items()},
                **{f'{kind}_{what}': getattr(Graph, what).get(kind, 0)
                   for kind in ('plan', 'update') for what in ('replays', 'captures')}}

    def check_plan_counts(name, counts, plans=None, wide_per_plan=0, products_per_plan=0,
                          stages_per_plan=0, folds_per_plan=0):
        """Each plan of a path: one pi rollout, I sampled value launches and
        I elite launches (1 + 2 I kernels), none of the given-actions value
        launch, and one graph replay, or the eager run of a capture; and
        `wide_per_plan` device launches of the wide engine (0 below 2048
        columns), `products_per_plan` of them products, `stages_per_plan`
        stagings, `folds_per_plan` u products and as many fused folded
        layers, and the rest row kernels, each kind counted where the
        library launches it."""
        p = counts['cem_pi_rollout']
        rows_per_plan = (wide_per_plan - products_per_plan - stages_per_plan
                         - 2 * folds_per_plan)
        ok = (p > 0 and counts['value_sampled'] == I * p and counts['cem_elite'] == I * p
              and counts['value'] == 0 and counts['plan_replays'] > 0
              and counts['plan_replays'] + counts['plan_captures'] == p
              and counts['wide'] == wide_per_plan * p
              and counts['wide_gemm'] == products_per_plan * p
              and counts['wide_row'] == rows_per_plan * p
              and counts['wide_stage'] == stages_per_plan * p
              and counts['wide_fold_u'] == folds_per_plan * p
              and counts['wide_fold_hidden'] == folds_per_plan * p
              and (plans is None or p == plans))
        log(f'  {name}: {p} plans, {1 + 2 * I} planner launches a plan '
            f'({counts["value_sampled"]} sampled value, {counts["cem_elite"]} elite), '
            f'{counts["plan_replays"]} graph replays, {counts["plan_captures"]} captures'
            + (f'; the wide engine {counts["wide"]} launches, {wide_per_plan} a plan: '
               f'{counts["wide_gemm"]} products ({products_per_plan} a plan), '
               f'{counts["wide_row"]} row kernels ({rows_per_plan} a plan), '
               f'{counts["wide_stage"]} stagings ({stages_per_plan} a plan), '
               f'{counts["wide_fold_u"]} u products and {counts["wide_fold_hidden"]} fused '
               f'layers ({folds_per_plan} a plan each)'
               if wide_per_plan else ''))
        if not ok:
            raise AssertionError(f'{name}: planner launches {counts} for {plans} plans')
    return wrappers, zero_counts, read_counts, check_plan_counts


def mt30_cfg(load_cfg, extra=(), model_size=48, task='mt30'):
    """mt30 (or `task` mt80) at `model_size` (48 unless given; None: the
    default 5M widths; task_dim 64, or 96 at mt80 and model_size 317, by
    the config's rule), its per-task dims set from the literals above, as
    the JAX suite sets them where no dm_control builds the envs."""
    size = [] if model_size is None else [f'model_size={model_size}']
    cfg = load_cfg(overrides=[f'task={task}', *size, f'seed={SEED}', 'device=cuda',
                              *extra])
    obs, act, lengths = ((MT30_OBS_DIMS, MT30_ACTION_DIMS,
                          [MT30_EPISODE_LENGTH] * len(MT30_ACTION_DIMS))
                         if task == 'mt30' else
                         (MT80_OBS_DIMS, MT80_ACTION_DIMS, MT80_EPISODE_LENGTHS))
    cfg.obs_shape = {'state': (max(obs),)}
    cfg.action_dim = max(act)
    cfg.obs_shapes, cfg.action_dims = list(obs), list(act)
    cfg.episode_lengths = list(lengths)
    cfg.episode_length = max(lengths)
    return cfg


def write_mt30_chunks(root, n_chunks, eps, seed, task='mt30'):
    """Seeded .npz chunks in the layout of datasets/mt30_medium (or of the
    mt80 dataset, `task`): rows of an episode 501 (mt80: 101), the bootstrap
    row first (its action and reward NaN), obs 24 (mt80: 39) with zeros past
    each task's obs dim, actions 6 with zeros past its action dim, one task
    id per episode, every task in turn."""
    import numpy as np
    obs_dims, act_dims, rows = ((MT30_OBS_DIMS, MT30_ACTION_DIMS, MT30_EPISODE_LENGTH + 1)
                                if task == 'mt30' else
                                (MT80_OBS_DIMS, MT80_ACTION_DIMS, MT80_DATA_EPISODE + 1))
    rng = np.random.default_rng(seed)
    n_tasks = len(act_dims)
    for c in range(n_chunks):
        task_ids = (np.arange(eps) + c * eps) % n_tasks
        obs = rng.standard_normal((eps, rows, max(obs_dims)), dtype=np.float32)
        act = rng.uniform(-1, 1, (eps, rows, max(act_dims))).astype(np.float32)
        for i, t in enumerate(task_ids):
            obs[i, :, obs_dims[t]:] = 0.0
            act[i, :, act_dims[t]:] = 0.0
        reward = rng.uniform(0, 1, (eps, rows)).astype(np.float32)
        act[:, 0], reward[:, 0] = np.nan, np.nan
        np.savez(Path(root) / f'chunk_{c}.npz', obs=obs, action=act, reward=reward,
                 task=task_ids.astype(np.int32))


def write_toy_chunks(root, n_chunks=2, eps=6, rows=51):
    """Two-task toy chunks (obs 6, actions 2), as tests/test_offline.py's."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    for c in range(n_chunks):
        act = rng.uniform(-1, 1, (eps, rows, 2)).astype(np.float32)
        act[:, 0] = np.nan
        np.savez(Path(root) / f'chunk_{c}.npz',
                 obs=rng.standard_normal((eps, rows, 6)).astype(np.float32),
                 action=act, reward=rng.uniform(0, 1, (eps, rows)).astype(np.float32),
                 task=(np.arange(eps) % 2).astype(np.int32))


def multitask_phases(zero_counts, read_counts, check_plan_counts, update_records):
    """The multi-task slice on the card. Returns (max |err| of each
    task-axis check, {path: launch counts}, the task-axis kernels' rows of
    the JSON line).

    - the planner's kernels on the task axis: mt30 at model_size 48, N = 30
      tasks (mixed action dims) against their plain versions, and one
      N = 30 launch against 30 one-task launches bit for bit; the episodic
      value step under the gate rule;
    - offline mt30 training at model_size 48 on seeded chunks of the
      dataset's geometry (`OfflineTrainer`, eval past the last iteration:
      no env is stepped, the card has no dm_control);
    - `act_tasks` over the 30 tasks, lockstep, on observations from the
      data: one graph replay of 1 + 2 x iterations launches a step;
    - a toy multi-task config through `train` (offline training, then the
      lockstep eval over its envs) and `evaluate` from its checkpoint.
    """

    import numpy as np
    import torch
    from tdmpc2_tpu_torch import train as train_mod
    from tdmpc2_tpu_torch.config import load_cfg
    from tdmpc2_tpu_torch.data.buffer import Buffer
    from tdmpc2_tpu_torch.evaluate import evaluate
    from tdmpc2_tpu_torch.ops import cem, value
    from tdmpc2_tpu_torch.tdmpc2 import TDMPC2
    from tdmpc2_tpu_torch.trainer.offline import OfflineTrainer
    from tdmpc2_tpu_torch.utils.logger import Logger
    dev = torch.device('cuda')
    errs, paths, rows = {}, {}, []
    NT = len(MT30_ACTION_DIMS)

    with Phase(f'kernels on the task axis: mt30, model_size 48, N={NT} tasks'):
        cfg = mt30_cfg(load_cfg)
        ag = TDMPC2(cfg, device='cuda')
        mg = torch.Generator().manual_seed(SEED + 48)
        ag.load_params(perturbed(ag.model.init(mg), mg, sweep_scale(cfg.mlp_dim)))
        g = torch.Generator(device=dev).manual_seed(SEED + 48)
        prep = ag.prep
        H, S, A, L = cfg.horizon, cfg.num_samples, cfg.action_dim, cfg.latent_dim
        n_pi, HA = cfg.num_pi_trajs, cfg.horizon * cfg.action_dim
        heads = dict(log_std_min=ag.model.log_std_min,
                     log_std_dif=ag.model.log_std_dif, simnorm_dim=cfg.simnorm_dim)
        log(f'  task_dim {cfg.task_dim}, {NT} tasks, L={L}, M={cfg.mlp_dim}; bias '
            f'tables {tuple(prep["db0"].shape)} and Q {tuple(prep["qb0"].shape)}; plan '
            f'{value.kernel_plan(prep, cfg.simnorm_dim, H)}')
        tt = torch.arange(NT, dtype=torch.int32, device=dev)
        amask = ag.amask[tt.long()].contiguous()
        discs = ag.discs[tt.long()]
        obs = torch.randn(NT, cfg.obs_shape['state'][0], device=dev, generator=g)
        obs *= torch.arange(obs.shape[1], device=dev) < torch.tensor(
            MT30_OBS_DIMS, device=dev)[:, None]
        z = ag.model.encode(ag.params, obs, tt.long())[:, None]
        noise = ag.draw_noise(NT)
        pi_args = (prep, z, noise.pi_eps[:, :n_pi])
        pi_kw = dict(heads, task=tt, amask=amask)
        pa = cem.pi_rollout(*pi_args, **pi_kw)
        free = cem.pi_rollout_plain(*pi_args, **pi_kw)
        over = (pa - free).abs() > PI_TOL['atol'] + PI_TOL['rtol'] * free.abs()
        log(f'  pi_rollout N={NT} tasks against the free-running plain rollout: max '
            f'|err| {max_err(pa, free):.3g} by step '
            f'{[round(max_err(pa[..., t * A:(t + 1) * A], free[..., t * A:(t + 1) * A]), 5) for t in range(H)]}, '
            f'{int(over.sum())} of {over.numel()} values outside {PI_TOL}')
        free_c = cem.pi_rollout_plain({k: x.cpu() for k, x in prep.items()}, z.cpu(),
                                      pi_args[2].cpu(), **heads, task=tt.cpu(),
                                      amask=amask.cpu())
        over_c = (free_c - free.cpu()).abs() > (PI_TOL['atol']
                                                + PI_TOL['rtol'] * free.cpu().abs())
        log(f'  the plain pi rollout on the CPU against the same on the card: max '
            f'|err| {max_err(free_c, free.cpu()):.3g}, {int(over_c.sum())} of '
            f'{over_c.numel()} values outside {PI_TOL}')
        errs['cem_pi_rollout_tasks'] = hold(
            f'pi_rollout N={NT} tasks, each step on the kernel\'s trajectory', pa,
            pi_rollout_forced(*pi_args, pa, heads, tt, amask), PI_TOL)
        vs_args = (prep, z.expand(NT, S, L),
                   torch.rand(NT, HA, device=dev, generator=g) * 1.6 - 0.8,
                   torch.rand(NT, HA, device=dev, generator=g) * 1.9 + 0.1,
                   noise.sample[:, 0], pa, amask, noise.eps[:, 0], noise.qidx[:, 0],
                   discs)
        vs_kw = dict(heads, task=tt)
        errs['value_sampled_tasks'], v, acts = hold_sampled(
            f'N={NT} tasks', vs_args, heads, task=tt)
        elite_kw = dict(num_elites=cfg.num_elites, temperature=cfg.temperature,
                        min_std=cfg.min_std, max_std=cfg.max_std)
        e_args = (v, acts, amask)
        got = cem.elite_moments(*e_args, **elite_kw)
        ref = cem.elite_moments_plain(*e_args, **elite_kw)
        errs['cem_elite_tasks'] = max(hold(f'elite N={NT} tasks {k}', a, b, ELITE_TOL)
                                      for k, a, b in zip(('mean', 'std', 'v'), got, ref))
        masked = (torch.arange(A, device=dev) >= torch.tensor(
            MT30_ACTION_DIMS, device=dev)[:, None]).float()       # [NT, A]
        for name, x in (('policy rows', pa), ('sampled actions', acts),
                        ('elite mean', got[0]), ('elite std', got[1])):
            if float((x.reshape(NT, -1, H, A).abs() * masked[:, None, None]).max()) != 0:
                raise AssertionError(f'task axis: {name} not 0 in masked columns')
        log('  every masked action column is 0 (policy rows, samples, elite moments)')
        for i in range(NT):
            sl = slice(i, i + 1)
            one_pa = cem.pi_rollout(prep, z[sl], pi_args[2][sl], **heads, task=tt[sl],
                                    amask=amask[sl])
            one_v = value.value_sampled(*[a if a is prep else a[sl] for a in vs_args],
                                        **dict(vs_kw, task=tt[sl]))
            one_e = cem.elite_moments(v[sl], acts[sl], amask[sl], **elite_kw)
            if not (torch.equal(pa[sl], one_pa) and torch.equal(v[sl], one_v[0])
                    and torch.equal(acts[sl], one_v[1])
                    and all(torch.equal(a[sl], b) for a, b in zip(got, one_e))):
                raise AssertionError(f'task axis: the N={NT} launch differs from the '
                                     f'one-task launch of task {i}')
        log(f'  pi rollout, sampled value and elite: the N={NT} launch equals {NT} '
            'one-task launches, bit for bit')
        # The episodic models: the termination head's first-layer bias per
        # task. At N = 30 each launch is held exactly (against the
        # given-actions launch on its actions, and against 30 one-task
        # launches), and its statistics against the plain step (the value
        # band where the flags agree, the gate rule where they differ) are
        # logged beside those of two plain versions, the card's and the
        # CPU's: 15,360 rows are past the population (N=8 x 512) on which the
        # band and the rule's 1e-2 were set, and two summation orders of the
        # same arithmetic break them too there. The gate rule is held at the
        # default 5M widths on 8 of the tasks, one of each action dim and two
        # more: the main paths' population.
        for size in (None, 48):
            e_cfg = mt30_cfg(load_cfg, ['episodic=true'], model_size=size)
            e_ag = TDMPC2(e_cfg, device='cuda')
            eg = torch.Generator().manual_seed(SEED + (size or 5))
            e_ag.load_params(perturbed(e_ag.model.init(eg), eg,
                                       sweep_scale(e_cfg.mlp_dim)))
            split_termination(e_ag, g)
            eL = e_cfg.latent_dim
            ez = e_ag.model.encode(e_ag.params, obs, tt.long())[:, None]
            e_args = (e_ag.prep, ez.expand(NT, S, eL)) + vs_args[2:]
            tag = f'episodic N={NT} tasks, model_size {size or 5}'
            _, e_v, e_acts = hold_sampled(tag, e_args, heads, episodic=True, task=tt,
                                          gate_rule=False)
            for i in range(NT):
                sl = slice(i, i + 1)
                one = value.value_sampled(
                    *[a if a is e_args[0] else a[sl] for a in e_args], **heads,
                    episodic=True, task=tt[sl])
                if not (torch.equal(e_v[sl], one[0]) and torch.equal(e_acts[sl], one[1])):
                    raise AssertionError(f'{tag}: the launch differs from task {i}\'s')
            log(f'  {tag}: the N={NT} launch equals {NT} one-task launches, bit for bit')
            nc = NT if size is None else 10     # the CPU's share: its plain step is slow
            given = (e_args[0], e_args[1][:nc],
                     e_acts[:nc].view(nc, S, H, A).permute(0, 2, 1, 3),
                     *[a[:nc] for a in e_args[7:]])
            kw = dict(heads, episodic=True, task=tt[:nc], amask=amask[:nc])
            at_g = torch.empty(nc, S, dtype=torch.int32, device=dev)
            v_g = value.value_estimate_plain(*given, **kw, term_at=at_g)
            cpu = [{k: x.cpu() for k, x in given[0].items()}] + [x.cpu() for x in given[1:]]
            at_c = torch.empty(nc, S, dtype=torch.int32)
            v_c = value.value_estimate_plain(*cpu, **dict(
                kw, task=tt[:nc].cpu(), amask=amask[:nc].cpu()), term_at=at_c)
            lg, _ = value.termination_trace_plain(*given[:3], given[-1],
                                                  heads['simnorm_dim'], task=tt[:nc])
            lc, _ = value.termination_trace_plain(*cpu[:3], cpu[-1], heads['simnorm_dim'],
                                                  task=tt[:nc].cpu())
            flips, bad = value.gate_check(v_c, v_g.cpu(), at_c, at_g.cpu(), lg.cpu(),
                                          **VALUE_TOL, near=GATE_NEAR)
            agree = (at_c == at_g.cpu())[..., None]
            log(f'  the plain step on the CPU against the same on the card ({nc} tasks, '
                f'model_size {size or 5}): values differ by up to '
                f'{max_err(v_c[agree], v_g.cpu()[agree]):.3g} where the flags agree, '
                f'termination logits by up to {max_err(lc, lg.cpu()):.3g} (logit std '
                f'{float(lg.std()):.3g}); {flips} flips with |logit| < {GATE_NEAR}, {bad} '
                f'rows outside the gate rule, of {v_g.numel()}')
            if size is None:
                sub = torch.tensor(MT_GATE_TASKS, device=dev)
                errs['value_sampled_tasks_episodic'] = hold_sampled(
                    f'episodic, tasks {MT_GATE_TASKS}, model_size 5',
                    tuple(a if a is e_args[0] else a[sub] for a in e_args), heads,
                    episodic=True, task=tt[sub])[0]

        # timing and bounds at N = 30 (CUDA events; own device time)
        M, B = prep['dWz'].shape[1], prep['rW2'].shape[1]
        mac_rew = L * M + A * M + M * M + M * B
        mac_dyn = L * M + A * M + M * M + M * L
        mac_pi = L * M + M * M + 2 * M * A
        used = sorted(set(noise.qidx[:, 0].flatten().tolist()))
        packed = [k for k in value.PACKED if k in prep and k[0] in 'drp']
        w_dyn_pi = nbytes(*[prep[k] for k in value.PACKED if k[0] in 'dp'])
        w_step = (nbytes(*[prep[k] for k in packed])
                  + sum(nbytes(prep[k][j]) for k in ('qP0', 'qP1', 'qP2') for j in used)
                  + 4 * (6 * M + L + B) * NT)
        bounds = {
            'value_sampled_tasks': bound_ms(
                w_step + NT * (L * 4 + 2 * HA * 4 + (S - n_pi) * HA * 4 + n_pi * HA * 4
                               + S * A * 4 + S * 4 + S * HA * 4),
                2 * NT * S * (H * (mac_rew + mac_dyn) + mac_pi + 2 * mac_rew),
                BF16_FLOPS, 3 * NT * S * HA),
            'cem_pi_rollout_tasks': bound_ms(
                w_dyn_pi + NT * (L * 4 + 2 * n_pi * HA * 4),
                2 * NT * n_pi * H * (mac_pi + mac_dyn), BF16_FLOPS),
            'cem_elite_tasks': bound_ms(
                nbytes(v, acts, amask) + NT * S * 4 + 2 * NT * HA * 4,
                NT * (35 * S + 8 * S * HA), F32_FLOPS)}
        calls = {
            'value_sampled_tasks': (value.value_sampled, value.value_sampled_plain,
                                    vs_args, vs_kw, 'tdmpc2_tpu_torch/csrc/value.cu',
                                    'tdmpc2_tpu/ops/pallas_rollout.py:437'),
            'cem_pi_rollout_tasks': (cem.pi_rollout, cem.pi_rollout_plain, pi_args,
                                     pi_kw, 'tdmpc2_tpu_torch/csrc/cem.cu',
                                     'tdmpc2_tpu/ops/pallas_cem.py:53'),
            'cem_elite_tasks': (cem.elite_moments, cem.elite_moments_plain,
                                (v, acts, amask), elite_kw,
                                'tdmpc2_tpu_torch/csrc/cem.cu',
                                'tdmpc2_tpu/ops/pallas_cem.py:53')}
        timed = {}
        for name, (kern, plain, args, kw, src, rpl) in calls.items():
            ms = time_ms(lambda: kern(*args, **kw), 10)
            dev_ms = device_share(lambda: kern(*args, **kw), 5)[0]
            plain_ms = time_ms(lambda: plain(*args, **kw), 3)
            b_ms, b_by = bounds[name]
            timed[name] = ms
            log(f'  {name} (N={NT}, model_size 48): kernel {ms:.4f} ms (its own device '
                f'time {dev_ms} ms), plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms '
                f'({b_by}), {ms / b_ms:.1f}x the bound')
            rows.append({'name': name, 'route': 'cuda', 'source': src, 'replaces': rpl,
                         'launches': None, 'max_abs_err': errs[name], 'ms': ms,
                         'device_ms': dev_ms, 'plain_ms': plain_ms, 'bound_ms': b_ms,
                         'bound_by': b_by, 'library_ms': None, 'n_envs': NT,
                         'model_size': 48})
        streamed = (H * nbytes(*[prep[k] for k in ('rP0', 'rP1', 'rP2', 'dP0', 'dP1',
                                                   'dP2')])
                    + nbytes(*[prep[k] for k in ('pP0', 'pP1', 'pP2')])
                    + 2 * nbytes(*[prep[k][0] for k in ('qP0', 'qP1', 'qP2')]))
        blocks = NT * -(-S // value.kernel_plan(prep, cfg.simnorm_dim, H)['rt'])
        ms_v = timed['value_sampled_tasks']
        log(f'  value_sampled N={NT}: each of its {blocks} blocks streams '
            f'{streamed / 1e6:.1f} MB of packed weights ({blocks * streamed / 1e9:.1f} GB '
            f'from L2 a launch, {streamed * blocks / 1e9 / ms_v:.2f} TB/s over its '
            f'{ms_v:.3f} ms); the distinct weights it reads are {w_step / 1e6:.1f} MB')
        del e_ag, ag, prep

    with tempfile.TemporaryDirectory() as data_dir, \
            Phase(f'path: offline training mt30, model_size 48, {MT_STEPS} iterations '
                  f'(OfflineTrainer, {MT_CHUNKS} seeded chunks of the dataset\'s '
                  'geometry)'):
        t0 = time.perf_counter()
        write_mt30_chunks(data_dir, MT_CHUNKS, MT_EPISODES, SEED)
        log(f'  {MT_CHUNKS} chunks x {MT_EPISODES} episodes written in '
            f'{time.perf_counter() - t0:.1f} s')
        cfg = mt30_cfg(load_cfg, [f'data_dir={data_dir}', f'steps={MT_STEPS}',
                                  f'eval_freq={10 * MT_STEPS}', 'save_agent=false',
                                  'exp_name=chip_smoke_mt30'])
        ag = TDMPC2(cfg, device='cuda')
        trainer = OfflineTrainer(cfg=cfg, env=None, agent=ag, buffer=Buffer(cfg),
                                 logger=Logger(cfg))
        infos, t_load = [], {}
        many = ag.update_many       # its info is the graph's, overwritten by the next
        ag.update_many = lambda buf, n: infos.append(clone_info(many(buf, n))) or infos[-1]
        load = trainer._load_dataset

        def timed_load():
            t1 = time.perf_counter()
            load()
            torch.cuda.synchronize()
            t_load['s'] = time.perf_counter() - t1
        trainer._load_dataset = timed_load
        zero_counts()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0 - t_load['s']
        paths['offline train mt30'] = read_counts()
        del ag.update_many
        buf = trainer.buffer
        losses = torch.stack([torch.stack([i['total_loss'], i['pi_loss']])
                              for i in infos])
        store = buf._storage['obs']
        log(f'  dataset: {buf.num_eps} episodes ({buf.num_eps * MT30_EPISODE_LENGTH:,} '
            f'transitions) on {store.device}, '
            f'{sum(nbytes(x) for x in buf._storage.values()) / 1e6:.1f} MB, loaded '
            f'in {t_load["s"]:.1f} s')
        log(f'  {MT_STEPS} iterations ({len(infos)} update_many calls) in {secs:.1f} s: '
            f'{MT_STEPS / secs:.2f} iterations/s; last losses total '
            f'{float(losses[-1, 0]):.4f}, pi {float(losses[-1, 1]):.4f}; launches '
            f'{paths["offline train mt30"]}')
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError('offline mt30: non-finite loss')
        if len(infos) != MT_STEPS // 8 or buf.num_eps != MT_CHUNKS * MT_EPISODES:
            raise AssertionError(f'offline mt30: {len(infos)} calls, {buf.num_eps} '
                                 'episodes')
        if store.device.type != 'cuda':
            raise AssertionError('offline mt30: the dataset is not on the card')
        check_update_counts('offline train mt30', paths['offline train mt30'], MT_STEPS)
        upd_ms = time_ms(lambda: ag.update_many(buf, 8), 3) / 8
        busy, n_dev, _ = device_share(lambda: ag.update(buf), 3)
        log(f'  update: {upd_ms:.3f} ms (CUDA events, update_many(8) / 8), '
            f'{1e3 / upd_ms:.2f} update steps/s at batch {cfg.batch_size}; device busy '
            f'{busy} ms of one update over {n_dev} device activities (torch.profiler)')
        hold_update_graph('mt30, model_size 48', ag, buf.sample())
        update_records['mt30/48'] = dict(update_record(
            'mt30, model_size 48', ag, buf.sample(), buf, reps=8),
            offline_iterations_per_s=MT_STEPS / secs)
        bf16_twin_hold('mt30/48', ag, buf.sample(), update_records)

        # act_tasks over the 30 tasks on the data's observations
        task_store = buf._task_store
        first = torch.stack([torch.nonzero(task_store == t)[0, 0] for t in range(NT)])
        obs_at = [store[first, r].cpu().numpy() for r in range(MT_ACT_STEPS + 1)]
        H, A = cfg.horizon, cfg.action_dim
        tasks = np.arange(NT)
        zero_counts()
        t0 = time.perf_counter()
        a, pm = ag.act_tasks(obs_at[0], np.zeros((NT, H, A), np.float32), True, tasks)
        capture_ms = 1e3 * (time.perf_counter() - t0)
        for r in range(1, MT_ACT_STEPS + 1):
            a, pm = ag.act_tasks(obs_at[r], pm, False, tasks)
        paths['act_tasks mt30'] = read_counts()
        check_plan_counts(f'act_tasks mt30 (N={NT})', paths['act_tasks mt30'],
                          MT_ACT_STEPS + 1)
        if not np.isfinite(a).all() or any(
                (a[i, MT30_ACTION_DIMS[i]:] != 0).any() for i in range(NT)):
            raise AssertionError('act_tasks: non-finite actions or a masked column set')
        ms = host_ms(lambda: ag.act_tasks(obs_at[-1], pm, False, tasks), 10)
        busy, n_dev, top = device_share(
            lambda: ag.act_tasks(obs_at[-1], pm, False, tasks), 3)
        log(f'  act_tasks N={NT}: first call (eager warm-up and capture) '
            f'{capture_ms:.1f} ms; then {ms:.3f} ms a call ({1e3 * NT / ms:.1f} task-plans/s, '
            f'host clock); device busy {busy} ms ('
            + ('not measured' if busy is None else
               f'{100 * busy / ms:.1f}% of the call') + f') over {n_dev} activities')
        for t, n, k in top or []:
            log(f'    {t:.3f} ms in {n:.0f} x {k[:90]}')
        for row in rows:
            row['launches'] = paths['act_tasks mt30'][row['name'].replace('_tasks', '')]
        del trainer, ag, buf, store

    with tempfile.TemporaryDirectory() as data_dir, \
            Phase('path: train, a toy multi-task config (2 tasks, 5M model): offline '
                  f'training {TOY_MT_STEPS} iterations, then the lockstep eval; '
                  'evaluate from its checkpoint'):
        write_toy_chunks(data_dir)
        cfg = load_cfg(overrides=['task=toy-mt2', f'seed={SEED}', 'device=cuda',
                                  f'data_dir={data_dir}', f'steps={TOY_MT_STEPS}',
                                  f'eval_freq={TOY_MT_STEPS}', 'eval_episodes=1',
                                  'exp_name=chip_smoke_toy_mt'])
        cfg.multitask, cfg.tasks, cfg.task_dim = True, ['toy-reach', 'toy-reach'], 8
        scores = []
        pprint = Logger.pprint_multitask
        Logger.pprint_multitask = lambda self, m, c: scores.append(pprint(self, m, c)) \
            or scores[-1]
        try:
            zero_counts()
            tr = train_mod.train(cfg)
            paths['offline train toy multi-task'] = read_counts()
        finally:
            Logger.pprint_multitask = pprint
        check_plan_counts('offline train toy multi-task (its eval)',
                          paths['offline train toy multi-task'], MAX_EP_LEN)
        check_update_counts('offline train toy multi-task',
                            paths['offline train toy multi-task'], TOY_MT_STEPS)
        ckpt = Path(cfg.work_dir) / 'models' / f'{TOY_MT_STEPS}.pkl'
        if not (isinstance(tr, OfflineTrainer) and scores and math.isfinite(scores[0])
                and ckpt.exists()):
            raise AssertionError(f'toy multi-task: trainer {type(tr).__name__}, '
                                 f'scores {scores}, checkpoint {ckpt.exists()}')
        log(f'  normalized score {scores[0]:.4f}; launches '
            f'{paths["offline train toy multi-task"]}')
        ev_cfg = load_cfg(overrides=['task=toy-mt2', f'seed={SEED}', 'device=cuda',
                                     'eval_episodes=1', f'checkpoint={ckpt}'])
        ev_cfg.multitask, ev_cfg.tasks, ev_cfg.task_dim = True, list(cfg.tasks), 8
        zero_counts()
        res = evaluate(ev_cfg)['toy-reach']
        paths['evaluate toy multi-task'] = read_counts()
        check_plan_counts('evaluate toy multi-task', paths['evaluate toy multi-task'],
                          res['plans'])
        if not math.isfinite(res['reward']) or res['plans'] != MAX_EP_LEN:
            raise AssertionError(f'evaluate toy multi-task: {res}')
        log(f'  evaluate: reward {res["reward"]:.4f}, {res["plans"]} lockstep plans, '
            f'{res["plans"] / res["seconds"]:.1f} plans/s')
    return errs, paths, rows


def pi_rollout_own_steps(name, prep, z0, pi_eps, heads, task, amask):
    """The pi-rollout kernel's free-running launch (all H steps) with each
    step held in PI_TOL against the plain arithmetic on that step's own
    inputs: its action at step t against the plain policy at the kernel's
    latent z_t (z_0 given; z_1 .. z_{H-1} the kernel's own, its `latents`),
    and each z_{t+1} against the plain dynamics of the kernel's (z_t, a_t).
    Both sides round the same f32 inputs to bf16, so a wrong layer anywhere
    in the launch shows at its step. Returns (the kernel's actions, the max
    |err|)."""
    import torch
    from tdmpc2_tpu_torch.ops import cem, value
    N, n_pi, HA = pi_eps.shape
    A, L = prep['pWm'].shape[1], z0.shape[-1]
    H = HA // A
    zs = torch.empty(H - 1, N, n_pi, L, device=z0.device)
    acts = cem.pi_rollout(prep, z0, pi_eps, **heads, task=task, amask=amask, latents=zs)
    m = value.mask_rows(amask, A)
    z = z0.float().expand(N, n_pi, L)
    want_a, want_z = [], []
    for t in range(H):
        sl = slice(t * A, (t + 1) * A)
        mean, ls = value.pi_head_plain(prep, z, heads['log_std_min'], heads['log_std_dif'],
                                       task)
        want_a.append(value.pi_action_plain(mean, ls, pi_eps[..., sl], m))
        if t + 1 < H:
            want_z.append(value.dynamics_plain(prep, z, acts[..., sl], heads['simnorm_dim'],
                                               task))
            z = zs[t]
    err = max(hold(f'{name}, each step\'s action from the kernel\'s own latent', acts,
                   torch.cat(want_a, -1), PI_TOL),
              hold(f'{name}, z_1..z_{H - 1} from the kernel\'s own (z_t, a_t)', zs,
                   torch.stack(want_z), PI_TOL))
    return acts, err


def log_pi_drift(name, pi, heads, tk, acts):
    """Log the free-running pi rollout's distance from the plain rollout
    (not held: PERF.md §6), beside that of two plain versions, the CPU's
    and the card's, on the same inputs; and the same with the plain latents
    advanced on the other side's actions (`pi_rollout_forced`)."""
    from tdmpc2_tpu_torch.ops import cem
    prep, z0, eps = pi
    free = cem.pi_rollout_plain(*pi, **heads, **tk)
    cpu = ({k: x.cpu() for k, x in prep.items() if k[0] in 'dp'}, z0.cpu(), eps.cpu())
    cpu_tk = {k: x.cpu() for k, x in tk.items()}
    free_c = cem.pi_rollout_plain(*cpu, **heads, **cpu_tk)
    forced = pi_rollout_forced(*pi, acts, heads, **tk)
    forced_c = pi_rollout_forced(*cpu, free.cpu(), heads, **cpu_tk)

    def outside(a, b):
        return int(((a - b).abs() > PI_TOL['atol'] + PI_TOL['rtol'] * b.abs()).sum())
    log(f'  {name}, free-running against the plain rollout (not held): max |err| '
        f'{max_err(acts, free):.3g}, {outside(acts, free)} of {acts.numel()} values outside '
        f'{PI_TOL}; two plain versions (CPU against the card): max |err| '
        f'{max_err(free_c, free.cpu()):.3g}, {outside(free_c, free.cpu())} outside. Plain '
        f'latents advanced on the kernel\'s actions: max |err| {max_err(acts, forced):.3g}, '
        f'{outside(acts, forced)} outside; the CPU\'s on the card plain\'s actions: max '
        f'|err| {max_err(free.cpu(), forced_c):.3g}, {outside(free.cpu(), forced_c)} outside')


# The wide engine's product (csrc/mlp_wide.cuh gemm_kernel) alone, at the
# 317M model's shapes (L 1376, M 4096, A 6, 101 bins, 8 Q heads, 80 tasks)
# and the 5M rollout's: (name, K, N, kind), kind 'task' a first layer's
# per-task bias rows, 'q0' the Q heads' first layer (each env's head and
# task rows), 'q' a later Q layer (each env's head), 'pi' the policy head
# (its log-std bias past A), '' one bias row. Rows: one env, N=8 and N=80
# envs of S=512 (the value step); the pi rollout's N=80 x 24 rows.
WIDE_DIMS = (1376, 4096, 6, 101, 8, 8, 3)
PRODUCT_SHAPES = (
    ('z||a -> M', 1392, 4096, 'task'), ('latent -> M', 1376, 4096, 'task'),
    ('M -> M', 4096, 4096, ''), ('M -> latent', 4096, 1376, ''),
    ('M -> bins', 4096, 101, ''), ('M -> pi', 4096, 12, 'pi'), ('M -> term', 4096, 1, ''),
    ('Q: z||a -> M', 1392, 4096, 'q0'), ('Q: M -> M', 4096, 4096, 'q'),
    ('Q: M -> bins', 4096, 101, 'q'))
PRODUCT_ENVS = (1, 8, 80)
PI_SHAPES = ('latent -> M', 'M -> M', 'M -> latent', 'M -> pi', 'z||a -> M')
ROLLOUT_5M = (512, 512, 6, 101, 5, 8, 3)
ROLLOUT_5M_SHAPES = (('z||a -> M', 528, 512, ''), ('M -> M', 512, 512, ''),
                     ('M -> bins', 512, 101, ''))
# |y - y_plain| <= 1e-4 (|x| @ |W|) + 1e-6: f32 sums of bf16 products over
# K <= 4096, about 256 accumulator roundings of 2^-23, with margin.
PRODUCT_RTOL, PRODUCT_ATOL = 1e-4, 1e-6
PRODUCT_HEADLINE = ('M -> M', 80)


def sass_counts():
    """{library: {kernel: {instruction: count}}} of the product kernels (the
    wide engine's and the fold's u product) in the built libraries' SASS
    (cuobjdump -sass): wgmma (HGMMA), TMA loads
    (UTMALDG), bulk copies (UBLKCP), mma.sync (HMMA), cp.async (LDGSTS);
    None where the toolkit has no cuobjdump."""
    import re
    from tdmpc2_tpu_torch.ops import _build
    exe = Path(_build.nvcc()).parent / 'cuobjdump'
    if not exe.is_file():
        return None
    ops = ('HGMMA', 'UTMALDG', 'UBLKCP', 'HMMA', 'LDGSTS')
    out = {}
    for name in _build.WIDE_SOURCES:
        text = subprocess.run([str(exe), '-sass', str(_build.target(name))],
                              capture_output=True, text=True, timeout=300).stdout
        fn, counts = None, {}
        for line in text.splitlines():
            m = re.search(r'Function : (\S+)', line)
            if m:
                fn = _build._short(m.group(1))
                if fn.startswith(('gemm_kernel', 'fold_u_kernel')):
                    counts[fn] = dict.fromkeys(ops, 0)
                continue
            if fn in counts:
                for op in ops:
                    if re.search(r'\b' + op + r'[.\s]', line):
                        counts[fn][op] += 1
        out[name] = counts
    return out


def product_phase(only=None):
    """The product alone on the card, each shape of PRODUCT_SHAPES at N=1,
    8 and 80 envs of 512 rows, the pi rollout's at N=80 x 24 rows and the
    5M rollout's at 512 rows (only the 317M shapes named in `only`, when
    given): held
    against the plain product (x.float() @ W.float() + bias) within
    PRODUCT_RTOL of |x| @ |W| (x's columns past K NaN, so that a read past
    K shows); N=8 against a one-env launch on env 3's rows bit for bit;
    timed by CUDA events beside torch.matmul on the same bf16 operands
    (cuBLAS, in turns), each one's own device time by torch.profiler, the
    plain product's time, and the bound. Returns (the shapes' records, max
    |err|)."""
    import torch
    from tdmpc2_tpu_torch.ops import wide
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(SEED + 4096)
    n_tasks, NQ = 80, WIDE_DIMS[4]
    records, worst = [], 0.0
    cases = [(WIDE_DIMS, 512, n, sh) for n in PRODUCT_ENVS for sh in PRODUCT_SHAPES]
    cases += [(WIDE_DIMS, 24, 80, sh) for sh in PRODUCT_SHAPES if sh[0] in PI_SHAPES]
    cases += [(ROLLOUT_5M, 512, 1, sh) for sh in ROLLOUT_5M_SHAPES]
    if only is not None:
        cases = [c for c in cases if c[0] is WIDE_DIMS and c[3][0] in only]

    def operands(dims, S, n, K, N, kind):
        R, heads = n * S, NQ if kind in ('q0', 'q') else 1
        ldx = K + 16 if K % 64 else K      # the latent's x rows carry the actions after
        x = torch.randn(R, ldx, device=dev, generator=g).to(torch.bfloat16)
        x[:, K:] = float('nan')
        w = (torch.randn(heads, N, K, device=dev, generator=g) * K ** -0.5).to(torch.bfloat16)
        env = torch.arange(n, device=dev, dtype=torch.int32)
        task = env % n_tasks
        head = torch.stack([env % NQ, (env + 1) % NQ], 1).to(torch.int32)   # as qidx [n, 2]
        kw = dict(task=None, ntask=1, head=None, hn=2, bt=0, bh=0)
        if kind == 'task':
            b = torch.randn(n_tasks, N, device=dev, generator=g)
            kw.update(task=task, ntask=n_tasks, bt=N)
        elif kind == 'q0':
            b = torch.randn(n_tasks, NQ, N, device=dev, generator=g)
            kw.update(task=task, ntask=n_tasks, head=head, bt=NQ * N, bh=N)
        elif kind == 'q':
            b = torch.randn(NQ, N, device=dev, generator=g)
            kw.update(head=head, bh=N)
        elif kind == 'pi':
            b = torch.randn(N // 2, device=dev, generator=g)
            kw.update(b1=torch.randn(N // 2, device=dev, generator=g), split=N // 2)
        else:
            b = torch.randn(N, device=dev, generator=g)
        return x, (w if heads > 1 else w[0]), b, kw

    def plain(x, w, b, kw, S, K, N, mag=False):
        """x.float() @ W.float() + bias row by row's env (|x| @ |W| with
        mag), in f32 on the card (TF32 off)."""
        R = x.shape[0]
        env = torch.arange(R, device=dev) // S
        xf = x[:, :K].float()
        ws = w if w.dim() == 3 else w[None]
        h = kw['head'][env.long(), 0].long() if kw['head'] is not None else torch.zeros_like(env)
        y = torch.empty(R, N, device=dev)
        for k in range(ws.shape[0]):
            sel = h == k
            if bool(sel.any()):
                wk = ws[k].float().t()
                y[sel] = (xf[sel].abs() @ wk.abs()) if mag else (xf[sel] @ wk)
        if mag:
            return y
        t = kw['task'][env.long()].long() if kw['task'] is not None else torch.zeros_like(env)
        if kw.get('split', -1) >= 0:
            bias = torch.cat([b, kw['b1']])[None].expand(R, N)
        elif b.dim() == 3:
            bias = b[t, h]
        elif kw['head'] is not None:
            bias = b[h]
        elif kw['task'] is not None:
            bias = b[t]
        else:
            bias = b[None].expand(R, N)
        return y + bias

    for dims, S, n, (label, K, N, kind) in cases:
        x, w, b, kw = operands(dims, S, n, K, N, kind)
        R = n * S
        y, plan = wide.gemm(x, w, b, dims, S, **kw)
        got = wide.gemm_sum(y, plan, N)
        want = plain(x, w, b, kw, S, K, N)
        room = PRODUCT_RTOL * plain(x, w, b, kw, S, K, N, mag=True) + PRODUCT_ATOL
        err = max_err(got, want)
        over = float(((got - want).abs() / room).max())
        tag = f'{label} ({"317" if dims is WIDE_DIMS else "5M"}, {n} x {S} rows)'
        if not bool(torch.isfinite(got).all()) or over > 1:
            raise AssertionError(f'product {tag}: max |err| {err:.3g}, {over:.3f} of the '
                                 f'tolerance at its tightest (plan {plan})')
        worst = max(worst, err)
        if n == 8:
            # env 3 alone: its rows of the N=8 launch bit for bit
            sl = slice(3 * S, 4 * S)
            one_kw = dict(kw, task=None if kw['task'] is None else kw['task'][3:4],
                          head=None if kw['head'] is None else kw['head'][3:4])
            y1, _ = wide.gemm(x[sl], w, b, dims, S, **one_kw)
            if not torch.equal(wide.gemm_sum(y1, plan, N), got[sl]):
                raise AssertionError(f'product {tag}: env 3 of the N=8 launch differs '
                                     'from its one-env launch')
        out = torch.empty_like(y)
        kern = (lambda: wide.gemm(x, w, b, dims, S, **kw, out=out))
        wl = w[0] if w.dim() == 3 else w
        xl = x[:, :K]
        lib = (lambda: torch.matmul(xl, wl.t()))
        reps = 10 if R * K * N < 2e10 else 5
        ms = [time_ms(kern, reps), time_ms(lib, reps), time_ms(lib, reps), time_ms(kern, reps)]
        k_ms, l_ms = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
        _, _, top = device_share(kern, 3)
        k_dev = sum(t for t, _, k in top if 'gemm_kernel' in k) or None
        l_dev = device_share(lib, 3)[0]
        p_ms = time_ms(lambda: plain(x, w, b, kw, S, K, N), 2)
        heads_used = 1 if kw['head'] is None else len(set(kw['head'][:, 0].tolist()))
        by = R * K * 2 + heads_used * N * K * 2 + R * N * 4 + nbytes(b)
        b_ms, b_by = bound_ms(by, 2 * R * K * N, BF16_FLOPS)
        rec = dict(shape=label, model=317 if dims is WIDE_DIMS else 5, n_envs=n, rows=R, K=K,
                   N=N, plan=plan, max_abs_err=err, tol_used=over, ms=k_ms, device_ms=k_dev,
                   library_ms=l_ms, library_device_ms=l_dev, plain_ms=p_ms, bound_ms=b_ms,
                   bound_by=b_by)
        records.append(rec)
        log(f'  product {tag}: K={K} N={N}, tile {plan["bm"]}x{plan["bn"]}, {plan["splits"]} '
            f'split(s), grid {plan["grid"]}; max |err| {err:.3g} ({over:.3f} of the '
            f'tolerance); kernel {k_ms:.4f} ms (device {k_dev}), torch.matmul '
            f'{l_ms:.4f} ms (device {l_dev}), plain {p_ms:.3f} ms, bound {b_ms:.5f} ms '
            f'({b_by}): {100 * b_ms / k_ms:.1f}% of the bound, {k_ms / l_ms:.2f}x cuBLAS')
        del x, w, b, y, got, want, room, out
    return records, worst


# A value step's folded first layer (step 0, the latent one row an env),
# its two kernels alone (ops/wide.py fold_u, fold_hidden) at the 317M
# model's widths: the u product on FOLD_ENVS envs' latents, the fused layer
# on their 512 rows each; the kernels' line reports them at FOLD_HEADLINE.
FOLD_ENVS = (1, 8, 80)
FOLD_HEADLINE = 80
FOLD_TASKS = 80


def fold_operands(n, S, g):
    """A folded first layer's operands on n envs of S rows at WIDE_DIMS:
    the wide layout [M, Lp + Ap] (pads zero), the envs' latents zb [n, Lp],
    the z||a rows (latent columns NaN, A actions, zeros to Ap), a bias table
    of FOLD_TASKS rows, the envs' task ids (80 distinct ones at 80 envs),
    gain and beta."""
    import torch
    L, M, A = WIDE_DIMS[:3]
    Lp, Ap = -(-L // 16) * 16, -(-A // 16) * 16
    dev = g.device
    wT = (torch.randn(M, Lp + Ap, device=dev, generator=g) * L ** -0.5).to(torch.bfloat16)
    wT[:, L:Lp] = 0
    wT[:, Lp:] *= 3
    wT[:, Lp + A:] = 0
    zb = torch.randn(n, Lp, device=dev, generator=g).to(torch.bfloat16)
    zb[:, L:] = 0
    x = torch.full((n * S, Lp + Ap), float('nan'), device=dev, dtype=torch.bfloat16)
    x[:, Lp:] = 0
    x[:, Lp:Lp + A] = (torch.rand(n * S, A, device=dev, generator=g) * 2 - 1).to(torch.bfloat16)
    b0 = torch.randn(FOLD_TASKS, M, device=dev, generator=g) * 0.5
    task = ((torch.arange(n, device=dev) * 7 + 3) % FOLD_TASKS).to(torch.int32)
    gain = 1 + 0.2 * torch.randn(M, device=dev, generator=g)
    beta = 0.2 * torch.randn(M, device=dev, generator=g)
    return wT, zb, x, b0, task, gain, beta


def fold_phase():
    """The folded first layer's two kernels alone on the card, at each of
    FOLD_ENVS envs of 512 rows. The u product (fold_u): its partial rows
    summed in order against fold_u_plain within PRODUCT_RTOL of |zb| @ |Wz|,
    env 3 of N=8 its one-env launch's bit for bit; timed by CUDA events (in
    turns) and by its own device time beside torch.mm(zb, Wz.T,
    out_dtype=torch.float32) (the same product with the kernel's f32
    output) and torch.matmul (bf16 out), its plain version, and its bound
    (Wz read once, the latents, u written once; the multiply-adds at the
    bf16 peak). The fused layer
    (fold_hidden) on the n x 512 rows: against fold_hidden_plain within one
    bf16 step (tests/row_cases.py hold_rows), env 3 of N=8 its one-env
    launch's bit for bit; timed beside the pair it replaces on the same
    operands (the action product through gemm_kernel with u's rows plus the
    env's bias row as its bias, then row_kernel<256, 0>; its output held to
    the same band), its plain version, and its bound (the actions, the
    action block, u, the used bias rows, gain and beta read once, the bf16
    rows written; the f32 multiply-adds). Returns
    (the records, the largest share of a tolerance used, max |err|)."""
    import torch
    from tdmpc2_tpu_torch.ops import wide
    rc = row_cases()
    dims, S, dev = WIDE_DIMS, 512, torch.device('cuda')
    L, M, A = dims[:3]
    Lp, Mp = -(-L // 16) * 16, -(-M // 16) * 16
    g = torch.Generator(device=dev).manual_seed(SEED + 1392)
    records, worst = [], (0.0, 0.0)
    for n in FOLD_ENVS:
        R = n * S
        wT, zb, x, b0, task, gain, beta = fold_operands(n, S, g)
        Wz, Wa, xa = wT[:, :Lp], wT[:, Lp:], x[:, Lp:]
        # the u product
        tag = f'fold: u product, {n} env(s)'
        u, plan = wide.fold_u(zb, Wz, dims)
        got = u[0].clone()
        for k in range(1, plan['splits']):
            got += u[k]
        want = wide.fold_u_plain(zb, Wz)
        room = PRODUCT_RTOL * (zb.float().abs() @ Wz.float().abs().T) + PRODUCT_ATOL
        err, use = max_err(got, want), float(((got - want).abs() / room).max())
        if not bool(torch.isfinite(got).all()) or use > 1:
            raise AssertionError(f'{tag}: max |err| {err:.3g}, {use:.3f} of the tolerance '
                                 f'(plan {plan})')
        worst = (max(worst[0], use), max(worst[1], err))
        if n == 8:
            u1, _ = wide.fold_u(zb[3:4], Wz, dims)
            if not torch.equal(u1, u[:, 3:4]):
                raise AssertionError(f'{tag}: env 3 differs from its one-env launch')
        uo = torch.empty(wide.FOLD_SPLITS, n, Mp, device=dev)
        kern = (lambda: wide.fold_u(zb, Wz, dims, out=uo))
        mm = (lambda: torch.mm(zb, Wz.t(), out_dtype=torch.float32))
        mat = (lambda: torch.matmul(zb, Wz.t()))
        t = [time_ms(f, 20) for f in (kern, mm, mat, mat, mm, kern)]
        k_ms, mm_ms, mat_ms = (t[0] + t[5]) / 2, (t[1] + t[4]) / 2, (t[2] + t[3]) / 2
        _, _, top = device_share(kern, 10)
        k_dev = sum(t_ for t_, _, k in top if 'fold_u_kernel' in k) or None
        mm_dev, mat_dev = device_share(mm, 10)[0], device_share(mat, 10)[0]
        p_ms = time_ms(lambda: wide.fold_u_plain(zb, Wz), 3)
        by = M * Lp * 2 + n * Lp * 2 + n * M * 4
        b_ms, b_by = bound_ms(by, 2 * n * Lp * M, BF16_FLOPS)
        log(f'  {tag}: {plan["splits"]} splits of {plan["kchunk"]} stages, {plan["ke"]} env '
            f'tile(s) a block, grid {plan["grid"]}; max |err| {err:.3g} ({use:.3f} of the '
            f'tolerance); kernel {k_ms:.4f} ms (device {k_dev}), torch.mm f32 out '
            f'{mm_ms:.4f} ms (device {mm_dev}), torch.matmul {mat_ms:.4f} ms (device '
            f'{mat_dev}), plain {p_ms:.3f} ms, bound {b_ms:.6f} ms ({b_by})'
            + (f': {100 * b_ms / k_dev:.1f}% of the bound, {k_dev / mm_dev:.2f}x torch.mm'
               if k_dev and mm_dev else ''))
        records.append(dict(kernel='fold_u', n_envs=n, rows=n, plan=plan, max_abs_err=err,
                            tol_used=use, ms=k_ms, device_ms=k_dev, library_ms=mm_ms,
                            library_device_ms=mm_dev, matmul_ms=mat_ms,
                            matmul_device_ms=mat_dev, plain_ms=p_ms, bound_ms=b_ms,
                            bound_by=b_by))
        # the fused layer
        tag = f'fold: fused action product + LayerNorm + Mish, {R} rows'

        def out():
            return torch.full((R, Mp + 16), float('nan'), device=dev, dtype=torch.bfloat16)
        hk, hp, hq = out(), out(), out()
        fplan = wide.fold_hidden(xa, Wa, u, b0, gain, beta, dims, S, task=task, dst=hk)
        wide.fold_hidden_plain(xa, Wa, u, b0, gain, beta, dims, S, hp, task=task)
        use, err = rc.hold_rows(tag, {'dst': hk}, {'dst': hp}, M)
        worst = (max(worst[0], use), max(worst[1], err))
        if n == 8:
            u1, _ = wide.fold_u(zb[3:4], Wz, dims)
            h1 = torch.full((S, Mp + 16), float('nan'), device=dev, dtype=torch.bfloat16)
            wide.fold_hidden(xa[3 * S:4 * S], Wa, u1, b0, gain, beta, dims, S,
                             task=task[3:4], dst=h1)
            if not torch.equal(h1.view(torch.int16), hk[3 * S:4 * S].view(torch.int16)):
                raise AssertionError(f'{tag}: env 3 differs from its one-env launch')
        # the pair it replaces: the action product with u's rows plus the
        # env's bias row as its bias (gemm_kernel), then LayerNorm + Mish of
        # its f32 rows (row_kernel)
        us = (got + b0[task.long()]).contiguous()
        env = torch.arange(n, device=dev, dtype=torch.int32)
        y = torch.empty(R, wide.y_width(dims), device=dev)

        def pair():
            wide.gemm(xa, Wa, us, dims, S, task=env, ntask=n, bt=us.stride(0), out=y)
            wide.rows('hidden', y, dims, S, gain=gain, beta=beta, dst=hq, dpad=Mp)
        pair()
        rc.hold_rows(f'{tag}, the product + row kernel pair', {'dst': hq}, {'dst': hp}, M)
        kern = (lambda: wide.fold_hidden(xa, Wa, u, b0, gain, beta, dims, S, task=task,
                                         dst=hk))
        reps = 20 if R <= 4096 else 10
        t = [time_ms(f, reps) for f in (kern, pair, pair, kern)]
        k_ms, pair_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        _, _, top = device_share(kern, reps)
        k_dev = sum(t_ for t_, _, k in top if 'fold_hidden_kernel' in k) or None
        _, _, ptop = device_share(pair, reps)
        g_dev = sum(t_ for t_, _, k in ptop if 'gemm_kernel' in k) or None
        r_dev = sum(t_ for t_, _, k in ptop if 'row_kernel' in k) or None
        p_ms = time_ms(lambda: wide.fold_hidden_plain(xa, Wa, u, b0, gain, beta, dims, S, hp,
                                                      task=task), 2)
        by = (R * A * 2 + M * A * 2 + n * M * 4 + len(set(task.tolist())) * M * 4
              + 2 * M * 4 + R * Mp * 2)
        b_ms, b_by = bound_ms(by, 0, BF16_FLOPS, 2 * R * M * A)
        pair_dev = (g_dev + r_dev) if g_dev and r_dev else None
        log(f'  {tag}: plan {fplan}; max |err| {err:.3g} ({use:.3f} of the band); kernel '
            f'{k_ms:.4f} ms (device {k_dev}), the pair it replaces {pair_ms:.4f} ms (device: '
            f'product {g_dev}, row kernel {r_dev}), plain {p_ms:.3f} ms, bound {b_ms:.6f} ms '
            f'({b_by})' + (f': {100 * b_ms / k_dev:.1f}% of the bound, {pair_dev / k_dev:.2f}x '
                           'faster than the pair' if k_dev and pair_dev else ''))
        records.append(dict(kernel='fold_hidden', n_envs=n, rows=R, plan=fplan,
                            max_abs_err=err, tol_used=use, ms=k_ms, device_ms=k_dev,
                            pair_ms=pair_ms, pair_product_device_ms=g_dev,
                            pair_row_device_ms=r_dev, plain_ms=p_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=None))
        del wT, zb, x, u, hk, hp, hq, y, uo
    return records, worst


def fold_rows(records):
    """The two fold kernels' lines for the kernels' JSON line, from
    fold_phase's records: their numbers at FOLD_HEADLINE envs, every size's
    records beside them."""
    rows = []
    for kernel, name in (('fold_u', 'wide_fold_u'), ('fold_hidden', 'wide_fold_hidden')):
        mine = [r for r in records if r['kernel'] == kernel]
        top = next(r for r in mine if r['n_envs'] == FOLD_HEADLINE)
        rows.append({
            'name': name, 'route': 'cuda', 'engine': 'wide',
            'source': 'tdmpc2_tpu_torch/csrc/mlp_wide.cuh',
            'replaces': 'tdmpc2_tpu/ops/pallas_rollout.py:437', 'launches': 0,
            'headline': f'{top["rows"]} rows' if kernel == 'fold_hidden'
                        else f'{top["n_envs"]} envs',
            'max_abs_err': max(r['max_abs_err'] for r in mine),
            **{k: top[k] for k in ('ms', 'device_ms', 'plain_ms', 'bound_ms', 'bound_by',
                                   'library_ms')},
            'sizes': mine})
    return rows


# The row kernel alone (ops/wide.py rows, the library's tdm_wide_rows) at the
# 317M model's widths: each template (tests/row_cases.py ROW_CASES) on the
# rows of one env (512), the pi rollout at N=80 x 24 (1,920), N=8 (4,096)
# and N=80 tasks (40,960).
ROW_ROWS = ((512, 512), (1920, 24), (4096, 512), (40960, 512))
ROW_HEADLINE = ('LayerNorm + Mish', 40960)
# SimNorm's other groups (the row kernel's runtime group), held at 512 rows.
ROW_GROUPS = (2, 4, 16)


def row_cases():
    """tests/row_cases.py, loaded by its path: the row kernel's cases, their
    operands and the check against rows_plain, one copy shared with the
    card tests."""
    import importlib.util
    if 'row_cases' not in sys.modules:
        path = Path(__file__).resolve().parent / 'tests' / 'row_cases.py'
        spec = importlib.util.spec_from_file_location('row_cases', path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules['row_cases'] = mod
    return sys.modules['row_cases']


def row_bytes(mode, R, kw):
    """(the function's bytes, the bytes as launched): each input read once
    and each output written once; the launch reads the split product's 8
    partial rows where the function reads one row."""
    from tdmpc2_tpu_torch.ops import wide
    ncols = wide.row_width(mode, WIDE_DIMS)
    small = sum(nbytes(kw[k]) for k in ('gain', 'beta', 'bins', 'head', 'discs', 'amask')
                if kw.get(k) is not None)
    scal = {'reward': 4 * 3, 'q0': 4, 'q1': 4 * 4, 'term': 4 * 4}
    if mode in ('hidden', 'latent'):    # bf16 rows out, and f32 where given
        rest = R * kw['dpad'] * 2 + (R * ncols * 4 if kw.get('fdst') is not None else 0)
    elif mode == 'pi':
        A = ncols // 2
        rest = R * (A * 4 + A * 4 + kw['dpad'] * 2)    # eps in, f32 and bf16 actions out
    else:
        rest = R * scal[mode]
    fn = R * ncols * 4 + rest + small
    return fn, fn + (kw['nsplit'] - 1) * R * ncols * 4


def row_phase():
    """The row kernel alone on the card: each ROW_CASES template
    (tests/row_cases.py) at the rows of ROW_ROWS, through ops/wide.py rows
    (the library's tdm_wide_rows), held against rows_plain on the same
    operands (hold_rows; the latent's f32 rows too), each env of an N=8
    launch against its one-env launch bit for bit; timed by CUDA events,
    its own device time by torch.profiler, the plain version's time and,
    for the LayerNorm templates, torch.nn.functional.layer_norm on the same
    f32 rows (contiguous) as a yardstick (a part of the function only: it
    writes f32); both bounds (row_bytes). Then the LayerNorm + SimNorm
    row at SimNorm's other groups (ROW_GROUPS, the kernel's runtime group)
    on 512 rows, held alone. Returns (records, (the largest tolerance share
    used, the largest |err|))."""
    import torch
    from tdmpc2_tpu_torch.ops import wide
    rc = row_cases()
    row_operands, row_clone, row_outputs, hold_rows = (
        rc.row_operands, rc.row_clone, rc.row_outputs, rc.hold_rows)
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(SEED + 1376)
    records, worst = [], (0.0, 0.0)
    for R, S in ROW_ROWS:
        N = R // S
        for label, mode, heads in rc.ROW_CASES:
            kw, per_row, per_env = row_operands(mode, R, S, g, WIDE_DIMS, heads,
                                                fdst=mode == 'latent')
            tag = f'{label}, {R} rows'
            got, want = row_clone(kw, per_row, per_env), row_clone(kw, per_row, per_env)
            plan = wide.rows(mode, got.pop('y'), WIDE_DIMS, S, **got)
            wide.rows_plain(mode, want.pop('y'), WIDE_DIMS, S, **want)
            torch.cuda.synchronize()
            use, err = hold_rows(tag, row_outputs(mode, got), row_outputs(mode, want),
                                 kw.get('dpad', 0))
            worst = (max(worst[0], use), max(worst[1], err))
            if N == 8:
                for e in (0, 5):
                    one = row_clone(kw, per_row, per_env, e, S)
                    wide.rows(mode, one.pop('y'), WIDE_DIMS, S, **one)
                    sl = slice(e * S, (e + 1) * S)
                    for k, x in row_outputs(mode, one).items():
                        if not torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                                           else x, (got[k][sl].view(torch.int16)
                                                    if x.dtype == torch.bfloat16
                                                    else got[k][sl])):
                            raise AssertionError(f'row kernel {tag}: env {e} of the N=8 '
                                                 f'launch differs from its one-env launch')
            # times: the main path's launch (the latent without its f32 rows)
            if mode == 'latent':
                kw['fdst'] = None
            run = row_clone(kw, per_row, per_env)
            y = run.pop('y')
            kern = (lambda: wide.rows(mode, y, WIDE_DIMS, S, **run))
            reps = 20 if R <= 4096 else 10
            k_ms = time_ms(kern, reps)
            _, _, top = device_share(kern, reps // 2)
            k_dev = sum(t for t, _, k in top if 'row' in k and 'kernel' in k) or None
            pl = row_clone(kw, per_row, per_env)
            yp = pl.pop('y')
            p_ms = time_ms(lambda: wide.rows_plain(mode, yp, WIDE_DIMS, S, **pl), 2)
            ln_ms = None
            if mode in ('hidden', 'latent'):
                ncols = wide.row_width(mode, WIDE_DIMS)
                yc = y[:, :ncols].contiguous()
                gn = run['gain'] if run['gain'].dim() == 1 else run['gain'][0]
                bt = run['beta'] if run['beta'].dim() == 1 else run['beta'][0]
                ln_ms = time_ms(lambda: torch.nn.functional.layer_norm(
                    yc, (ncols,), gn, bt, 1e-5), reps)
                del yc
            fn_by, run_by = row_bytes(mode, R, kw)
            b_fn = fn_by / HBM_BYTES_PER_S * 1e3
            b_run = run_by / HBM_BYTES_PER_S * 1e3
            rec = dict(template=label, mode=mode, rows=R, n_envs=N, plan=plan, tol_used=use,
                       max_abs_err=err, ms=k_ms, device_ms=k_dev, plain_ms=p_ms, layer_norm_ms=ln_ms,
                       bound_ms=b_fn, bound_launched_ms=b_run, bound_by='bytes')
            records.append(rec)
            log(f'  row kernel {tag}: plan {plan}; {use:.3f} of the tolerance; kernel '
                f'{k_ms:.4f} ms (device {k_dev}), plain {p_ms:.3f} ms'
                + (f', F.layer_norm alone {ln_ms:.4f} ms' if ln_ms is not None else '')
                + f'; bound {b_fn:.5f} ms (bytes; {b_run:.5f} as launched): '
                + (f'{100 * b_fn / k_dev:.1f}% of the bound' if k_dev else 'no device time'))
            del kw, got, want, run, y, pl, yp
    for G_ in ROW_GROUPS:
        dims = WIDE_DIMS[:5] + (G_,) + WIDE_DIMS[6:]
        kw, per_row, _ = row_operands('latent', 512, 512, g, dims, fdst=True)
        got, want = row_clone(kw, per_row, []), row_clone(kw, per_row, [])
        plan = wide.rows('latent', got.pop('y'), dims, 512, **got)
        wide.rows_plain('latent', want.pop('y'), dims, 512, **want)
        use, err = hold_rows(f'LayerNorm + SimNorm of group {G_}',
                             row_outputs('latent', got), row_outputs('latent', want),
                             kw['dpad'])
        worst = (max(worst[0], use), max(worst[1], err))
        records.append(dict(template=f'LayerNorm + SimNorm, group {G_}', mode='latent',
                            rows=512, n_envs=1, plan=plan, tol_used=use, max_abs_err=err))
        log(f'  row kernel LayerNorm + SimNorm of group {G_}, 512 rows: plan {plan}; '
            f'{use:.3f} of the tolerance, max |err| {err:.3g}')
    return records, worst


def packed_bytes(prep):
    """Bytes that the fragment-packed copies (ops/value.py pack_matrix:
    each K block and N padded to 16, bf16) of prep's matrices take."""
    def up(n):
        return -(-n // 16) * 16
    from tdmpc2_tpu_torch.ops import value
    total = 0
    for k, parts in value.PACKED.items():
        if all(q in prep for q in parts):
            blocks = [prep[q] for q in parts]
            lead = math.prod(blocks[0].shape[:-2])
            if k == 'pP2':      # stacked along N
                kp, np_ = up(blocks[0].shape[-2]), up(sum(b.shape[-1] for b in blocks))
            else:
                kp, np_ = sum(up(b.shape[-2]) for b in blocks), up(blocks[0].shape[-1])
            total += 2 * lead * kp * np_
    return total


# The wide engine's row kernel at the 317M model, by the template the
# profiler names (threads a row): its modes in a value step and the bytes
# its function must move on R rows (an f32 product row read once and a
# bf16 row written; the per-row scalars). The K-split partial rows that the
# narrow outputs' row kernels read are this design's cost, not the
# function's, and are not charged: the product's bound does not charge
# their writes either.
def row_kernel_bytes(R):
    """{template: (modes, launches a non-episodic value step, least bytes
    a launch)} at model_size 317 (M 4096, L 1376, 101 bins, A 6)."""
    M, L, B, A = 4096, 1376, 101, 6
    two_hot = R * (B * 4 + 3 * 4)              # the row, G or q in and out
    pi = R * (2 * A * 4 + A * 4 + 16 * 2)      # the row, eps, bf16 actions
    return {'row_kernel<256, 0>': ('LayerNorm + Mish', 18, R * M * (4 + 2)),
            'row_kernel<128, 8>': ('LayerNorm + SimNorm', 3, R * L * (4 + 2)),
            'row_narrow_kernel<16>': ('two-hot decode', 5, two_hot),
            'row_narrow_kernel<8>': ('pi head', 1, pi)}


# The wide engine's staging (csrc/mlp_wide.cuh stage_kernel) alone, at the
# value step's rows (N envs of 512 at N = 1, 8, 80), in each mode its
# launches take: step t = 0 with the latent broadcast over an env's rows
# (zs = 0: the pi rollout's staging, and the value step's unless folded)
# or a latent per row (zs != 0), a later step's actions alone, and the
# folded t = 0 launch (the actions, each env's one latent into zb).
STAGE_ROWS = (512, 4096, 40960)
STAGE_MODES = ('latent, broadcast', 'latent, per row', 'actions', 'folded')
STAGE_PI = 24              # policy-prior rows an env (num_pi_trajs)
STAGE_HEADLINE = 40960


def stage_bytes(mode, R, N, L, A, n_pi=STAGE_PI):
    """The bytes one staging launch in `mode` (STAGE_MODES) must move on N
    envs of R / N rows: the rows' action columns written (bf16, padded to
    16), each row's A noise or policy-prior values read and its sampled
    actions written (f32), each env's mean, std and mask read; at t = 0
    the four per-row scalars zeroed and the latent: an env's one row read
    (broadcast, folded) or a row each (per row), written into every row's
    latent columns (bf16, padded to 16), or into the env's row of zb
    (folded)."""
    Lp, Ap = -(-L // 16) * 16, -(-A // 16) * 16
    acts = R * (Ap * 2 + 2 * A * 4) + N * 3 * A * 4
    if mode == 'actions':
        return acts
    first = acts + R * 4 * 4
    if mode == 'folded':
        return first + N * L * 4 + N * Lp * 2
    return first + R * Lp * 2 + (R if mode == 'latent, per row' else N) * L * 4


def step_stage_bytes(R, N, L, A, H, folded):
    """A value step's staging bytes a launch, on average over its H
    launches: t = 0 folded or with the broadcast latent, then the actions."""
    first = stage_bytes('folded' if folded else 'latent, broadcast', R, N, L, A)
    return (first + (H - 1) * stage_bytes('actions', R, N, L, A)) / H


def stage_alone(dims, S, mode, z0, mean, std, noise, pi_acts, amask):
    """The wide engine's staging alone (ops/wide.py stage, the library's
    tdm_wide_stage), one launch in `mode` (STAGE_MODES) on a sampled value
    step's inputs (N envs of S rows, z0 [N, S, L] broadcast or per row),
    held against stage_plain on the same inputs bit for bit: the z||a rows
    (NaN wherever nothing is written: past the padded widths, and the
    latent columns of a folded or later step), the f32 actions (the other
    steps' columns NaN), G, q, term and term_at zeroed at t = 0, zb when
    folded; at N = 8 env 5's rows against its one-env launch.
    Timed by CUDA events and by its own device time, beside stage_plain,
    against the bytes its function must move (stage_bytes). Returns the
    record."""
    import torch
    from tdmpc2_tpu_torch.ops import wide
    L, A, H = dims[0], dims[2], dims[6]
    N, dev = mean.shape[0], mean.device
    R, Lp = N * S, -(-L // 16) * 16
    width = Lp + -(-A // 16) * 16
    t, fold = (1 if mode == 'actions' else 0), mode == 'folded'

    def outputs(n):
        def nan(*shape, dtype=torch.float32):
            return torch.full(shape, float('nan'), device=dev).to(dtype)
        o = dict(x=nan(n * S, width + 16, dtype=torch.bfloat16), acts=nan(n, S, H * A))
        if t == 0:
            o.update(G=nan(n * S), q=nan(n * S), term=nan(n * S),
                     term_at=torch.full((n * S,), -1, dtype=torch.int32, device=dev))
        if fold:
            o.update(zb=nan(n, Lp, dtype=torch.bfloat16))
        return o

    def run(fn, o, e=None):
        sel = (lambda v: v) if e is None else (lambda v: v[e:e + 1])
        kw = {k: v for k, v in o.items() if k not in ('x', 'acts')}
        fn(dims, S, t, sel(z0), sel(mean), sel(std), sel(noise), sel(pi_acts), sel(amask),
           o['x'], o['acts'], load_z=t == 0, **kw)

    def bits(v):
        return v.view(torch.int16) if v.element_size() == 2 else v.view(torch.int32)

    tag = f'staging alone, {mode}, {N} x {S} rows'
    got, want = outputs(N), outputs(N)
    n0 = wide.stage.launches
    run(wide.stage, got)
    run(wide.stage_plain, want)
    torch.cuda.synchronize()
    if wide.stage.launches != n0 + 1:
        raise AssertionError(f'{tag}: {wide.stage.launches - n0} launches counted, 1 expected')
    for k in got:
        if not torch.equal(bits(got[k]), bits(want[k])):
            fin = torch.isfinite(want[k].float())
            raise AssertionError(f'{tag}: {k} differs from stage_plain\'s, max |err| '
                                 f'{max_err(got[k][fin], want[k][fin]):.3g}')
    if N == 8:
        one = outputs(1)
        run(wide.stage, one, 5)
        pairs = [('x', got['x'][5 * S:6 * S]), ('acts', got['acts'][5:6])]
        if fold:
            pairs.append(('zb', got['zb'][5:6]))
        for k, v in pairs:
            if not torch.equal(bits(one[k]), bits(v)):
                raise AssertionError(f'{tag}: env 5 of the N=8 launch differs from its '
                                     f'one-env launch ({k})')
    o, p = outputs(N), outputs(N)
    reps = 50 if R <= 4096 else 20
    ms = time_ms(lambda: run(wide.stage, o), reps)
    _, _, top = device_share(lambda: run(wide.stage, o), reps // 2)
    dev_ms = sum(t_ for t_, _, k in top if 'stage_kernel' in k) or None
    plain_ms = time_ms(lambda: run(wide.stage_plain, p), 3)
    b_ms = stage_bytes(mode, R, N, L, A, pi_acts.shape[1]) / HBM_BYTES_PER_S * 1e3
    log(f'  {tag}: bit for bit; kernel {ms:.4f} ms (device {dev_ms}), plain '
        f'{plain_ms:.3f} ms; bound {b_ms:.5f} ms (bytes): '
        + (f'{100 * b_ms / dev_ms:.1f}% of the bound' if dev_ms else 'no device time'))
    return dict(mode=mode, rows=R, n_envs=N, max_abs_err=0.0, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by='bytes')


def stage_phase():
    """The staging alone (stage_alone) in each of STAGE_MODES at each of
    STAGE_ROWS (N envs of 512 rows), on seeded inputs in the value step's
    form: the latent one row an env (broadcast) or one a row, the noise a
    strided view, STAGE_PI policy-prior rows, a mask row per env. Returns
    the records."""
    import torch
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(SEED + 2784)
    dims, S = WIDE_DIMS, 512
    L, A, H = dims[0], dims[2], dims[6]
    records = []
    for R in STAGE_ROWS:
        N, HA = R // S, H * A
        z = torch.randn(N, 1, L, device=dev, generator=g)
        z_rows = torch.randn(N, S, L, device=dev, generator=g)
        mean = torch.rand(N, HA, device=dev, generator=g) * 1.6 - 0.8
        std = torch.rand(N, HA, device=dev, generator=g) * 1.9 + 0.1
        noise = torch.randn(N, 2, S, HA, device=dev, generator=g)[:, 0]
        pi_acts = torch.rand(N, STAGE_PI, HA, device=dev, generator=g) * 2 - 1
        amask = (torch.rand(N, A, device=dev, generator=g) < 0.8).float()
        for mode in STAGE_MODES:
            z0 = z_rows if mode == 'latent, per row' else z.expand(N, S, L)
            records.append(stage_alone(dims, S, mode, z0, mean, std, noise, pi_acts, amask))
        del z_rows, noise
    return records


def stage_headline(records, H=WIDE_DIMS[6]):
    """The staging's numbers for the kernels' line: a value step's H
    launches on average at STAGE_HEADLINE rows (the folded t = 0 launch,
    then H - 1 of the actions alone), from stage_phase's records."""
    at = {r['mode']: r for r in records if r['rows'] == STAGE_HEADLINE}
    out = {}
    for k in ('ms', 'device_ms', 'plain_ms', 'bound_ms'):
        v = (at['folded'][k], at['actions'][k])
        out[k] = None if None in v else (v[0] + (H - 1) * v[1]) / H
    return dict(out, bound_by='bytes', max_abs_err=max(r['max_abs_err'] for r in records),
                headline=f'a value step\'s {H} stagings on average, {STAGE_HEADLINE} rows '
                         '(the folded t = 0 launch, then the actions alone)')


def stage_only() -> int:
    """`--stage`: the build, then the staging alone (stage_phase), the
    folded first layer's two kernels (fold_phase) and the z||a product the
    fold replaces at t = 0 (product_phase), for a quick check of them on the
    card; prints the card and the records."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    from tdmpc2_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    for name, (secs, _) in _build.build().items():
        log(f'  {name}.cu built in {secs:.1f} s')
    for fn, (regs, st, ld) in _build.ptxas_usage(_build.ptxas_report('value')).items():
        if 'stage' in fn:
            log(f'    value.cu {fn}: {regs} registers, {st} bytes spill stores, '
                f'{ld} bytes spill loads')
    with Phase('the wide engine\'s staging alone against stage_plain'):
        records = stage_phase()
    with Phase('the folded first layer\'s two kernels alone (the u product; the fused '
               'action product + LayerNorm + Mish), beside what they replace'):
        folds, worst = fold_phase()
        log(f'  largest share of a tolerance used: {worst[0]:.3f}, max |err| {worst[1]:.3g}')
    with Phase('the z||a product the fold replaces at t = 0'):
        products, _ = product_phase(only=('z||a -> M',))
    log(nvidia_smi_line())
    log(json.dumps({'stage': records, 'fold': folds, 'products': products}))
    return 0


def wide_bounds(prep, n, S, H, A, n_pi, used_heads, episodic=False, task_rows=1):
    """The card's least time for the planner's steps at the prep's widths
    for n envs: {'value_sampled': (ms, by), 'pi_rollout': ..., 'rollout':
    ...}: every distinct weight read once (the used Q heads only, a bias
    row per task), each input and output once, every multiply-add of the
    rows."""
    L, M = prep['dWz'].shape
    B = prep['rW2'].shape[1]
    HA = H * A
    mac_rew = (L + A) * M + M * M + M * B
    mac_dyn = (L + A) * M + M * M + M * L
    mac_pi = L * M + M * M + 2 * M * A
    mac_term = L * M + M * M + M
    w = {k: nbytes(prep[k]) for k in prep if k[0] in 'drpt' and k[1] == 'T'}
    q1 = sum(nbytes(prep[k][0]) for k in ('qT0', 'qT1', 'qT2') if k in prep)
    vecs = 4 * (6 * M + L + B) * task_rows
    w_step = sum(v for k, v in w.items() if k[0] in 'drp' or episodic) + used_heads * q1
    mac_step = mac_rew + mac_dyn + (mac_term if episodic else 0)
    value_by = (w_step + vecs + n * (L * 4 + 2 * HA * 4 + (S - n_pi) * HA * 4
                                     + n_pi * HA * 4 + S * A * 4 + S * 4 + S * HA * 4))
    pi_by = (sum(v for k, v in w.items() if k[0] in 'dp') + vecs
             + n * (L * 4 + 2 * n_pi * HA * 4))
    ro_by = (sum(v for k, v in w.items() if k[0] in 'dr') + vecs
             + n * S * (L * 4 + HA * 4 + 4 + L * 4))
    return {
        'value_sampled': bound_ms(value_by, 2 * n * S * (H * mac_step + mac_pi + 2 * mac_rew),
                                  BF16_FLOPS, 3 * n * S * HA),
        'pi_rollout': bound_ms(pi_by, 2 * n * n_pi * (H * mac_pi + (H - 1) * mac_dyn),
                               BF16_FLOPS),
        'rollout': bound_ms(ro_by, 2 * n * S * H * (mac_rew + mac_dyn), BF16_FLOPS)}


def wide_phases(zero_counts, read_counts, check_plan_counts, update_records):
    """The 317M model on the card: mt80 at model_size 317 (80 tasks, task_dim
    96, mlp_dim 4096, latent 1376, 8 Q heads), where the value step, the pi
    rollout and the rollout take the layer-per-launch engine (ops/wide.py).
    Returns (max |err| of each check, {path: launch counts}, the wide
    route's rows of the JSON line).

    - the value step (given actions; episodic under the gate rule, its flips
      allowed within the logit spread of two plain versions, the CPU's and
      the card's), the sampled step (exactly the given-actions launch on its
      actions), the pi rollout (its launch held at each step on its own
      inputs, at one env, N=8 and N=80 tasks; its free-running distance from
      the plain rollout logged beside two plain versions') and the rollout
      against their plain versions at one env and N=8 tasks; N=80 tasks
      against 80 one-task launches bit for bit;
    - `act_tasks` over the 80 tasks: its graph against the eager body;
    - offline mt80 training (`OfflineTrainer`, env=None) on seeded chunks of
      the mt80 dataset's geometry, then `act_tasks` over the 80 tasks;
    - each kernel's time against its bound and its plain version's.
    """
    import types

    import numpy as np
    import torch
    from tdmpc2_tpu_torch.config import load_cfg
    from tdmpc2_tpu_torch.data.buffer import Buffer
    from tdmpc2_tpu_torch.models import layers
    from tdmpc2_tpu_torch.models.layers import simnorm
    from tdmpc2_tpu_torch.ops import cem, rollout, value, wide
    from tdmpc2_tpu_torch.tdmpc2 import PLAN_WRAPPERS, TDMPC2
    from tdmpc2_tpu_torch.trainer.offline import OfflineTrainer
    from tdmpc2_tpu_torch.utils import tree
    from tdmpc2_tpu_torch.utils.cuda_graph import Graph
    from tdmpc2_tpu_torch.utils.logger import Logger
    dev = torch.device('cuda')
    errs, paths, rows = {}, {}, []
    NT = len(MT80_ACTION_DIMS)
    tag = f'model_size {WIDE_SIZE}'

    with Phase(f'wide engine at {tag}, mt80 ({NT} tasks): the planner\'s kernels vs plain '
               f'at one env and N={len(WIDE_TASKS)} tasks, N={NT} vs {NT} one-task launches, '
               'the rollout, the plan\'s graph'):
        t0 = time.perf_counter()
        cfg = mt30_cfg(load_cfg, model_size=WIDE_SIZE, task='mt80')
        ag = TDMPC2(cfg, device='cuda')
        wg = torch.Generator().manual_seed(SEED + WIDE_SIZE)
        ag.load_params(perturbed(ag.model.init(wg), wg, sweep_scale(cfg.mlp_dim)))
        prep = ag.prep
        H, S, A, L = cfg.horizon, cfg.num_samples, cfg.action_dim, cfg.latent_dim
        M, n_pi, HA, I = cfg.mlp_dim, cfg.num_pi_trajs, cfg.horizon * cfg.action_dim, ag.iterations
        heads = dict(log_std_min=ag.model.log_std_min,
                     log_std_dif=ag.model.log_std_dif, simnorm_dim=cfg.simnorm_dim)
        n_par = sum(x.numel() for x in tree.leaves(ag.params))
        plans = {k: value.kernel_plan(prep, cfg.simnorm_dim, H, k, rows)
                 for k, rows in (('value', S), ('pi_rollout', n_pi))}
        # the prep's bytes, and what they were with the fragment-packed
        # copies the wide engine read before it read the wide layout
        wide_by = nbytes(*[prep[k] for k in value.WIDE if k in prep])
        prep_by = nbytes(*prep.values())
        packed_by = packed_bytes(prep)
        log(f'  the prep holds {prep_by / 2**20:.1f} MiB, {wide_by / 2**20:.1f} MiB of them '
            f'the wide layout and none fragment-packed; with the packed copies in its place, '
            f'as the first wide engine read them, {(prep_by - wide_by + packed_by) / 2**20:.1f} '
            'MiB')
        if any(k in prep for k in value.PACKED):
            raise AssertionError(f'{tag}: the prep holds fragment-packed copies')
        log(f'  {n_par:,} parameters (L={L}, M={M}, num_q={cfg.num_q}, task_dim '
            f'{cfg.task_dim}, A={A}), built in {time.perf_counter() - t0:.1f} s; bias tables '
            f'{tuple(prep["db0"].shape)}, Q {tuple(prep["qb0"].shape)}; plans {plans}')
        if any(p['route'] != 'wide' or p['engine'] != 'wide' for p in plans.values()):
            raise AssertionError(f'{tag}: not the wide engine: {plans}')
        g = torch.Generator(device=dev).manual_seed(SEED + WIDE_SIZE)
        tt = torch.arange(NT, dtype=torch.int32, device=dev)
        amask = ag.amask[tt.long()].contiguous()
        discs = ag.discs[tt.long()]
        obs = torch.randn(NT, cfg.obs_shape['state'][0], device=dev, generator=g)
        obs *= torch.arange(obs.shape[1], device=dev) < torch.tensor(
            MT80_OBS_DIMS, device=dev)[:, None]
        z = ag.model.encode(ag.params, obs, tt.long())[:, None]
        noise = ag.draw_noise(NT)
        mean = torch.rand(NT, HA, device=dev, generator=g) * 1.6 - 0.8
        std = torch.rand(NT, HA, device=dev, generator=g) * 1.9 + 0.1
        given = (torch.rand(NT, H, S, A, device=dev, generator=g) * 2 - 1) * amask[:, None, None]
        pa = cem.pi_rollout(prep, z, noise.pi_eps[:, :n_pi], **heads, task=tt, amask=amask)

        def env_args(idx):
            sel = (lambda x: x[idx])
            v = (prep, sel(z).expand(len(idx), S, L), sel(given), sel(noise.eps[:, 0]),
                 sel(noise.qidx[:, 0]), sel(discs))
            vs = (prep, sel(z).expand(len(idx), S, L), sel(mean), sel(std),
                  sel(noise.sample[:, 0]), sel(pa), sel(amask), sel(noise.eps[:, 0]),
                  sel(noise.qidx[:, 0]), sel(discs))
            pi = (prep, sel(z), sel(noise.pi_eps[:, :n_pi]))
            return v, vs, pi, dict(task=sel(tt), amask=sel(amask))

        # the episodic model: a termination head at these widths beside the
        # same weights, spread and centred as the main phases' (split_termination)
        e_cfg = cfg.replace(episodic=True)
        e_params = dict(ag.params)
        e_params['termination'] = tree.map(
            lambda x: x.to(dev), perturbed(layers.mlp_init(
                wg, L + cfg.task_dim, [M, M], 1), wg, sweep_scale(M)))
        split_termination(types.SimpleNamespace(cfg=e_cfg, device=dev, params=e_params,
                                                discs=ag.discs), g)
        e_prep = value.prepare_value_params(e_params, e_cfg)
        sub = torch.tensor(WIDE_TASKS, device=dev)
        cases = {}
        for label, idx in (('one env', sub[:1]), (f'N={len(WIDE_TASKS)}', sub)):
            v, vs, pi, tk = env_args(idx)
            cases[label] = (v, vs, pi, tk)
            n = len(idx)
            errs['value_317'] = max(errs.get('value_317', 0.0), hold(
                f'{tag} value, {label}', value.value_estimate(*v, **heads, **tk),
                value.value_estimate_plain(*v, **heads, **tk), VALUE_TOL))
            # the sampled step: exactly sample_actions_plain and the
            # given-actions launch on its actions, and the plain step
            v_k, acts_k = value.value_sampled(*vs, **heads, task=tk['task'])
            hold(f'{tag} sampled actions, {label}', acts_k,
                 value.sample_actions_plain(*vs[2:7]), SAMPLE_TOL)
            if not torch.equal(v_k, value.value_estimate(
                    prep, vs[1], acts_k.view(n, S, H, A).permute(0, 2, 1, 3), *vs[7:],
                    **heads, **tk)):
                raise AssertionError(f'{tag}, {label}: the sampled launch differs from the '
                                     'given-actions launch on its actions')
            errs['value_sampled_317'] = max(errs.get('value_sampled_317', 0.0), hold(
                f'{tag} value sampled, {label}', v_k,
                value.value_sampled_plain(*vs, **heads, task=tk['task'])[0], VALUE_TOL))
            # the pi rollout: its launch held at each step on its own
            # inputs; with the latents written, bit for bit the launch without
            pa_k = cem.pi_rollout(*pi, **heads, **tk)
            own, e = pi_rollout_own_steps(f'{tag} pi_rollout, {label}', *pi, heads,
                                          tk['task'], tk['amask'])
            if not torch.equal(own, pa_k):
                raise AssertionError(f'{tag} pi_rollout, {label}: writing the latents changes '
                                     'the actions')
            errs['cem_pi_rollout_317'] = max(errs.get('cem_pi_rollout_317', 0.0), e)
            log_pi_drift(f'{tag} pi_rollout, {label}', pi, heads, tk, pa_k)
            # the episodic step: given actions under the gate rule, and the
            # sampled mode exactly against it
            ev = (e_prep,) + v[1:]
            k_at = torch.empty(n, S, dtype=torch.int32, device=dev)
            p_at = torch.empty_like(k_at)
            got = value.value_estimate(*ev, **heads, **tk, episodic=True, term_at=k_at)
            ref = value.value_estimate_plain(*ev, **heads, **tk, episodic=True, term_at=p_at)
            logits, _ = value.termination_trace_plain(*ev[:3], ev[5], cfg.simnorm_dim,
                                                      task=tk['task'])
            flips, bad = value.gate_check(got, ref, k_at, p_at, logits, **VALUE_TOL,
                                          near=GATE_NEAR)
            agree = (k_at == p_at)[..., None]
            e_err = max_err(got[agree], ref[agree])
            log(f'  {tag} value episodic, {label}: rows flagged by t=1..{H} (plain) '
                + ', '.join(f'{100 * x:.1f}%' for x in flag_shares(p_at, H))
                + f'; max |err| {e_err:.3g} on the {int(agree.sum())} rows whose flags '
                f'agree (band {VALUE_TOL}); {flips} flips with |logit| < {GATE_NEAR}, '
                f'{bad} rows outside the gate rule')
            if bad:
                # at 4096 columns a flip may fall where |logit| >= GATE_NEAR: it
                # is allowed where |logit| is within the spread of two plain
                # versions' logits (the CPU's, the card's) on these inputs
                cpu_prep = {k: x.cpu() for k, x in e_prep.items() if k[0] not in 'pq'}
                lc, _ = value.termination_trace_plain(
                    cpu_prep, ev[1].cpu(), ev[2].cpu(), ev[5].cpu(), cfg.simnorm_dim,
                    task=tk['task'].cpu())
                spread = max_err(lc, logits.cpu())
                flips, bad = value.gate_check(got, ref, k_at, p_at, logits, **VALUE_TOL,
                                              near=max(GATE_NEAR, spread))
                log(f'  two plain versions (CPU against the card), {label}: termination '
                    f'logits differ by up to {spread:.3g} (logit std '
                    f'{float(logits.std()):.3g}); at that spread {flips} flips, {bad} rows '
                    'outside the gate rule')
                if bad:
                    raise AssertionError(f'{tag} value episodic, {label}: {bad} rows outside '
                                         f'the gate rule at the plain spread {spread:.3g}')
            if flips > GATE_FLIP_SHARE * ref.numel():
                raise AssertionError(f'{tag} value episodic, {label}: {flips} flips')
            errs['value_sampled_episodic_317'] = max(
                errs.get('value_sampled_episodic_317', 0.0), e_err)
            hold_sampled(f'{tag} episodic, {label}', (e_prep,) + vs[1:], heads,
                         episodic=True, task=tk['task'], gate_rule=False)
            n8 = n
        # N=8 against 8 one-task launches, both branches
        v, vs, pi, tk = cases[f'N={n8}']
        for e_label, pr, kw in (('', prep, {}), (' episodic', e_prep, dict(episodic=True))):
            got = value.value_sampled(pr, *vs[1:], **heads, **kw, task=tk['task'])
            for i in range(n8):
                one = value.value_sampled(pr, *[x[i:i + 1] for x in vs[1:]], **heads, **kw,
                                          task=tk['task'][i:i + 1])
                if not all(torch.equal(a[i:i + 1], b) for a, b in zip(got, one)):
                    raise AssertionError(f'{tag}{e_label}: env {i} of the N={n8} launch '
                                         'differs from its one-env launch')
        log(f'  {tag}: the N={n8} sampled step (and its episodic branch) equals {n8} '
            'one-task launches bit for bit')
        # N=80 tasks: each launch against the plain sampling and the given-actions
        # launch exactly, and against 80 one-task launches bit for bit
        vs80 = (prep, z.expand(NT, S, L), mean, std, noise.sample[:, 0], pa, amask,
                noise.eps[:, 0], noise.qidx[:, 0], discs)
        v80, acts80 = value.value_sampled(*vs80, **heads, task=tt)
        hold(f'{tag} sampled actions, N={NT}', acts80,
             value.sample_actions_plain(*vs80[2:7]), SAMPLE_TOL)
        ref80 = value.value_estimate(prep, vs80[1], acts80.view(NT, S, H, A).permute(
            0, 2, 1, 3), *vs80[7:], **heads, task=tt, amask=amask)
        if not torch.equal(v80, ref80):
            raise AssertionError(f'{tag}: the N={NT} sampled launch differs from the '
                                 'given-actions launch on its actions')
        for i in range(NT):
            sl = slice(i, i + 1)
            one_pa = cem.pi_rollout(prep, z[sl], noise.pi_eps[sl, :n_pi], **heads,
                                    task=tt[sl], amask=amask[sl])
            one = value.value_sampled(*[x if x is prep else x[sl] for x in vs80], **heads,
                                      task=tt[sl])
            if not (torch.equal(pa[sl], one_pa) and torch.equal(v80[sl], one[0])
                    and torch.equal(acts80[sl], one[1])):
                raise AssertionError(f'{tag}: the N={NT} launch differs from task {i}\'s')
        # the pi rollout at the plan's shape (N=80 tasks of n_pi rows, H
        # steps): its launch held at each step on its own inputs
        pi80 = (prep, z, noise.pi_eps[:, :n_pi])
        own, e = pi_rollout_own_steps(f'{tag} pi_rollout, N={NT}', *pi80, heads, tt, amask)
        if not torch.equal(own, pa):
            raise AssertionError(f'{tag} pi_rollout, N={NT}: writing the latents changes the '
                                 'actions')
        errs['cem_pi_rollout_317'] = max(errs['cem_pi_rollout_317'], e)
        log_pi_drift(f'{tag} pi_rollout, N={NT}', pi80, heads, dict(task=tt, amask=amask), pa)
        masked = (torch.arange(A, device=dev) >= torch.tensor(
            MT80_ACTION_DIMS, device=dev)[:, None]).float()
        for name, x in (('policy rows', pa), ('sampled actions', acts80)):
            if float((x.reshape(NT, -1, H, A).abs() * masked[:, None, None]).max()) != 0:
                raise AssertionError(f'{tag}: {name} not 0 in masked columns')
        log(f'  {tag}: pi rollout and sampled value at N={NT} equal {NT} one-task '
            'launches bit for bit, the sampled launch equals the given-actions launch; '
            'masked columns 0')
        # the rollout (single-task: task 0's folded bias rows)
        prep_r = rollout.prepare_rollout_params(
            ag.params['dynamics'], ag.params['reward'], L, cfg.vmin, cfg.vmax,
            emb=value.task_embeddings(ag.params)[:1])
        r_args = (prep_r, simnorm(torch.randn(S, L, device=dev, generator=g), cfg.simnorm_dim),
                  given[0])
        r_kw = dict(horizon=H, discount=float(ag.discount[0]), simnorm_dim=cfg.simnorm_dim)
        Gk, zHk = rollout.rollout_prepared(*r_args, **r_kw)
        Gp, zHp = rollout.rollout_prepared_plain(*r_args, **r_kw)
        errs['rollout_317'] = max(hold(f'{tag} rollout G', Gk, Gp, ROLLOUT_TOL),
                                  hold(f'{tag} rollout z_H', zHk, zHp, ROLLOUT_TOL))
        # act_tasks: one graph replay against the eager body on the same draws
        obs_np = obs.cpu().numpy()
        tasks = np.arange(NT)
        a, pm = ag.act_tasks(obs_np, np.zeros((NT, H, A), np.float32), True, tasks)
        pm0 = pm.clone()
        ag.generator.manual_seed(SEED + 80)
        counts = [w.launches for w in PLAN_WRAPPERS]
        w0, replays = [c.launches for c in wide.COUNTERS], Graph.replays.get('plan', 0)
        a, pm = ag.act_tasks(obs_np, pm, False, tasks)
        launched = [w.launches - c for w, c in zip(PLAN_WRAPPERS, counts)]
        w_plan, g_plan, r_plan, s_plan, fu_plan, fh_plan = [
            c.launches - k for c, k in zip(wide.COUNTERS, w0)]
        pm_graph = pm.clone()
        pm.copy_(pm0)
        ag.generator.manual_seed(SEED + 80)
        a_e, _ = ag._plan_body(prep, obs, torch.zeros(NT, dtype=torch.bool, device=dev),
                               ag.draw_noise(NT), True, tt, pm)
        if (Graph.replays['plan'] != replays + 1 or launched != [1, I, I]
                or w_plan != wide.plan_launches(H, I, False)
                or g_plan != wide.plan_products(H, I, False)
                or s_plan != wide.plan_stagings(H, I)
                or fu_plan != wide.plan_folds(I) or fh_plan != wide.plan_folds(I)
                or r_plan != w_plan - g_plan - s_plan - fu_plan - fh_plan):
            raise AssertionError(f'{tag} act_tasks graph: launches {launched}, wide {w_plan}, '
                                 f'products {g_plan}, row kernels {r_plan}, stagings {s_plan}, '
                                 f'u products {fu_plan}, fused layers {fh_plan}')
        if not (np.array_equal(a, a_e.cpu().numpy()) and torch.equal(pm_graph, pm)):
            raise AssertionError(f'{tag} act_tasks graph: the replay differs from the eager '
                                 f'body (max |err| {max_err(torch.from_numpy(a), a_e.cpu()):.3g})')
        log(f'  act_tasks N={NT}: one replay ({launched} calls, {w_plan} launches of the '
            f'wide engine, {g_plan} of them products, {r_plan} row kernels, {s_plan} '
            f'stagings, {fu_plan} u products, {fh_plan} fused layers) equals the eager body '
            'bit for bit')

        # times and bounds (CUDA events; own device time by torch.profiler)
        used = len(set(noise.qidx[:, 0].flatten().tolist()))
        n8_used = len(set(cases[f'N={n8}'][1][8].flatten().tolist()))
        one_used = 2
        row_kernels = {}
        timed = {
            'value_sampled_317': (value.value_sampled, value.value_sampled_plain,
                                  lambda c: (c[1], dict(heads, task=c[3]['task'])),
                                  'value_sampled', False, 'tdmpc2_tpu_torch/csrc/value.cu',
                                  'tdmpc2_tpu/ops/pallas_rollout.py:437'),
            'value_sampled_episodic_317': (
                value.value_sampled, value.value_sampled_plain,
                lambda c: ((e_prep,) + c[1][1:], dict(heads, task=c[3]['task'], episodic=True)),
                'value_sampled', True, 'tdmpc2_tpu_torch/csrc/value.cu',
                'tdmpc2_tpu/ops/pallas_rollout.py:437'),
            'cem_pi_rollout_317': (cem.pi_rollout, cem.pi_rollout_plain,
                                   lambda c: (c[2], dict(heads, **c[3])), 'pi_rollout', False,
                                   'tdmpc2_tpu_torch/csrc/cem.cu',
                                   'tdmpc2_tpu/ops/pallas_cem.py:53')}
        for name, (kern, plain, pick, bkey, episodic, src, rpl) in timed.items():
            row = {'name': name, 'route': 'cuda', 'source': src, 'replaces': rpl,
                   'engine': 'wide', 'model_size': WIDE_SIZE, 'launches': None,
                   'max_abs_err': errs[name], 'n_envs': n8, 'library_ms': None}
            per_call = (wide.pi_rollout_launches(H) if bkey == 'pi_rollout'
                        else wide.value_launches(H, episodic))
            products = (wide.pi_rollout_products(H) if bkey == 'pi_rollout'
                        else wide.value_products(H, episodic))
            stagings = 1 if bkey == 'pi_rollout' else H
            folds = 0 if bkey == 'pi_rollout' else wide.value_folds(episodic=episodic)
            kinds_want = [products, per_call - products - stagings - 2 * folds, stagings, folds,
                          folds]
            runs = [('', cases[f'N={n8}'], n8, n8_used), ('_n1', cases['one env'], 1, one_used)]
            if not episodic:
                runs.append(('_n80', ((), vs80, (prep, z, noise.pi_eps[:, :n_pi]),
                                      dict(task=tt, amask=amask)), NT, used))
            for suffix, c, n, heads_used in runs:
                args, kw = pick(c)
                w0 = [c.launches for c in wide.COUNTERS]
                kern(*args, **kw)
                counted, *kinds = [c.launches - k for c, k in zip(wide.COUNTERS, w0)]
                if counted != per_call or kinds != kinds_want:
                    raise AssertionError(f'{name} (N={n}): {counted} device launches counted, '
                                         f'{per_call} expected; products, row kernels, '
                                         f'stagings, u products, fused layers {kinds}, '
                                         f'{kinds_want} expected')
                ms = time_ms(lambda: kern(*args, **kw), 10 if n < NT else 3)
                dev_ms, _, top = device_share(lambda: kern(*args, **kw), 3 if n < NT else 2,
                                              keep=12)
                plain_ms = (time_ms(lambda: plain(*args, **kw), 2) if n < NT else None)
                b_ms, b_by = wide_bounds(prep if not episodic else e_prep, n, S, H, A, n_pi,
                                         heads_used, episodic, NT)[bkey]
                row.update({f'ms{suffix}': ms, f'device_ms{suffix}': dev_ms,
                            f'plain_ms{suffix}': plain_ms, f'bound_ms{suffix}': b_ms,
                            f'bound_by{suffix}': b_by,
                            f'device_launches_a_call{suffix}': counted})
                log(f'  {name} (N={n}): kernel {ms:.4f} ms (its own device time {dev_ms} ms, '
                    f'{counted} launches counted), plain '
                    + ('not measured' if plain_ms is None else f'{plain_ms:.4f} ms')
                    + f', bound {b_ms:.6f} ms ({b_by}), {ms / b_ms:.1f}x the bound')
                for t, cnt, k in (top or [])[:6]:
                    log(f'    {t:.3f} ms in {cnt:.0f} x {k[:90]}')
                if name == 'value_sampled_317':
                    row_kernels[suffix or f'_n{n8}'] = (n * S, top or [])
            rows.append(row)
        w0 = wide.engine_launches.launches
        rollout.rollout_prepared(*r_args, **r_kw)
        counted = wide.engine_launches.launches - w0
        if counted != wide.rollout_launches(H):
            raise AssertionError(f'rollout_317: {counted} device launches counted, '
                                 f'{wide.rollout_launches(H)} expected')
        ms = time_ms(lambda: rollout.rollout_prepared(*r_args, **r_kw), 10)
        dev_ms = device_share(lambda: rollout.rollout_prepared(*r_args, **r_kw), 3)[0]
        plain_ms = time_ms(lambda: rollout.rollout_prepared_plain(*r_args, **r_kw), 2)
        b_ms, b_by = wide_bounds(prep_r, 1, S, H, A, 0, 0)['rollout']
        log(f'  rollout_317 (S={S}): kernel {ms:.4f} ms (its own device time {dev_ms} ms, '
            f'{counted} launches counted), plain {plain_ms:.4f} ms, bound '
            f'{b_ms:.6f} ms ({b_by})')
        rows.append({'name': 'rollout_317', 'route': 'cuda', 'engine': 'wide',
                     'source': 'tdmpc2_tpu_torch/csrc/rollout.cu',
                     'replaces': 'tdmpc2_tpu/ops/pallas_rollout.py:50', 'launches': 0,
                     'max_abs_err': errs['rollout_317'], 'ms': ms, 'device_ms': dev_ms,
                     'plain_ms': plain_ms, 'bound_ms': b_ms, 'bound_by': b_by,
                     'library_ms': None, 'model_size': WIDE_SIZE,
                     'device_launches_a_call': counted})
        # the row kernel on its own, from the value step's traces: each
        # template's device time a launch against the bytes it must move
        by_template = {}
        for suffix, (R, top) in row_kernels.items():
            for name_, (modes, per_step, by) in row_kernel_bytes(R).items():
                hit = [(t, c) for t, c, k in top if name_ in k]
                t_ms, cnt = (sum(t for t, _ in hit), sum(c for _, c in hit)) if hit else (None, 0)
                b_ms = by / HBM_BYTES_PER_S * 1e3
                by_template[f'{name_}{suffix}'] = dict(
                    modes=modes, rows=R, launches_a_step=cnt, ms=t_ms and t_ms / cnt,
                    bound_ms=b_ms, bound_by='bytes')
                log(f'  {name_} ({modes}), {R} rows: '
                    + ('not in the trace\'s top entries' if t_ms is None else
                       f'{t_ms / cnt:.4f} ms a launch ({cnt:.0f} a value step)')
                    + f', bound {b_ms:.5f} ms (bytes)')
        # the staging (stage_kernel: each step's actions sampled into the
        # z||a rows; at t = 0 folded: the env's latent into zb) from the
        # same traces; its numbers alone come from the staging phase (main)
        stage = {}
        for suffix, (R, top) in row_kernels.items():
            hit = [(t, c) for t, c, k in top if 'stage_kernel' in k]
            t_ms, cnt = (sum(t for t, _ in hit), sum(c for _, c in hit)) if hit else (None, 0)
            b_ms = step_stage_bytes(R, R // S, L, A, H, True) / HBM_BYTES_PER_S * 1e3
            stage[suffix] = dict(rows=R, launches_a_step=cnt, ms=t_ms and t_ms / cnt,
                                 bound_ms=b_ms, bound_by='bytes')
            log(f'  stage_kernel, {R} rows: '
                + ('not in the trace' if t_ms is None else
                   f'{t_ms / cnt:.4f} ms a launch ({cnt:.0f} a value step)')
                + f', bound {b_ms:.5f} ms (bytes, a launch on average)')
        rows.append({'name': 'wide_stage', 'route': 'cuda', 'engine': 'wide',
                     'source': 'tdmpc2_tpu_torch/csrc/mlp_wide.cuh',
                     'replaces': 'tdmpc2_tpu/ops/pallas_rollout.py:437', 'launches': 0,
                     'library_ms': None, 'model_size': WIDE_SIZE, 'by_rows': stage})
        # the row's own numbers come from the row phase (main)
        rows.append({'name': 'wide_row', 'route': 'cuda', 'engine': 'wide',
                     'source': 'tdmpc2_tpu_torch/csrc/mlp_wide.cuh',
                     'replaces': 'tdmpc2_tpu/ops/pallas_rollout.py:437', 'launches': 0,
                     'library_ms': None, 'model_size': WIDE_SIZE,
                     'by_template': by_template})
        # the fold's two kernels from the same traces; their numbers alone
        # come from the fold phase (main)
        for fname, kname in (('wide_fold_u', 'fold_u_kernel'),
                             ('wide_fold_hidden', 'fold_hidden_kernel')):
            seen = {}
            for suffix, (R, top) in row_kernels.items():
                hit = [(t, c) for t, c, k in top if kname in k]
                t_ms, cnt = (sum(t for t, _ in hit), sum(c for _, c in hit)) if hit else (None, 0)
                seen[suffix] = dict(rows=R, launches_a_step=cnt, ms=t_ms and t_ms / cnt)
                log(f'  {kname}, {R} rows: '
                    + ('not in the trace\'s top entries' if t_ms is None else
                       f'{t_ms / cnt:.4f} ms a launch ({cnt:.0f} a value step)'))
            rows.append({'name': fname, 'route': 'cuda', 'engine': 'wide',
                         'source': 'tdmpc2_tpu_torch/csrc/mlp_wide.cuh',
                         'replaces': 'tdmpc2_tpu/ops/pallas_rollout.py:437', 'launches': 0,
                         'library_ms': None, 'model_size': WIDE_SIZE, 'in_value_step': seen})
        del e_prep, e_params, cases, prep_r

    with tempfile.TemporaryDirectory() as data_dir, \
            Phase(f'path: offline training mt80, {tag}, {WIDE_STEPS} iterations '
                  f'(OfflineTrainer, {WIDE_CHUNKS} seeded chunks of the mt80 dataset\'s '
                  f'geometry), then act_tasks over the {NT} tasks'):
        write_mt30_chunks(data_dir, WIDE_CHUNKS, WIDE_EPISODES, SEED, task='mt80')
        t_cfg = mt30_cfg(load_cfg, [f'data_dir={data_dir}', f'steps={WIDE_STEPS}',
                                    f'eval_freq={10 * WIDE_STEPS}', 'save_agent=false',
                                    'exp_name=chip_smoke_mt80'],
                         model_size=WIDE_SIZE, task='mt80')
        trainer = OfflineTrainer(cfg=t_cfg, env=None, agent=ag, buffer=Buffer(t_cfg),
                                 logger=Logger(t_cfg))
        infos = []
        many = ag.update_many
        ag.update_many = lambda buf, n: infos.append(clone_info(many(buf, n))) or infos[-1]
        zero_counts()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        paths['offline train mt80'] = read_counts()
        del ag.update_many
        buf = trainer.buffer
        losses = torch.stack([torch.stack([i['total_loss'], i['pi_loss']]) for i in infos])
        log(f'  {buf.num_eps} episodes loaded; {WIDE_STEPS} iterations ({len(infos)} '
            f'update_many calls) in {secs:.1f} s with the load: last losses total '
            f'{float(losses[-1, 0]):.4f}, pi {float(losses[-1, 1]):.4f}')
        if not bool(torch.isfinite(losses).all()) or len(infos) != WIDE_STEPS // 8:
            raise AssertionError(f'offline mt80: {len(infos)} calls, losses {losses}')
        check_update_counts('offline train mt80', paths['offline train mt80'], WIDE_STEPS)
        upd_ms = time_ms(lambda: ag.update_many(buf, 8), 1) / 8
        busy, n_dev, _ = device_share(lambda: ag.update(buf), 2)
        log(f'  update: {upd_ms:.3f} ms (CUDA events, update_many(8) / 8), '
            f'{1e3 / upd_ms:.2f} update steps/s at batch {t_cfg.batch_size}; device busy '
            f'{busy} ms of one update over {n_dev} device activities (torch.profiler)')
        hold_update_graph(f'mt80, model_size {WIDE_SIZE}', ag, buf.sample())
        update_records[f'mt80/{WIDE_SIZE}'] = update_record(
            f'mt80, model_size {WIDE_SIZE}', ag, buf.sample(), buf, reps=4)
        bf16_twin_hold(f'mt80/{WIDE_SIZE}', ag, buf.sample(), update_records)
        store, task_store = buf._storage['obs'], buf._task_store
        first = torch.stack([torch.nonzero(task_store == t)[0, 0] for t in range(NT)])
        obs_at = [store[first, r].cpu().numpy() for r in range(WIDE_ACT_STEPS + 1)]
        ag._drop_graphs()        # the first act_tasks after training captures anew
        zero_counts()
        t0 = time.perf_counter()
        a, pm = ag.act_tasks(obs_at[0], np.zeros((NT, H, A), np.float32), True, tasks)
        capture_ms = 1e3 * (time.perf_counter() - t0)
        for r in range(1, WIDE_ACT_STEPS + 1):
            a, pm = ag.act_tasks(obs_at[r], pm, False, tasks)
        paths['act_tasks mt80'] = read_counts()
        check_plan_counts(f'act_tasks mt80 (N={NT}, {tag})', paths['act_tasks mt80'],
                          WIDE_ACT_STEPS + 1, wide.plan_launches(H, I, False),
                          wide.plan_products(H, I, False), wide.plan_stagings(H, I),
                          wide.plan_folds(I))
        if not np.isfinite(a).all() or any(
                (a[i, MT80_ACTION_DIMS[i]:] != 0).any() for i in range(NT)):
            raise AssertionError('act_tasks mt80: non-finite actions or a masked column set')
        ms = host_ms(lambda: ag.act_tasks(obs_at[-1], pm, False, tasks), 3)
        busy, n_dev, top = device_share(lambda: ag.act_tasks(obs_at[-1], pm, False, tasks), 2)
        log(f'  act_tasks N={NT}: first call (eager warm-up and capture) {capture_ms:.1f} ms; '
            f'then {ms:.3f} ms a call ({1e3 * NT / ms:.1f} task-plans/s, host clock); device '
            f'busy {busy} ms (' + ('not measured' if busy is None else
                                   f'{100 * busy / ms:.1f}% of the call')
            + f') over {n_dev} activities')
        for t, n, k in top or []:
            log(f'    {t:.3f} ms in {n:.0f} x {k[:90]}')
        o1 = obs_at[-1][30]
        ag.act(o1, t0=True, eval_mode=True, task=30)
        ms1 = host_ms(lambda: ag.act(o1, eval_mode=True, task=30), 5)
        busy1, _, _ = device_share(lambda: ag.act(o1, eval_mode=True, task=30), 2)
        log(f'  act, one env (task 30, {tag}): {ms1:.3f} ms a call (host clock), device busy '
            f'{busy1} ms')
        for row in rows:
            key = {'value_sampled_317': 'value_sampled',
                   'value_sampled_episodic_317': None,
                   'cem_pi_rollout_317': 'cem_pi_rollout',
                   'wide_row': 'wide_row', 'wide_stage': 'wide_stage',
                   'wide_fold_u': 'wide_fold_u',
                   'wide_fold_hidden': 'wide_fold_hidden'}.get(row['name'])
            if key is not None:
                row['launches'] = paths['act_tasks mt80'][key]
            elif row['name'] == 'value_sampled_episodic_317':
                row['launches'] = 0
        del trainer, ag, buf, store
    return errs, paths, rows


def leaves(obj):
    """The leaves of a checkpoint's tree (dicts, tuples, lists)."""
    if isinstance(obj, dict):
        return [x for v in obj.values() for x in leaves(v)]
    if isinstance(obj, (tuple, list)):
        return [x for v in obj for x in leaves(v)]
    return [obj]


def recorded_batch(recorded, task, horizon, batch, seed):
    """`batch` slices of horizon+1 rows of `task`'s recorded trajectory, in
    the update's layout (obs [T+1, B, obs], action [T, B, A], reward and
    terminated [T, B, 1]), on the card."""
    import numpy as np
    import torch
    obs, act, rew = (recorded[f'{task}/{k}'] for k in ('obs', 'action', 'reward'))
    starts = np.random.default_rng(seed).integers(0, len(act) - horizon, batch)
    rows = starts[None] + np.arange(horizon + 1)[:, None]
    return [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in (
        obs[rows], act[rows[:-1]], rew[rows[:-1]][..., None],
        np.zeros((horizon, batch, 1), np.float32))]


def hold_restored(name, agent, buffer, blob):
    """An agent and its buffer's generator just after a resume, against the
    checkpoint it read: every array and both generator states bit for bit."""
    import numpy as np
    from tdmpc2_tpu_torch.utils import tree
    n = 0
    for field, key in (('params', 'model'), ('target_Qs', 'target_Qs'),
                       ('opt_state', 'torch_opt_state'),
                       ('pi_opt_state', 'torch_pi_opt_state'), ('scale', 'scale')):
        got, ref = tree.leaves(getattr(agent.state, field)), tree.leaves(blob[key])
        if len(got) != len(ref) or any(
                a.cpu().numpy().tobytes() != np.asarray(b).tobytes()
                for a, b in zip(got, ref)):
            raise AssertionError(f'{name}: {field} differs from the checkpoint\'s')
        n += len(got)
    for gen, key in ((agent.generator, 'torch_rng'), (buffer.generator, 'torch_buffer_rng')):
        if gen.get_state().numpy().tobytes() != blob[key]['state'].tobytes():
            raise AssertionError(f'{name}: the generator of {key} differs')
    log(f'  {name}: {n} arrays (parameters, target heads, Adam counts and moments, '
        'scale) and the agent\'s and the buffer\'s generator states equal the '
        'checkpoint\'s, bit for bit')


def reference_state_dict(cfg, seed):
    """A reference-format WorldModel state dict of cfg's widths (the
    reference's key scheme, torch's [out, in] weights; target heads copied
    from the Q heads), its weights drawn from `seed`, as `torch.save` of the
    reference agent's model holds one (tests/test_interop.py builds one
    alike)."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    D, A, M, nb = cfg.latent_dim, cfg.action_dim, cfg.mlp_dim, max(cfg.num_bins, 1)

    def mlp(prefix, dims, final_normed=False, lead=()):
        for i in range(len(dims) - 1):
            o, k = dims[i + 1], dims[i]
            sd[f'{prefix}.{i}.weight'] = torch.randn(*lead, o, k, generator=gen) / k ** 0.5
            sd[f'{prefix}.{i}.bias'] = torch.randn(*lead, o, generator=gen) * 0.1
            if i < len(dims) - 2 or final_normed:
                sd[f'{prefix}.{i}.ln.weight'] = torch.rand(*lead, o, generator=gen) + 0.5
                sd[f'{prefix}.{i}.ln.bias'] = torch.randn(*lead, o, generator=gen) * 0.1
    enc = [cfg.obs_shape['state'][0]] + max(cfg.num_enc_layers - 1, 1) * [cfg.enc_dim]
    mlp('_encoder.state', enc + [D], final_normed=True)
    mlp('_dynamics', [D + A, M, M, D], final_normed=True)
    mlp('_reward', [D + A, M, M, nb])
    mlp('_pi', [D, M, M, 2 * A])
    mlp('_Qs.params', [D + A, M, M, nb], lead=(cfg.num_q,))
    for k in [k for k in sd if k.startswith('_Qs.params.')]:
        sd['_target_Qs_params.' + k[len('_Qs.params.'):]] = sd[k].clone()
    sd['log_std_min'] = torch.tensor(float(cfg.log_std_min))
    sd['log_std_dif'] = torch.tensor(float(cfg.log_std_max - cfg.log_std_min))
    return sd


def hold_trained(task, ag, obs_rows, forced=False):
    """The planner's kernels on `ag`'s trained weights against their plain
    versions, on recorded observations: the pi rollout, the sampled value
    step and the elite step at N = N_ENVS envs and at one env (each N-env
    launch against N one-env launches, bit for bit), the plain versions'
    own spread (the CPU's against the card's), and the plan's graph against
    its eager body at one env and N envs. With `forced` the pi rollout is
    held step by step, against the plain rollout whose latents advance on
    the kernel's actions in three orders of its sums (`hold_pi_orders`),
    and its free-running
    distance is logged beside two plain versions' (`log_pi_drift`; ROADMAP
    C4). Returns {kernel: max |err|}."""
    import numpy as np
    import torch
    from tdmpc2_tpu_torch.ops import cem, value
    cfg, dev, NE = ag.cfg, torch.device('cuda'), N_ENVS
    H, S, L, HA = cfg.horizon, cfg.num_samples, cfg.latent_dim, cfg.horizon * cfg.action_dim
    n_pi, prep = cfg.num_pi_trajs, ag.prep
    heads = dict(log_std_min=ag.model.log_std_min, log_std_dif=ag.model.log_std_dif,
                 simnorm_dim=cfg.simnorm_dim)
    elite_kw = dict(num_elites=cfg.num_elites, temperature=cfg.temperature,
                    min_std=cfg.min_std, max_std=cfg.max_std)
    g = torch.Generator(device=dev).manual_seed(SEED)
    idx = np.linspace(0, len(obs_rows) - 1, NE).astype(int)   # spread over the episode
    obs = obs_rows[idx]
    z = ag.model.encode(ag.params, torch.from_numpy(obs).to(dev))[:, None]
    noise = ag.draw_noise(NE)
    pi_args = (prep, z, noise.pi_eps[:, :n_pi])
    pa = cem.pi_rollout(*pi_args, **heads)
    vs_args = (prep, z.expand(NE, S, L), torch.rand(NE, HA, device=dev, generator=g) * 0.4
               - 0.2, torch.rand(NE, HA, device=dev, generator=g) * 1.9 + 0.1,
               noise.sample[:, 0], pa, ag.amask, noise.eps[:, 0], noise.qidx[:, 0],
               ag.discs.expand(NE, -1))
    if forced:
        log_pi_drift(f'{task} pi_rollout N={NE}', pi_args, heads, {}, pa)
        # both bf16 versions against an all-f32 one, latents on the kernel's actions
        f32 = pi_rollout_forced(value.prepare_value_params(ag.params, cfg, torch.float32),
                                *pi_args[1:], pa, heads)
        log(f'  {task} pi_rollout N={NE} against an all-f32 rollout: the kernel max |err| '
            f'{max_err(pa, f32):.3g}, the bf16 plain version '
            f'{max_err(pi_rollout_forced(*pi_args, pa, heads), f32):.3g}')
        errs = {'cem_pi_rollout': hold_pi_orders(f'{task} pi_rollout N={NE}', pa, *pi_args,
                                                 heads)}
    else:
        errs = {'cem_pi_rollout': hold(f'{task} pi_rollout N={NE}', pa,
                                       cem.pi_rollout_plain(*pi_args, **heads), PI_TOL)}
    errs['value_sampled'], v, acts = hold_sampled(f'{task} N={NE}', vs_args, heads)
    e_args = (v, acts, ag.amask)
    errs['cem_elite'] = max(
        hold(f'{task} elite N={NE} {k}', a, b, tol) for k, a, b, tol in zip(
            ('mean', 'std', 'guarded v'), cem.elite_moments(*e_args, **elite_kw),
            cem.elite_moments_plain(*e_args, **elite_kw),
            (ELITE_TOL, ELITE_TOL, GUARD_TOL)))
    log(f'  {task}: values of the sampled step in [{float(v.min()):.3f}, '
        f'{float(v.max()):.3f}] (std {float(v.std()):.3f})')
    shared = (prep, ag.amask)
    calls = (('cem_pi_rollout', cem.pi_rollout, cem.pi_rollout_plain, pi_args, heads,
              (PI_TOL,)),
             ('value_sampled', value.value_sampled, value.value_sampled_plain, vs_args,
              heads, (VALUE_TOL, SAMPLE_TOL)),
             ('cem_elite', cem.elite_moments, cem.elite_moments_plain, e_args, elite_kw,
              (ELITE_TOL, ELITE_TOL, GUARD_TOL)))
    for name, kern, plain, args, kw, tols in calls:
        got = as_tuple(kern(*args, **kw))
        for i in range(NE):
            one_args = [a if any(a is x for x in shared) else a[i:i + 1] for a in args]
            one = as_tuple(kern(*one_args, **kw))
            if not all(torch.equal(a[i:i + 1], b) for a, b in zip(got, one)):
                raise AssertionError(f'{task} {name}: env {i} of the N={NE} launch differs '
                                     'from its one-env launch')
            if i == 0 and forced and name == 'cem_pi_rollout':
                errs[name] = max(errs[name], hold_pi_orders(
                    f'{task} {name} one env', one[0], *one_args, kw))
            elif i == 0:
                ref = as_tuple(plain(*one_args, **kw))
                errs[name] = max(errs[name], *[
                    hold(f'{task} {name} one env [{j}]', a, b, tol)
                    for j, (a, b, tol) in enumerate(zip(one, ref, tols))])
        log(f'  {task} {name}: the N={NE} launch equals {NE} one-env launches bit for bit')
    # the spread of two plain versions of the same arithmetic, beside the bands
    cpu = {k: x.cpu() for k, x in prep.items()}
    pa_c = cem.pi_rollout_plain(cpu, z.cpu(), pi_args[2].cpu(), **heads)
    v_c = value.value_sampled_plain(cpu, *[a.cpu() for a in vs_args[1:]], **heads)[0]
    v_p = value.value_sampled_plain(*vs_args, **heads)[0]
    log(f'  {task}, trained weights: max |err| kernel vs plain: pi rollout '
        f'{errs["cem_pi_rollout"]:.3g}, value {errs["value_sampled"]:.3g} (band '
        f'{VALUE_TOL["atol"]}), elite {errs["cem_elite"]:.3g} ({ELITE_TOL["atol"]}); the '
        f'JAX suite\'s action tolerance 1e-3: pi rollout '
        f'{"within" if errs["cem_pi_rollout"] <= 1e-3 else "outside"}; two plain '
        f'versions (CPU vs card): pi rollout '
        f'{max_err(pa_c, cem.pi_rollout_plain(*pi_args, **heads).cpu()):.3g}, value '
        f'{max_err(v_c, v_p.cpu()):.3g}')
    for label, n, ev in (('one env', 1, False), (f'N={NE}, eval', NE, True)):
        hold_plan_graph(f'{task} {label}', ag, n, ev, SEED + n, obs[:n])
    return errs


def checkpoint_phases(zero_counts, read_counts, check_plan_counts, hold_update):
    """Checkpoints and resuming on the card. Returns ({kernel: {checkpoint:
    max |err| on its trained weights}}, {path: launch counts}, {checkpoint:
    seconds to read it}).

    (a) both committed checkpoints read in this process with jax, jaxlib,
        optax and ml_dtypes unimportable (and never imported);
    (b) the planner's kernels against their plain versions on each
        checkpoint's trained weights (`hold_trained`);
    (c) one update on the card from the full hopper-hop train state (its
        Adam states and scale carried) against the same update on the CPU;
    (d) `train resume=true` on toy-reach, one env and num_envs=8, from the
        train paths' checkpoints at step TRAIN_STEPS to RESUME_STEPS behind
        a RESUME_REFILL-step refill gate: the restored state bit for bit,
        the snapshot's episodes, no update inside the gate and one update
        per env step after it; and offline training on the toy multi-task
        config resumed at its iteration checkpoint;
    (e) `evaluate` from a reference-format `.pt` checkpoint.
    """
    import importlib

    import numpy as np
    import torch
    from tdmpc2_tpu_torch import train as train_mod
    from tdmpc2_tpu_torch.config import load_cfg
    from tdmpc2_tpu_torch.envs import make_env
    from tdmpc2_tpu_torch.evaluate import evaluate
    from tdmpc2_tpu_torch.interop import load_blob
    from tdmpc2_tpu_torch.ops import probe
    from tdmpc2_tpu_torch.tdmpc2 import TDMPC2
    from tdmpc2_tpu_torch.trainer.offline import OfflineTrainer
    from tdmpc2_tpu_torch.trainer.online import OnlineTrainer
    root = Path(__file__).resolve().parent
    errs, paths, read_s = {}, {}, {}

    with Phase('(a) read the two committed checkpoints here, jax, optax and ml_dtypes '
               'blocked'):
        sys.meta_path.insert(0, ImportBlocker())
        for m in BLOCKED:
            try:
                importlib.import_module(m)
            except ImportError:
                continue
            raise AssertionError(f'{m} imported past the blocker')
        blobs = {}
        for task, (fp, _, _) in CHECKPOINTS.items():
            t0 = time.perf_counter()
            blobs[task] = load_blob(root / fp)
            read_s[task] = time.perf_counter() - t0
            arrays = [x for x in leaves(blobs[task]) if isinstance(x, np.ndarray)]
            log(f'  {fp}: {(root / fp).stat().st_size / 1e6:.1f} MB gzipped, '
                f'{len(arrays)} arrays ({sum(a.nbytes for a in arrays) / 1e6:.1f} MB) read '
                f'in {read_s[task]:.2f} s; keys {sorted(blobs[task])}; extra '
                f'{blobs[task].get("extra")}')
        full = blobs['hopper-hop']
        counts = [int(full['opt_state'][1].inner_states[k].inner_state[0].count)
                  for k in ('enc', 'rest')] + [int(full['pi_opt_state'][1][0].count)]
        log(f'  the full train state: Adam counts {counts} (enc, rest, policy), scale '
            f'{float(full["scale"])}')
        if counts != [FULL_ADAM_COUNT] * 3 or abs(float(full['scale']) - FULL_SCALE) > 1e-5:
            raise AssertionError('the full train state: unexpected counts or scale')
        bad = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
        if bad:
            raise AssertionError(f'imported while reading: {bad}')
        log(f'  none of {", ".join(BLOCKED)} importable here, none in sys.modules')

    with np.load(root / OBS_FILE) as d:
        recorded = {k: d[k] for k in d.files}
    agents = {}
    for task, (fp, obs_dim, act_dim) in CHECKPOINTS.items():
        with Phase(f'(b) the planner\'s kernels vs plain on trained weights: {task}, '
                   f'one env and N={N_ENVS}, recorded observations'):
            cfg = load_cfg(overrides=[f'task={task}', f'seed={SEED}', 'device=cuda',
                                      f'num_envs={N_ENVS}'])
            cfg.obs_shape, cfg.action_dim = {'state': (obs_dim,)}, act_dim
            cfg.episode_length = 1000
            ag = agents[task] = TDMPC2(cfg, device='cuda')
            t0 = time.perf_counter()
            extra = ag.load(root / fp)
            torch.cuda.synchronize()
            log(f'  TDMPC2.load({fp}) onto the card in {time.perf_counter() - t0:.2f} s; '
                f'extra {extra}')
            for k, e in hold_trained(task, ag, recorded[f'{task}/obs']).items():
                errs.setdefault(k, {})[task] = e

    with Phase('(c) one update on the card from the full hopper-hop train state vs the '
               'same update on the CPU, on recorded observations'):
        ag = agents['hopper-hop']
        st = ag.state
        got = [int(st.opt_state[k]['count']) for k in ('enc', 'rest')] + [
            int(st.pi_opt_state['count'])]
        log(f'  carried over: Adam counts {got}, scale {float(st.scale)}')
        if got != [FULL_ADAM_COUNT] * 3 or abs(float(st.scale) - FULL_SCALE) > 1e-5:
            raise AssertionError('the full train state was not carried over')
        info = hold_update(ag, recorded_batch(recorded, 'hopper-hop', ag.cfg.horizon,
                                              ag.cfg.batch_size, SEED))
        log(f'  pi_scale after the update {float(info["pi_scale"]):.4f}, pi loss '
            f'{float(info["pi_loss"]):.4f}, total loss {float(info["total_loss"]):.4f}')
    del agents, blobs

    def resume_path(name, extra):
        """`train resume=true` in the work dir of train path `name` (its
        checkpoint at TRAIN_STEPS, its replay snapshot) to RESUME_STEPS."""
        got, steps = {}, []
        orig = OnlineTrainer.maybe_resume
        updates = TDMPC2._updates     # every schedule's n steps on one draw

        def recording_resume(self):
            models = Path(self.cfg.work_dir) / 'models'
            blob = load_blob(models / 'latest.pkl')
            with np.load(models / 'buffer.npz') as snap:
                saved_obs = snap['ep__obs']
            orig(self)
            got['trainer'] = self
            hold_restored(f'resume {name}', self.agent, self.buffer, blob)
            if (self._step, self._ep_idx) != (blob['extra']['step'], blob['extra']['ep_idx']) \
                    or self._step != TRAIN_STEPS:
                raise AssertionError(f'resume {name}: counters {self._step}, {self._ep_idx}')
            n = self.buffer.num_eps
            if n != SNAPSHOT_EPS or not np.array_equal(
                    self.buffer._storage['obs'][:n].cpu().numpy(), saved_obs):
                raise AssertionError(f'resume {name}: the snapshot\'s episodes are not back')
            log(f'  resume {name}: step {self._step}, episode {self._ep_idx}, {n} snapshot '
                f'episodes back ({self._refill_credit} steps of refill credit)')
        OnlineTrainer.maybe_resume = recording_resume
        TDMPC2._updates = lambda self, buf, n: steps.extend(
            [got['trainer']._step] * n) or updates(self, buf, n)
        try:
            probe._verdict = None       # as in a fresh process
            zero_counts()
            t0 = time.perf_counter()
            tr = train_mod.main([
                'task=toy-reach', f'steps={RESUME_STEPS}', f'eval_freq={TRAIN_STEPS}',
                'eval_episodes=1', f'seed={SEED}', 'save_agent=true', 'device=cuda',
                f'exp_name=chip_smoke_{name}', f'buffer_snapshot_eps={SNAPSHOT_EPS}',
                'resume=true', f'resume_refill_steps={RESUME_REFILL}', *extra])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read_counts()
        finally:
            OnlineTrainer.maybe_resume = orig
            TDMPC2._updates = updates
        n = int(tr.cfg.num_envs or 1)
        gate_open = TRAIN_STEPS + RESUME_REFILL - tr._refill_credit
        want = [s for s in range(TRAIN_STEPS, tr._step, n) if s >= gate_open
                for _ in range(n)]
        log(f'  resume {name}: to step {tr._step} in {secs:.1f} s, {len(steps)} updates '
            f'from step {steps[0] if steps else None} (the gate opens at {gate_open}), '
            f'{tr.buffer._draws} replay draws; launches {counts}')
        if not steps or steps != want or tr.buffer._draws != len(steps) // n:
            raise AssertionError(f'resume {name}: updates at {sorted(set(steps))}')
        check_plan_counts(f'resume {name}', counts)
        check_update_counts(f'resume {name}', counts, len(steps))
        if counts['probe'] <= 0:
            raise AssertionError(f'resume {name}: the canary never launched')
        return counts

    with Phase(f'(d) train resume=true, toy-reach, one env: {TRAIN_STEPS} -> '
               f'{RESUME_STEPS} steps, a {RESUME_REFILL}-step refill gate'):
        paths['train resumed, one env'] = resume_path('one_env', [])
    with Phase(f'(d) train resume=true, toy-reach, num_envs={N_ENVS}: {TRAIN_STEPS} -> '
               f'{RESUME_STEPS} env steps'):
        paths[f'train resumed, num_envs={N_ENVS}'] = resume_path(
            'vec', [f'num_envs={N_ENVS}'])

    with tempfile.TemporaryDirectory() as data_dir, \
            Phase(f'(d) offline training resumed: toy multi-task, {TOY_MT_STEPS} '
                  f'iterations, then resume=true at its checkpoint to {TOY_MT_RESUME}'):
        write_toy_chunks(data_dir)

        def toy_cfg(*extra):
            cfg = load_cfg(overrides=['task=toy-mt2', f'seed={SEED}', 'device=cuda',
                                      f'data_dir={data_dir}', f'eval_freq={TOY_MT_STEPS}',
                                      'eval_episodes=1', 'exp_name=chip_smoke_toy_mt_resume',
                                      *extra])
            cfg.multitask, cfg.tasks, cfg.task_dim = True, ['toy-reach', 'toy-reach'], 8
            return cfg
        first = train_mod.train(toy_cfg(f'steps={TOY_MT_STEPS}'))
        blob = load_blob(Path(first.cfg.work_dir) / 'models' / f'{TOY_MT_STEPS}.pkl')
        got = {}
        orig = OfflineTrainer._maybe_resume

        def recording_resume(self):
            got['i'] = orig(self)
            hold_restored('offline resume', self.agent, self.buffer, blob)
            return got['i']
        OfflineTrainer._maybe_resume = recording_resume
        try:
            probe._verdict = None
            zero_counts()
            tr = train_mod.train(toy_cfg(f'steps={TOY_MT_RESUME}', 'resume=true'))
            counts = paths['offline train toy multi-task, resumed'] = read_counts()
        finally:
            OfflineTrainer._maybe_resume = orig
        count = int(tr.agent.state.opt_state['enc']['count'])
        log(f'  resumed at iteration {got["i"]}, Adam count {count} at the end; launches '
            f'{counts}')
        if got['i'] != TOY_MT_STEPS or count != TOY_MT_RESUME:
            raise AssertionError(f'offline resume: iteration {got["i"]}, count {count}')
        check_plan_counts('offline resume (its eval)', counts, MAX_EP_LEN)

    with tempfile.TemporaryDirectory() as tmp, \
            Phase('(e) evaluate from a reference-format .pt checkpoint (toy-reach dims, '
                  'default 5M model, seeded weights)'):
        cfg = load_cfg(overrides=['task=toy-reach', f'seed={SEED}', 'device=cuda'])
        make_env(cfg)
        sd = reference_state_dict(cfg, SEED)
        fp = Path(tmp) / 'reference.pt'
        torch.save({'model': sd}, fp)
        got = {}
        orig = TDMPC2.load

        def recording_load(self, fp_, buffer=None):
            got['agent'] = self
            return orig(self, fp_, buffer)
        TDMPC2.load = recording_load
        try:
            zero_counts()
            res = evaluate(load_cfg(overrides=['task=toy-reach', f'seed={SEED}',
                                               'device=cuda', 'eval_episodes=1',
                                               f'checkpoint={fp}']))['toy-reach']
            counts = paths['evaluate from a reference .pt'] = read_counts()
        finally:
            TDMPC2.load = orig
        p = got['agent'].params
        pairs = ((p['dynamics'][0]['w'], sd['_dynamics.0.weight'].T),
                 (p['Qs'][2]['w'], sd['_Qs.params.2.weight'].transpose(1, 2)),
                 (got['agent'].state.target_Qs[0]['b'], sd['_target_Qs_params.0.bias']),
                 (p['encoder']['state'][1]['ln_w'], sd['_encoder.state.1.ln.weight']))
        if not all(torch.equal(a.cpu(), b) for a, b in pairs):
            raise AssertionError('.pt: the loaded weights differ from the state dict')
        log(f'  reward {res["reward"]:.4f}, {res["plans"]} plans, '
            f'{res["plans"] / res["seconds"]:.1f} plans/s; launches {counts}')
        if not math.isfinite(res['reward']):
            raise AssertionError('evaluate from .pt: non-finite reward')
        check_plan_counts('evaluate from a reference .pt', counts, res['plans'])
    return errs, paths, read_s


def pixel_env(seed):
    """NormalizeInfo(Timeout(PixelObs(point mass))): 64 x 64 x 9 uint8 stacks
    of the toy env's frames, as the JAX pixel loop's env is built
    (tests/test_pixels_loop.py)."""
    from tdmpc2_tpu_torch.envs.base import NormalizeInfo, Timeout
    from tdmpc2_tpu_torch.envs.dmcontrol import PixelObs
    from tdmpc2_tpu_torch.envs.toy import PointMassEnv
    return NormalizeInfo(Timeout(PixelObs(PointMassEnv(seed)), MAX_EP_LEN))


def pixel_cfg(*extra, action_dim=2, task='toy-reach'):
    """The default 5M config with obs=rgb at 64 x 64 x 9 (num_channels 32,
    latent 512), the env fields set as the JAX pixel loop sets them."""
    from tdmpc2_tpu_torch.config import load_cfg
    cfg = load_cfg(overrides=[f'task={task}', 'obs=rgb', f'seed={SEED}', 'device=cuda',
                              *extra])
    cfg.obs_shape, cfg.action_dim = {'rgb': PIXEL_SHAPE}, action_dim
    cfg.episode_length = MAX_EP_LEN
    return cfg


def pixel_phases(zero_counts, read_counts, check_plan_counts, update_records):
    """The pixel path on the card. Returns ({kernel: max |err| on the
    trained pixel latents}, {path: launch counts}, {metric: value}).

    (a) the committed walker-walk pixel model read with jax, optax and
        ml_dtypes blocked; its conv encoder on the recorded frames against
        the CPU's at ENC_TOL, with and without ShiftAug, and ShiftAug
        against the CPU's bit for bit on the same shifts;
    (b) the planner's kernels on the trained pixel latents against their
        plain versions, one env and N=8, N=8 against 8 one-env launches,
        and the plan's graph (the shift draw among its inputs, the encoder
        in it) against its eager body (`hold_trained`);
    (c) one pixel update on the card against the CPU's, batch 256 of the
        recorded frames;
    (d) OnlineTrainer on PixelObs(point mass), PIXEL_STEPS steps (the burst
        at PIXEL_SEED_STEPS, then planned steps), uint8 frames in the ring;
        VecOnlineTrainer with num_envs=8 envs in this process; `evaluate`
        of the saved pixel agent on its env;
    (e) the encoder's device time per act (N=1, 8) and per update, the
        update's time and device share, env-steps/s, plans/s at N=1 and 8.
    """
    import importlib

    import numpy as np
    import torch
    from tdmpc2_tpu_torch.data.buffer import Buffer
    from tdmpc2_tpu_torch.envs.vec import VecEnv
    from tdmpc2_tpu_torch.evaluate import evaluate
    from tdmpc2_tpu_torch.models import layers
    from tdmpc2_tpu_torch.tdmpc2 import TDMPC2
    from tdmpc2_tpu_torch.trainer.online import OnlineTrainer
    from tdmpc2_tpu_torch.trainer.vec_online import VecOnlineTrainer
    from tdmpc2_tpu_torch.utils import tree
    from tdmpc2_tpu_torch.utils.logger import Logger
    root = Path(__file__).resolve().parent
    dev = torch.device('cuda')
    task, fp, act_dim = PIXEL_CKPT
    paths, metrics = {}, {}

    with Phase(f'(a) pixels: {fp} read with jax, optax and ml_dtypes blocked; its conv '
               'encoder on recorded frames, card vs CPU'):
        if not any(isinstance(f, ImportBlocker) for f in sys.meta_path):
            sys.meta_path.insert(0, ImportBlocker())
        for m in BLOCKED:
            try:
                importlib.import_module(m)
            except ImportError:
                continue
            raise AssertionError(f'{m} imported past the blocker')
        with np.load(root / PIXEL_OBS_FILE) as d:
            recorded = {k: d[k] for k in d.files}
        frames = recorded[f'{task}/obs']
        cfg = pixel_cfg(f'num_envs={N_ENVS}', action_dim=act_dim, task=task)
        cfg.episode_length = 500
        ag = TDMPC2(cfg, device='cuda')
        t0 = time.perf_counter()
        extra = ag.load(root / fp)
        torch.cuda.synchronize()
        enc = ag.params['encoder']['rgb']
        log(f'  TDMPC2.load({fp}) in {time.perf_counter() - t0:.2f} s, extra {extra}; conv '
            f'weights {[tuple(p["w"].shape) for p in enc]} (HWIO); frames '
            f'{frames.shape} {frames.dtype}')
        bad = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
        if bad:
            raise AssertionError(f'imported while reading: {bad}')
        x = torch.from_numpy(frames).to(dev)
        g = torch.Generator(device=dev).manual_seed(SEED)
        sh = torch.randint(0, 2 * layers.SHIFT_PAD + 1, (len(frames), 2), device=dev,
                           generator=g)
        cpu_params = tree.map(lambda t: t.cpu(), ag.params)
        aug = layers.shift_aug(x, sh)
        if aug.dtype != torch.uint8 or not torch.equal(
                aug.cpu(), layers.shift_aug(x.cpu(), sh.cpu())):
            raise AssertionError('ShiftAug: the card differs from the CPU')
        log(f'  ShiftAug on {len(frames)} frames: the card equals the CPU bit for bit '
            f'(shifts {int(sh.min())}..{int(sh.max())})')
        z = {}
        for label, s_ in (('no shift', None), ('ShiftAug', sh)):
            z[label] = ag.model.encode(ag.params, x, shifts=s_)
            hold(f'conv encoder ({label}) card vs CPU', z[label],
                 ag.model.encode(cpu_params, x.cpu(),
                                 shifts=None if s_ is None else s_.cpu()).to(dev), ENC_TOL)
        if z['no shift'].shape != (len(frames), cfg.latent_dim):
            raise AssertionError(f'conv encoder: latent shape {tuple(z["no shift"].shape)}')

    with Phase(f'(b) pixels: the planner\'s kernels vs plain on the trained pixel latents, '
               f'one env and N={N_ENVS}; the plan graph vs eager'):
        errs = hold_trained(f'{task}-rgb', ag, frames, forced=True)

    with Phase('(c) pixels: one update on the card vs the same update on the CPU, batch '
               f'{cfg.batch_size} of the recorded frames'):
        batch = recorded_batch(recorded, task, cfg.horizon, cfg.batch_size, SEED)
        if batch[0].dtype != torch.uint8:
            raise AssertionError('the recorded batch is not uint8')
        info = hold_update(ag, batch)
        log(f'  pi_scale {float(info["pi_scale"]):.4f}, total loss '
            f'{float(info["total_loss"]):.4f}, pi entropy {float(info["pi_entropy"]):.3f}')

    with Phase('(c) pixels: the walker model\'s update graph vs its eager body, bit for '
               'bit; eager vs graph times'):
        hold_update_graph('walker pixels', ag, batch)
        update_records['walker pixels'] = update_record('walker pixels', ag, batch, reps=10)
        bf16_twin_hold('walker pixels', ag, batch, update_records)

    with Phase('(e) pixels: the conv encoder\'s device time per act and per update; plans/s '
               'of act on the walker model'):
        for n in (1, N_ENVS):
            xs, ss = x[:n], sh[:n]
            ms = time_ms(lambda: ag.model.encode(ag.params, xs, shifts=ss), 50)
            busy = device_share(lambda: ag.model.encode(ag.params, xs, shifts=ss), 20)[0]
            metrics[f'encoder_act_ms_n{n}'], metrics[f'encoder_act_device_ms_n{n}'] = ms, busy
            log(f'  conv encoder, act N={n}: {ms:.4f} ms (CUDA events), device busy '
                f'{busy} ms (torch.profiler)')
        obs_b = batch[0]
        nxt = torch.randint(0, 7, (*obs_b.shape[:2], 2), device=dev, generator=g)

        def encoder_of_update():
            """The update's encoder work: obs[1:] without gradient, obs[0]
            with its backward into the conv weights."""
            with torch.no_grad():
                ag.model.encode(ag.params, obs_b[1:], shifts=nxt[1:])
            live = tuple({k: v.detach().requires_grad_(True) for k, v in p.items()}
                         for p in enc)
            zz = ag.model.encode({'encoder': {'rgb': live}}, obs_b[0], shifts=nxt[0])
            with layers.f32_convs(deterministic=True):     # as the update's
                return torch.autograd.grad(zz.square().sum(), tree.leaves(live))
        ms = time_ms(encoder_of_update, 10)
        busy = device_share(encoder_of_update, 5)[0]
        metrics['encoder_update_ms'], metrics['encoder_update_device_ms'] = ms, busy
        log(f'  conv encoder, one update\'s share (batch {cfg.batch_size}, {cfg.horizon + 1} '
            f'steps; the first with its backward): {ms:.3f} ms, device busy {busy} ms')
        for n in (1, N_ENVS):
            o = frames[0] if n == 1 else frames[:n]
            ag.act(o, t0=True)                       # captures the plan's graph
            ms = host_ms(lambda: ag.act(o), 30)
            busy = device_share(lambda: ag.act(o), 5)[0]
            metrics[f'act_ms_n{n}'], metrics[f'plans_per_s_n{n}'] = ms, 1e3 * n / ms
            metrics[f'act_device_ms_n{n}'] = busy
            log(f'  act N={n} on the walker pixel model: {ms:.3f} ms per call, '
                f'{1e3 * n / ms:.1f} plans/s (host clock); device busy {busy} ms')
    del ag, x, batch, obs_b

    def recording(store):
        update = TDMPC2._step

        def run(self, *args):
            info = update(self, *args)
            store.append(torch.stack([info['total_loss'], info['pi_loss']]))
            return info
        return update, run

    with tempfile.TemporaryDirectory() as work:
        with Phase(f'(d) pixels: OnlineTrainer on PixelObs(point mass), default 5M model, '
                   f'{PIXEL_STEPS} steps, the burst at {PIXEL_SEED_STEPS}'):
            cfg = pixel_cfg(f'steps={PIXEL_STEPS}', f'eval_freq={PIXEL_STEPS}',
                            'eval_episodes=1', 'save_agent=true', 'save_csv=false')
            cfg.work_dir, cfg.seed_steps = str(Path(work) / 'one_env'), PIXEL_SEED_STEPS
            losses = []
            update, TDMPC2._step = recording(losses)
            try:
                zero_counts()
                t0 = time.perf_counter()
                tr = OnlineTrainer(cfg=cfg, env=pixel_env(SEED), agent=TDMPC2(cfg),
                                   buffer=Buffer(cfg), logger=Logger(cfg))
                tr.train()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                counts = paths['train pixels, one env'] = read_counts()
            finally:
                TDMPC2._step = update
            losses = torch.stack(losses)
            st = tr.buffer._storage['obs']
            metrics['train_env_steps_per_s'] = tr._step / secs
            log(f'  {tr._step} env steps, {len(losses)} updates in {secs:.1f} s '
                f'({tr._step / secs:.1f} env-steps/s over the run); last losses: total '
                f'{float(losses[-1, 0]):.4f}, pi {float(losses[-1, 1]):.4f}; ring '
                f'{st.dtype} {tuple(st.shape)} on {st.device}; launches {counts}')
            if not bool(torch.isfinite(losses).all()):
                raise AssertionError('pixel train: non-finite loss')
            if len(losses) != PIXEL_STEPS:
                raise AssertionError(f'pixel train: {len(losses)} updates')
            check_update_counts('pixel train, one env', counts, len(losses))
            if st.dtype != torch.uint8 or tuple(st.shape[1:]) != (
                    MAX_EP_LEN + 1, 3 * PIXEL_SHAPE[1] * PIXEL_SHAPE[2]):
                raise AssertionError(f'pixel ring: {st.dtype} {tuple(st.shape)}')
            check_plan_counts('pixel train, one env', counts)
            p_agent, p_buf = tr.agent, tr.buffer

        with Phase('(e) pixels: the update\'s time and device share; the collect + update '
                   'loop'):
            ms = time_ms(lambda: p_agent.update(p_buf), 20)
            busy, n_dev, top = device_share(lambda: p_agent.update(p_buf), 5)
            metrics['update_ms'], metrics['update_device_ms'] = ms, busy
            log(f'  pixel update (batch {cfg.batch_size}): {ms:.3f} ms ({1e3 / ms:.1f} update '
                'steps/s, CUDA events); ' + ('device busy not measured' if busy is None else
                                            f'device busy {busy:.3f} ms (idle share '
                                            f'{100 * (1 - busy / ms):.1f}%), {n_dev:.0f} device '
                                            'activities'))
            for t_, n_, k_ in top:
                log(f'    {t_:.3f} ms in {n_:.0f} x {k_[:90]}')
            env = tr.env
            o, loop = env.reset(), 40
            ph = dict(act=0.0, env=0.0, update=0.0)
            torch.cuda.synchronize()
            t_all = time.perf_counter()
            for t in range(loop):
                t1 = time.perf_counter()
                a = p_agent.act(o, t0=(t % MAX_EP_LEN == 0))
                t2 = time.perf_counter()
                o, _, done, _ = env.step(a)
                if done:
                    o = env.reset()
                t3 = time.perf_counter()
                p_agent.update(p_buf)
                torch.cuda.synchronize()
                t4 = time.perf_counter()
                ph['act'] += t2 - t1
                ph['env'] += t3 - t2
                ph['update'] += t4 - t3
            total = time.perf_counter() - t_all
            metrics['loop_env_steps_per_s'] = loop / total
            log(f'  pixel collect + update loop: {loop / total:.1f} env-steps/s; per step '
                + ', '.join(f'{k} {1e3 * v / loop:.2f} ms ({100 * v / total:.1f}%)'
                            for k, v in ph.items()) + ' (host clock)')

        with Phase(f'(d) pixels: VecOnlineTrainer, num_envs={N_ENVS} in this process, '
                   f'{PIXEL_VEC_STEPS} env steps'):
            vcfg = pixel_cfg(f'steps={PIXEL_VEC_STEPS}', f'num_envs={N_ENVS}',
                             f'eval_freq={PIXEL_VEC_STEPS}',
                             'eval_episodes=1', 'save_agent=false', 'save_csv=false')
            vcfg.work_dir, vcfg.seed_steps = str(Path(work) / 'vec'), PIXEL_VEC_SEED_STEPS
            vlosses = []
            update, TDMPC2._step = recording(vlosses)
            try:
                zero_counts()
                t0 = time.perf_counter()
                vtr = VecOnlineTrainer(
                    cfg=vcfg, env=VecEnv([pixel_env(SEED + 1000 * i) for i in range(N_ENVS)]),
                    agent=TDMPC2(vcfg), buffer=Buffer(vcfg), logger=Logger(vcfg))
                vtr.train()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                counts = paths[f'train pixels, num_envs={N_ENVS}'] = read_counts()
            finally:
                TDMPC2._step = update
            vlosses = torch.stack(vlosses) if vlosses else torch.zeros(0, 2)
            metrics['vec_train_env_steps_per_s'] = vtr._step / secs
            log(f'  {vtr._step} env steps, {len(vlosses)} updates in {secs:.1f} s '
                f'({vtr._step / secs:.1f} env-steps/s); last total loss '
                f'{float(vlosses[-1, 0]) if len(vlosses) else None}; launches {counts}')
            want = PIXEL_VEC_SEED_STEPS + PIXEL_VEC_STEPS - N_ENVS * MAX_EP_LEN
            if not bool(torch.isfinite(vlosses).all()) or len(vlosses) != want:
                raise AssertionError(f'pixel vec train: {len(vlosses)} updates ({want} due), '
                                     f'finite {bool(torch.isfinite(vlosses).all())}')
            check_plan_counts(f'pixel train, num_envs={N_ENVS}', counts)
            check_update_counts(f'pixel train, num_envs={N_ENVS}', counts, len(vlosses))

        with Phase('(d) pixels: evaluate the saved pixel agent on its env, 2 episodes'):
            ckpt = Path(cfg.work_dir) / 'models' / 'final.pkl'
            ecfg = pixel_cfg('eval_episodes=2', f'checkpoint={ckpt}')
            zero_counts()
            res = evaluate(ecfg, env=pixel_env(SEED))['toy-reach']
            counts = paths['evaluate pixels'] = read_counts()
            log(f'  reward {res["reward"]:.4f}, {res["plans"]} plans, '
                f'{res["plans"] / res["seconds"]:.1f} plans/s; launches {counts}')
            if not math.isfinite(res['reward']):
                raise AssertionError('pixel evaluate: non-finite reward')
            check_plan_counts('pixel evaluate', counts, res['plans'])
    log(json.dumps({'pixels': metrics}))
    return errs, paths, metrics


def state_leaves(st, warm=False):
    """The train state's tensors an update reads and writes (with the warm
    starts too where `warm`)."""
    from tdmpc2_tpu_torch.utils import tree
    return tree.leaves([st.params, st.target_Qs, st.opt_state, st.pi_opt_state,
                        st.scale] + ([st.prev_mean] if warm else []))


def snapshot(agent, warm=False):
    """Copies of the agent's train state (and warm starts where `warm`)."""
    return [x.clone() for x in state_leaves(agent.state, warm)]


def restore(agent, saved, warm=False):
    """Write `snapshot`'s copies back into the same tensors (the graphs read
    them where they are); the prep is redone at the next plan."""
    for x, y in zip(state_leaves(agent.state, warm), saved):
        x.copy_(y)
    agent._prep = None


def with_update_graph(agent, batch):
    """Make sure the agent's update graph is captured for its train state:
    one step on `batch` (a capture, or a replay), then the state as it was."""
    saved = snapshot(agent)
    agent._step(batch)
    restore(agent, saved)


def clone_info(info):
    return {k: v.clone() for k, v in info.items()}


def same_bits(what, got, want):
    """Lists (or dicts) of tensors equal bit for bit, else AssertionError
    naming the first that is not and its max |err|."""
    if isinstance(got, dict):
        if set(got) != set(want):
            raise AssertionError(f'{what}: keys {sorted(got)} vs {sorted(want)}')
        got, want = [got[k] for k in sorted(got)], [want[k] for k in sorted(got)]
    for i, (a, b) in enumerate(zip(got, want)):
        if not torch_equal(a, b):
            raise AssertionError(f'{what}: tensor {i} of {len(got)} differs, max |err| '
                                 f'{max_err(a, b):.3g}')


def torch_equal(a, b):
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


def check_update_counts(name, counts, updates):
    """Each update of a path is a replay of the update graph, or the eager
    warm-up of a capture: replays + captures == updates."""
    r, c = counts['update_replays'], counts['update_captures']
    log(f'  {name}: {updates} updates, {r} update graph replays, {c} captures')
    if r + c != updates or r <= 0:
        raise AssertionError(f'{name}: {updates} updates, {r} replays, {c} captures')


def hold_update_graph(label, agent, batch):
    """One update through the agent's CUDA graph (a replay) against the eager
    body `_update` from the same state, on `batch` with the same draws:
    every info value, the parameters, target heads, both Adam states and
    the scale bit for bit. Returns the eager step's info."""
    from tdmpc2_tpu_torch.utils.cuda_graph import Graph
    with_update_graph(agent, batch)
    saved = snapshot(agent)
    noise = agent.draw_update_noise()
    replays = Graph.replays.get('update', 0)
    info_g = clone_info(agent._step(batch, noise))
    if Graph.replays['update'] != replays + 1:
        raise AssertionError(f'update graph {label}: not one replay')
    after_g = snapshot(agent)
    restore(agent, saved)
    info_e = agent._update(agent.state, *batch[:4], noise, *batch[4:])
    same_bits(f'update graph {label}: info', info_g, info_e)
    same_bits(f'update graph {label}: train state', after_g, snapshot(agent))
    agent._prep = None
    log(f'  {label}: one replay of the update graph equals the eager body bit for bit '
        f'({len(info_e)} info values, {len(after_g)} state tensors)')
    return info_e


def update_record(label, agent, batch, buffer=None, reps=20):
    """The update on `batch`, eager body against its graph: ms by CUDA events
    (the graph's with its inputs' copies), device-busy ms and device
    activities by torch.profiler; the capture's ms (the eager warm-up,
    which is a real update, and the capture), the graph's pool bytes; with
    `buffer`, `update(buffer)` (the sample, the draws, the replay). The
    train state is put back afterwards."""
    import torch
    saved = snapshot(agent)
    noise = agent.draw_update_noise()
    agent._graphs.pop('update', None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agent._step(batch, noise)
    torch.cuda.synchronize()
    rec = {'capture_ms': 1e3 * (time.perf_counter() - t0),
           'pool_bytes': agent._graphs['update'][0].pool_bytes}

    def eager():
        return agent._update(agent.state, *batch[:4], noise, *batch[4:])

    def graph():
        return agent._step(batch, noise)
    for name, fn in (('eager', eager), ('graph', graph)):
        rec[f'{name}_ms'] = time_ms(fn, reps)
        busy, n_dev, top = device_share(fn, max(2, reps // 4))
        rec[f'{name}_device_ms'], rec[f'{name}_activities'] = busy, n_dev
        if name == 'graph':
            rec['top'] = [(round(t, 4), round(n, 1), k[:80]) for t, n, k in top]
    if buffer is not None:
        rec['update_ms'] = time_ms(lambda: agent.update(buffer), reps)
    restore(agent, saved)
    log(f'  {label} update: eager body {rec["eager_ms"]:.3f} ms (device busy '
        f'{rec["eager_device_ms"]} ms, {rec["eager_activities"]:.0f} activities), graph '
        f'{rec["graph_ms"]:.3f} ms (device busy {rec["graph_device_ms"]} ms, '
        f'{rec["graph_activities"]:.0f} activities)'
        + (f', update(buffer) {rec["update_ms"]:.3f} ms' if buffer is not None else '')
        + f' (CUDA events; profiler); capture {rec["capture_ms"]:.1f} ms (host clock, '
        f'its eager warm-up included), pool {rec["pool_bytes"] / 1e6:.1f} MB')
    return rec


def hold_update_many(agent, buf, n):
    """`update_many(n)` through the graph against n eager steps on the same
    sample_many(n) draw and draws: info and train state bit for bit."""
    saved = snapshot(agent)
    gens = (agent.generator.get_state(), buf.generator.get_state())
    info_g = clone_info(agent.update_many(buf, n))
    after_g = snapshot(agent)
    restore(agent, saved)
    agent.generator.set_state(gens[0])
    buf.generator.set_state(gens[1])
    batch = buf.sample_many(n)
    for i in range(n):
        info_e = agent._update(agent.state, *[x[i] for x in batch[:4]],
                               agent.draw_update_noise(), *[x[i] for x in batch[4:]])
    agent._prep = None
    same_bits(f'update_many({n}): info', info_g, info_e)
    same_bits(f'update_many({n}): train state', after_g, snapshot(agent))
    log(f'  update_many({n}): {n} graph replays equal {n} eager steps bit for bit')


def hold_schedules(agent, buf, obs, t0, n):
    """`vec_step` against `act` + `update_many` from the same state and
    generators, with n updates and with none: actions, info, the train
    state and the warm starts bit for bit."""
    import torch
    start = snapshot(agent, warm=True)
    gens = (agent.generator.get_state(), buf.generator.get_state())
    for k in (n, 0):
        runs = {}
        for name in ('act + update_many', 'vec_step'):
            restore(agent, start, warm=True)
            agent.generator.set_state(gens[0])
            buf.generator.set_state(gens[1])
            if name == 'vec_step':
                a, info = agent.vec_step(buf, obs, t0, k)
            else:
                a, info = agent.act(obs, t0=t0), (agent.update_many(buf, k) if k else None)
            runs[name] = (a, clone_info(info or {}), snapshot(agent, warm=True))
        a0, i0, s0 = runs['act + update_many']
        a, info, st = runs['vec_step']
        same_bits(f'vec_step, {k} updates: actions', [torch.from_numpy(a)],
                  [torch.from_numpy(a0)])
        same_bits(f'vec_step, {k} updates: info', info, i0)
        same_bits(f'vec_step, {k} updates: train state and warm starts', st, s0)
    log(f'  N={len(obs)}: vec_step with {n} updates and with none equals act + '
        f'update_many({n}) and act bit for bit (actions, info, train state, warm starts)')


def hold_update(agent, batch):
    """One update of `agent` on the card, a replay of its update graph,
    against the same update of a copy of its state on the CPU, on `batch`
    with the same draws: every info value, the parameters, target heads and
    Adam states at UPDATE_TOL."""
    from tdmpc2_tpu_torch.tdmpc2 import TDMPC2
    from tdmpc2_tpu_torch.utils import tree
    from tdmpc2_tpu_torch.utils.cuda_graph import Graph
    with_update_graph(agent, batch)
    cpu_agent = TDMPC2(agent.cfg, device='cpu')
    cpu_agent.state = agent.state.to('cpu')
    u_noise = agent.draw_update_noise()
    cpu_batch = [x.cpu() for x in batch]
    cpu_noise = type(u_noise)(**{
        k: (None if v is None else v.cpu()) for k, v in vars(u_noise).items()})
    replays = Graph.replays.get('update', 0)
    info_k = agent._step(batch, u_noise)
    if Graph.replays['update'] != replays + 1:
        raise AssertionError('update: not a replay of the update graph')
    info_c = cpu_agent._update(cpu_agent.state, *cpu_batch[:4], cpu_noise,
                               *cpu_batch[4:])
    if set(info_k) != set(info_c):
        raise AssertionError('update: the info keys differ')
    for k in sorted(info_c):
        hold(f'update {k}', info_k[k].cpu(), info_c[k], UPDATE_TOL)
    got, ref = agent.state.to('cpu'), cpu_agent.state
    for name in ('params', 'target_Qs', 'opt_state', 'pi_opt_state'):
        e = [max_err(a, b) for a, b in zip(tree.leaves(getattr(got, name)),
                                            tree.leaves(getattr(ref, name)))]
        bad = [a for a, b in zip(tree.leaves(getattr(got, name)),
                                 tree.leaves(getattr(ref, name)))
               if bool(((a.float() - b.float()).abs() > UPDATE_TOL['atol']
                        + UPDATE_TOL['rtol'] * b.float().abs()).any())]
        log(f'  {name}: max |err| {max(e):.3g}')
        if bad:
            raise AssertionError(f'update: {name} outside {UPDATE_TOL}')
    agent._prep = None
    return clone_info(info_k)


def bf16_twin_hold(label, ag, batch, records):
    """The bf16 update beside the f32 agent `ag`'s: a `bf16_update=true`
    agent on a copy of its state. Its update graph against its eager body
    bit for bit (`hold_update_graph`); one bf16 update against one f32
    update from the same state, batch and draws under JAX's contract; its
    plan against `ag`'s on the same draws bit for bit (acting stays f32);
    its eager and graph times (`update_record`) into records[f'{label} bf16']. `ag`'s
    state, warm starts and generator are put back."""
    import numpy as np
    import torch
    from tdmpc2_tpu_torch.tdmpc2 import TDMPC2
    from tdmpc2_tpu_torch.utils import tree
    twin = TDMPC2(ag.cfg.replace(bf16_update=True), device='cuda')
    twin.state = ag.state.to(ag.device)
    if twin.model_upd.dtype != torch.bfloat16 or twin.model.dtype is not None:
        raise AssertionError(f'{label} bf16: the update view is not bf16')
    hold_update_graph(f'{label} bf16', twin, batch)
    # the hold left the twin one eager step on: back to `ag`'s state
    gen = ag.generator.get_state()
    saved_f = snapshot(ag, warm=True)
    restore(twin, saved_f, warm=True)
    saved_b = snapshot(twin, warm=True)
    noise = ag.draw_update_noise()
    info_f = ag._update(ag.state, *batch[:4], noise, *batch[4:])
    info_b = twin._update(twin.state, *batch[:4], noise, *batch[4:])
    loss_share = {}
    for k in BF16_LOSSES:
        a, b = float(info_f[k]), float(info_b[k])
        loss_share[k] = abs(a - b) / max(abs(a), 1.0)
        if not math.isfinite(b) or loss_share[k] > BF16_LOSS_SHARE:
            raise AssertionError(f'{label} bf16: {k} {b} against f32 {a}')
    p_err = 0.0
    for pf, pb in zip(tree.leaves(ag.state.params), tree.leaves(twin.state.params)):
        if pb.dtype != torch.float32:
            raise AssertionError(f'{label} bf16: a master weight in {pb.dtype}')
        p_err = max(p_err, max_err(pf, pb))
    if p_err > BF16_PARAM_ATOL:
        raise AssertionError(f'{label} bf16: params {p_err:.3g} from the f32 update\'s')
    log(f'  {label} bf16 vs f32, one update: losses within '
        f'{100 * max(loss_share.values()):.3f}% of max(|f32|, 1) '
        f'({ {k: round(v, 5) for k, v in loss_share.items()} }), params within '
        f'{p_err:.3g} (contract {100 * BF16_LOSS_SHARE:.0f}%, {BF16_PARAM_ATOL})')
    restore(ag, saved_f, warm=True)
    restore(twin, saved_b, warm=True)
    n = min(ag.prev_mean.shape[0], N_ENVS)
    obs = batch[0][0, :n]
    task = batch[4][:n].int() if len(batch) > 4 else None
    pnoise = ag.draw_noise(n)
    t0 = np.arange(n) % 2 == 0
    got = [x.clone() for x in twin.plan_vec(obs, t0, noise=pnoise, task=task)]
    want = [x.clone() for x in ag.plan_vec(obs, t0, noise=pnoise, task=task)]
    same_bits(f'{label} bf16: the plan (actions, means)', got, want)
    restore(ag, saved_f, warm=True)
    ag.generator.set_state(gen)
    log(f'  {label} bf16: the plan at n={n} equals the f32 agent\'s bit for bit')
    records[f'{label} bf16'] = dict(update_record(f'{label} bf16', twin, batch, reps=8),
                                    loss_share=max(loss_share.values()), param_err=p_err)
    del twin
    torch.cuda.empty_cache()


def fleet_phases(zero_counts, read_counts, check_plan_counts):
    """The seed fleet at the default 5M config on toy-reach: seed k's plan
    and update against the single agent of seed k bit for bit; `train
    seeds=3,7,11` with 2 env copies a seed and with one, and the episodic
    fleet, each with the counts zeroed just before and read after; each
    seed's artifacts; the launches and replays of one fleet `act` and of
    one update step; env-steps/s of the trained fleet, a seed and in all.
    Returns (launch counts by path, metrics)."""
    import numpy as np
    import torch
    from tdmpc2_tpu_torch import train as train_mod
    from tdmpc2_tpu_torch.config import load_cfg
    from tdmpc2_tpu_torch.envs import make_env
    from tdmpc2_tpu_torch.fleet import FleetAgent
    from tdmpc2_tpu_torch.ops import probe
    from tdmpc2_tpu_torch.tdmpc2 import TDMPC2
    from tdmpc2_tpu_torch.trainer.fleet_online import FleetOnlineTrainer
    dev = torch.device('cuda')
    K, N = len(FLEET_SEEDS), FLEET_ENVS
    seeds = ','.join(map(str, FLEET_SEEDS))
    paths, metrics = {}, {}

    with Phase(f'fleet: seed k\'s plan and update against the single agent of seed k, '
               f'bit for bit (K={K}, {N} envs a seed, 5M model)'):
        cfg = load_cfg(overrides=['task=toy-reach', f'num_envs={N}', 'device=cuda'])
        make_env(cfg)
        fleet = FleetAgent(cfg, FLEET_SEEDS)
        singles = [TDMPC2(cfg.replace(seed=s), device='cuda') for s in FLEET_SEEDS]
        for k, single in enumerate(singles):
            same_bits(f'fleet seed {k}: the initial state', snapshot(fleet.agents[k], True),
                      snapshot(single, True))
            gk = torch.Generator().manual_seed(FLEET_SEEDS[k])
            p = perturbed(single.model.init(gk), gk)
            fleet.agents[k].load_params(p)
            single.load_params(p)
        g = torch.Generator(device=dev).manual_seed(SEED)
        obs = torch.randn(K, N, cfg.obs_shape['state'][0], device=dev, generator=g)
        for t0 in (True, False):
            noise = [s.draw_noise(N) for s in singles]
            a = fleet.act(obs.cpu().numpy(), t0=t0, noise=noise)
            for k, s in enumerate(singles):
                a_s, m_s = s.plan_vec(obs[k], np.full(N, t0), noise=noise[k])
                same_bits(f'fleet seed {k}: the plan (t0={t0})',
                          [torch.from_numpy(a[k]), fleet.agents[k].prev_mean],
                          [a_s.cpu(), s.prev_mean])
        T, B, A = cfg.horizon, cfg.batch_size, cfg.action_dim
        batch = (torch.randn(K, 1, T + 1, B, obs.shape[-1], device=dev, generator=g),
                 torch.rand(K, 1, T, B, A, device=dev, generator=g) * 2 - 1,
                 torch.rand(K, 1, T, B, 1, device=dev, generator=g),
                 torch.zeros(K, 1, T, B, 1, device=dev))
        for rep in range(2):          # the capture's eager warm-up, then a replay
            unoise = [[s.draw_update_noise()] for s in singles]
            info = fleet._update_batches(batch, 1, unoise)
            infos = [clone_info(s._step(tuple(x[k, 0] for x in batch), unoise[k][0]))
                     for k, s in enumerate(singles)]
            for k, s in enumerate(singles):
                same_bits(f'fleet seed {k}: the update ({"capture" if rep == 0 else "replay"})',
                          snapshot(fleet.agents[k]), snapshot(s))
            mean = {key: torch.stack([i[key] for i in infos]).mean(0) for key in infos[0]}
            same_bits('fleet: the seed-averaged info', info, mean)
        log(f'  {K} seeds: the initial states, the plans (t0 and warm starts: actions and '
            'means) and two updates (a capture, a replay) equal the single agents\' bit '
            'for bit')
        del fleet, singles

    orig_env = train_mod.make_fleet_env

    def fleet_path(name, extra, seed_steps, steps):
        """`train seeds=...` with the seed phase cut to `seed_steps`, the
        counts zeroed just before and read after; (trainer, counts, s)."""
        def cut(cfg, s):
            env = orig_env(cfg, s)
            cfg.seed_steps = seed_steps
            return env
        train_mod.make_fleet_env = cut
        try:
            probe._verdict = None       # as in a fresh process
            zero_counts()
            t0 = time.perf_counter()
            tr = train_mod.main([f'seeds={seeds}', f'steps={steps}', f'eval_freq={steps}',
                                 'eval_episodes=1', 'device=cuda',
                                 f'exp_name=chip_smoke_{name}', *extra])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read_counts()
        finally:
            train_mod.make_fleet_env = orig_env
        if not isinstance(tr, FleetOnlineTrainer) or tr.K != K:
            raise AssertionError(f'{name}: not a fleet of {K}')
        log(f'  {tr._step} env steps a seed ({K * tr._step} in all), {tr._n_updates} '
            f'updates a seed in {secs:.1f} s ({K * tr._step / secs:.1f} env-steps/s in all '
            f'over the whole run); launches {counts}')
        check_update_counts(name, counts, K * tr._n_updates)
        if counts['update_captures'] != K:
            raise AssertionError(f'{name}: {counts["update_captures"]} update captures')
        for k in ('value_sampled', 'cem_pi_rollout', 'cem_elite', 'probe'):
            if counts[k] <= 0:
                raise AssertionError(f'{name}: kernel {k} never launched')
        check_plan_counts(name, counts)
        if tr._update_deficit != 0 or abs(tr._n_updates - tr._step) > tr.N:
            raise AssertionError(f'{name}: {tr._n_updates} updates for {tr._step} steps, '
                                 f'{tr._update_deficit} owed')
        for k, s in enumerate(FLEET_SEEDS):
            d = tr.agent.work_dir(k)
            csv = (d / 'eval.csv').read_text().splitlines()
            ckpt = d / 'models' / 'latest.pkl'
            log(f'  seed {s}: {d / "eval.csv"} ({len(csv) - 1} evals: '
                f'{csv[1:]}), {ckpt}')
            if len(csv) < 3 or not ckpt.exists():
                raise AssertionError(f'{name}: seed {s}\'s artifacts')
        return tr, counts, secs

    with Phase(f'path: train seeds={seeds} num_envs={N}, toy-reach, 5M model, '
               f'{FLEET_STEPS} env steps a seed'):
        tr, paths[f'train fleet K={K} x {N} envs'], secs = fleet_path(
            'fleet', [f'num_envs={N}', 'task=toy-reach'], FLEET_SEED_STEPS, FLEET_STEPS)
        single = TDMPC2(tr.cfg.replace(seed=FLEET_SEEDS[0], num_envs=N), device='cuda')
        single.load(tr.agent.work_dir(0) / 'models' / 'latest.pkl')
        same_bits('fleet seed 0: its checkpoint in a single agent', snapshot(single),
                  snapshot(tr.agent.agents[0]))
        log('  seed 0\'s checkpoint loads into a single agent bit for bit')
        metrics['whole_run_env_steps_per_s'] = K * tr._step / secs

    with Phase(f'fleet: the launches of one act and of one update step; env-steps/s of '
               f'the trained fleet ({FLEET_LOOP_STEPS} vector steps)'):
        fleet, buf, env = tr.agent, tr.buffer, tr.env
        obs = env.reset()
        o = obs.reshape(K, N, -1)
        fleet.act(o, t0=True)
        I = fleet.agents[0].iterations
        zero_counts()
        fleet.act(o, t0=False)
        act_counts = read_counts()
        zero_counts()
        fleet.update_many(buf, N)
        torch.cuda.synchronize()
        upd_counts = read_counts()
        log(f'  one fleet act: {act_counts["plan_replays"]} plan graph replays, '
            f'{act_counts["cem_pi_rollout"]} pi rollouts, {act_counts["value_sampled"]} '
            f'sampled value steps, {act_counts["cem_elite"]} elite steps (K={K} plans of '
            f'1 + 2 x {I} kernel calls, a replay each); one update step '
            f'(update_many({N})): {upd_counts["update_replays"]} update graph replays')
        if (act_counts['plan_replays'], act_counts['cem_pi_rollout'],
                act_counts['value_sampled'], act_counts['cem_elite']) != (K, K, K * I, K * I):
            raise AssertionError(f'one fleet act: {act_counts}')
        if upd_counts['update_replays'] != K * N or upd_counts['plan_replays']:
            raise AssertionError(f'one fleet update step: {upd_counts}')
        t_in = np.zeros(K * N, np.int64)
        ph = dict(step=0.0, env=0.0)
        torch.cuda.synchronize()
        t_all = time.perf_counter()
        for _ in range(FLEET_LOOP_STEPS):
            t1 = time.perf_counter()
            a, _ = fleet.step(buf, obs.reshape(K, N, -1), (t_in == 0).reshape(K, N), N)
            t2 = time.perf_counter()
            obs, _, dones, _ = env.step(a.reshape(K * N, -1))
            t_in += 1
            for j in np.flatnonzero(dones):
                obs[j] = env.reset_at(j)
                t_in[j] = 0
            ph['step'] += t2 - t1
            ph['env'] += time.perf_counter() - t2
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t_all) / FLEET_LOOP_STEPS
        busy, n_dev, _ = device_share(
            lambda: fleet.step(buf, obs.reshape(K, N, -1), False, N), 3)
        metrics.update(env_steps_per_s_a_seed=N / dt, env_steps_per_s=K * N / dt,
                       ms_per_vector_step=1e3 * dt, step_device_ms=busy,
                       step_activities=n_dev, act_launches=act_counts,
                       update_step_launches=upd_counts)
        log(f'  trained fleet, `step` (K plans, {N} updates a seed, one fetch) then the '
            f'envs: {1e3 * dt:.2f} ms a vector step, {N / dt:.1f} env-steps/s a seed, '
            f'{K * N / dt:.1f} in all (host clock; step {1e3 * ph["step"] / FLEET_LOOP_STEPS:.2f}'
            f' ms, env {1e3 * ph["env"] / FLEET_LOOP_STEPS:.2f} ms); one step\'s device busy '
            f'{busy} ms over {n_dev} activities (torch.profiler)')
        del fleet, buf, env, tr

    with Phase(f'path: train seeds={seeds} num_envs=1, toy-reach, 5M model, '
               f'{FLEET_STEPS} env steps a seed'):
        _, paths[f'train fleet K={K} x 1 env'], _ = fleet_path(
            'fleet_one_env', ['task=toy-reach'], FLEET_SEED_STEPS, FLEET_STEPS)

    with Phase(f'path: train seeds={seeds} {EP_TASK} episodic=true num_envs={N}, 5M '
               f'model, {FLEET_EP_STEPS} env steps a seed, the seed phase {FLEET_EP_SEED_STEPS}'):
        tr, paths['train fleet episodic'], _ = fleet_path(
            'fleet_episodic', [*EP_ARGS, f'num_envs={N}'], FLEET_EP_SEED_STEPS,
            FLEET_EP_STEPS)
        log(f'  {tr._n_updates} updates a seed for {tr._step} env steps, '
            f'{tr._update_deficit} owed at the end')
        del tr
    torch.cuda.empty_cache()
    return paths, metrics


ENV_N = 4                  # the env phase's env copies
ENV_BACKENDS = ('dm_control', 'gymnasium', 'mujoco')
ENV_CKPT = 'acrobot-swingup'   # evaluated on its real env where dm_control imports


def bits_equal(a, b):
    """Tensors equal bit for bit, NaN where NaN (torch.equal says NaN != NaN)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        a = a.contiguous().view({2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()])
        b = b.contiguous().view(a.dtype)
    return bool(torch.equal(a, b))


def env_phases(zero_counts, read_counts, check_plan_counts):
    """The env layer on the card. (a) `train toy-reach num_envs=ENV_N` at the
    default 5M config, TRAIN_STEPS env steps, with the env copies in worker
    processes (vec_mode=subproc) and then in this process (inproc), the
    same seed: the episode rewards, the replay buffer's contents and the
    final parameters bit for bit, the same launch counts, env-steps/s of
    each, and no worker left alive. (b) The factory on this machine: which
    backends import; without dm_control, `make_env(task=walker-walk)` raises
    the factory's ValueError naming it; with it, `evaluate` of the
    committed acrobot-swingup checkpoint for one episode on its real env.
    Returns (launch counts by path, metrics)."""
    import importlib
    import torch
    from tdmpc2_tpu_torch import train as train_mod
    from tdmpc2_tpu_torch.config import load_cfg
    from tdmpc2_tpu_torch.envs import make_env
    from tdmpc2_tpu_torch.envs.subproc import SubprocVecEnv
    from tdmpc2_tpu_torch.envs.vec import VecEnv
    from tdmpc2_tpu_torch.evaluate import evaluate
    from tdmpc2_tpu_torch.ops import probe
    from tdmpc2_tpu_torch.utils import tree
    planner = ('value_sampled', 'cem_pi_rollout', 'cem_elite')
    paths, metrics, runs = {}, {}, {}
    for mode, cls in (('subproc', SubprocVecEnv), ('inproc', VecEnv)):
        name = f'train, num_envs={ENV_N} vec_mode={mode}'
        with Phase(f'env copies: {name} (toy-reach, 5M model, {TRAIN_STEPS} env steps)'):
            probe._verdict = None       # as in a fresh process
            zero_counts()
            t0 = time.perf_counter()
            tr = train_mod.main([
                'task=toy-reach', f'steps={TRAIN_STEPS}', f'eval_freq={TRAIN_STEPS}',
                'eval_episodes=1', f'seed={SEED}', 'save_agent=false', 'device=cuda',
                f'exp_name=chip_smoke_env_{mode}', f'num_envs={ENV_N}', f'vec_mode={mode}'])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = paths[name] = read_counts()
            if type(tr.env) is not cls or tr.env.num_envs != ENV_N:
                raise AssertionError(f'{name}: the env is {type(tr.env).__name__}')
            for k in planner + ('probe',):
                if counts[k] <= 0:
                    raise AssertionError(f'{name}: kernel {k} never launched')
            check_plan_counts(name, counts)
            rate = tr._step / secs
            metrics[f'env_steps_per_s_{mode}'] = rate
            log(f'  {tr._step} env steps in {secs:.1f} s ({rate:.1f} env-steps/s over the '
                f'whole run); launches {counts}')
            runs[mode] = tr
    with Phase(f'env copies: worker processes against in-process copies, bit for bit'):
        sub, inp = runs['subproc'], runs['inproc']
        left = [p.pid for p in sub.env.procs if p.poll() is None]
        if left:
            raise AssertionError(f'env workers left alive: {left}')
        if paths[f'train, num_envs={ENV_N} vec_mode=subproc'] != \
                paths[f'train, num_envs={ENV_N} vec_mode=inproc']:
            raise AssertionError('the two runs launched the kernels differently')
        sb, ib = sub.buffer, inp.buffer
        if (sub._step, sb.num_eps) != (inp._step, ib.num_eps) or sb.num_eps < ENV_N:
            raise AssertionError(f'steps {sub._step} / {inp._step}, episodes '
                                 f'{sb.num_eps} / {ib.num_eps}')
        rewards = [torch.nansum(sb._storage['reward'][:sb.num_eps].float(), dim=1),
                   torch.nansum(ib._storage['reward'][:ib.num_eps].float(), dim=1)]
        checks = {'episode rewards': rewards,
                  **{f'buffer {k}': (sb._storage[k], ib._storage[k]) for k in ib._storage},
                  'buffer episode rows': (sb._ep_rows, ib._ep_rows),
                  **{f'parameter {i}': ab for i, ab in enumerate(zip(
                      tree.leaves(sub.agent.state.params), tree.leaves(inp.agent.state.params)))}}
        for what, (a, b) in checks.items():
            if not bits_equal(a, b):
                raise AssertionError(f'{what}: subproc and inproc differ, max |err| '
                                     f'{max_err(a.float().nan_to_num(), b.float().nan_to_num()):.3g}')
        log(f'  {sb.num_eps} episodes (rewards {[round(float(r), 3) for r in rewards[0][:8]]}'
            f'...), {len(checks)} tensors, the launch counts and '
            f'{len(sub.env.procs)} closed workers: equal; env-steps/s subproc '
            f'{metrics["env_steps_per_s_subproc"]:.1f}, inproc '
            f'{metrics["env_steps_per_s_inproc"]:.1f}')
        del runs, sub, inp
    with Phase('env factory on this machine: the backends, and the task it builds'):
        found = {}
        for b in ENV_BACKENDS:
            try:
                importlib.import_module(b)
                found[b] = True
            except ImportError:
                found[b] = False
        metrics['backends'] = found
        log('  backends: ' + ', '.join(f'{b} {"imports" if ok else "does not import"}'
                                       for b, ok in found.items()))
        if not found['dm_control']:
            try:
                make_env(load_cfg(overrides=['task=walker-walk', 'device=cuda']))
            except ValueError as e:
                msg = str(e)
                if 'Failed to make environment' not in msg or 'dm_control' not in msg:
                    raise AssertionError(f'walker-walk: the factory said {msg!r}') from e
                log(f'  walker-walk raises ValueError: {msg[:240]}...')
            else:
                raise AssertionError('walker-walk built without dm_control')
            log(f'  evaluate {ENV_CKPT} on its real env: not run (no dm_control here)')
            metrics['walker_walk_error'] = msg
        else:
            cfg = load_cfg(overrides=[f'task={ENV_CKPT}', 'eval_episodes=1', f'seed={SEED}',
                                      'device=cuda', f'checkpoint={CHECKPOINTS[ENV_CKPT][0]}'])
            zero_counts()
            res = evaluate(cfg)[ENV_CKPT]
            counts = paths[f'evaluate {ENV_CKPT} (dm_control)'] = read_counts()
            if not math.isfinite(res['reward']) or res['lengths'] != [500]:
                raise AssertionError(f'{ENV_CKPT}: {res}')
            check_plan_counts(f'evaluate {ENV_CKPT}', counts, res['plans'])
            metrics[f'{ENV_CKPT}_reward'] = res['reward']
            log(f'  evaluate {ENV_CKPT} from its checkpoint on its real env: reward '
                f'{res["reward"]:.4f} over one episode of {res["lengths"][0]} steps')
    return paths, metrics


def envs_only() -> int:
    """`--envs`: the build, the canary, then the env phases alone
    (env_phases), for a quick check of the env layer on the card."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    from tdmpc2_tpu_torch.config import load_cfg
    from tdmpc2_tpu_torch.ops import _build, probe
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    for name, (secs, _) in _build.build().items():
        log(f'  {name}.cu built in {secs:.1f} s')
    if not probe.kernel_engine_alive(torch.device('cuda')):
        raise AssertionError(f'canary: {probe.verdict()["reason"]}')
    _, zero_counts, read_counts, check_plan_counts = plan_counters(
        load_cfg(overrides=['task=toy-reach']).iterations)
    paths, metrics = env_phases(zero_counts, read_counts, check_plan_counts)
    log(f'[done] {time.perf_counter() - t_start:.1f} s')
    log(smi)
    log(json.dumps({'envs': metrics, 'launches': paths}, default=str))
    return 0


def bf16_fleet_only() -> int:
    """`--bf16-fleet`: the build, the canary, the bf16 update beside the f32
    one on a seeded 5M state agent and a 5M pixel agent, then the fleet
    phases, for a quick check of this slice on the card."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    from tdmpc2_tpu_torch.config import load_cfg
    from tdmpc2_tpu_torch.envs import make_env
    from tdmpc2_tpu_torch.ops import _build, probe
    from tdmpc2_tpu_torch.tdmpc2 import TDMPC2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    for name, (secs, _) in _build.build().items():
        log(f'  {name}.cu built in {secs:.1f} s')
    if not probe.kernel_engine_alive(torch.device('cuda')):
        raise AssertionError(f'canary: {probe.verdict()["reason"]}')
    dev = torch.device('cuda')
    records = {}
    for label, cfg in (('5M state', load_cfg(overrides=['task=toy-reach', f'seed={SEED}'])),
                       ('5M pixels', pixel_cfg())):
        with Phase(f'{label}: the bf16 update beside the f32 one'):
            if cfg.obs == 'state':
                make_env(cfg)
            ag = TDMPC2(cfg, device='cuda')
            gen = torch.Generator().manual_seed(SEED)
            ag.load_params(perturbed(ag.model.init(gen), gen))
            g = torch.Generator(device=dev).manual_seed(SEED)
            T, B, A = cfg.horizon, cfg.batch_size, cfg.action_dim
            shape = cfg.obs_shape[cfg.obs]
            o = (torch.randint(0, 256, (T + 1, B, *shape), device=dev, generator=g,
                               dtype=torch.uint8) if cfg.obs == 'rgb'
                 else torch.randn(T + 1, B, *shape, device=dev, generator=g))
            batch = (o, torch.rand(T, B, A, device=dev, generator=g) * 2 - 1,
                     torch.rand(T, B, 1, device=dev, generator=g), torch.zeros(T, B, 1, device=dev))
            hold_update_graph(label, ag, batch)
            update_record(label, ag, batch, reps=8)
            bf16_twin_hold(label, ag, batch, records)
            del ag
    _, zero_counts, read_counts, check_plan_counts = plan_counters(
        load_cfg(overrides=['task=toy-reach']).iterations)
    paths, metrics = fleet_phases(zero_counts, read_counts, check_plan_counts)
    log(f'[done] {time.perf_counter() - t_start:.1f} s')
    log(smi)
    log(json.dumps({'bf16_update': records, 'fleet': metrics, 'launches': paths},
                   default=str))
    return 0


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    t_start = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'False)', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from tdmpc2_tpu_torch import train as train_mod
        from tdmpc2_tpu_torch.config import load_cfg
        from tdmpc2_tpu_torch.data.buffer import Buffer
        from tdmpc2_tpu_torch.envs import make_env
        from tdmpc2_tpu_torch.evaluate import evaluate
        from tdmpc2_tpu_torch.models.layers import simnorm
        from tdmpc2_tpu_torch.ops import _build, cem, probe, rollout, value, wide
        from tdmpc2_tpu_torch.tdmpc2 import TDMPC2
        from tdmpc2_tpu_torch.trainer.online import OnlineTrainer
        from tdmpc2_tpu_torch.trainer.vec_online import VecOnlineTrainer
        from tdmpc2_tpu_torch.utils import tree
        from tdmpc2_tpu_torch.utils.cuda_graph import Graph
    except ImportError as e:
        print(f'chip_smoke: the port is not importable here ({e})',
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')

    with Phase('device'):
        smi = nvidia_smi_line()
        log(f'  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, '
            f'{torch.cuda.device_count()} device(s)')

    usage = {}   # ptxas: function -> (registers, spill stores, spill loads)
    with Phase('build'):
        for name, (secs, _) in _build.build().items():
            log(f'  {name}.cu built in {secs:.1f} s')
        for name in _build.SOURCES:
            _build.library(name)
            for fn, (regs, st, ld) in _build.ptxas_usage(
                    _build.ptxas_report(name)).items():
                usage[fn] = (regs, st, ld)
                log(f'    {name}.cu {fn}: {regs} registers, {st} bytes spill '
                    f'stores, {ld} bytes spill loads')

    results = {}
    with Phase('canary: kernel_engine_alive (child process, then here)'):
        if not probe.kernel_engine_alive(dev):
            raise AssertionError(f'canary: {probe.verdict()["reason"]}')
        log(f'  canary child {probe.verdict()["seconds"]:.2f} s')
        x_probe = torch.randn(probe.SHAPE, device=dev)
        results['probe'] = hold('probe', probe.add_one(x_probe),
                                probe.add_one_plain(x_probe), PROBE_TOL)
        # the float4 body's scalar head and tail: sizes not a multiple of 4,
        # and a view one float into its storage (x not 16-byte aligned)
        for n in (1, 3, 1027):
            x = torch.randn(n, device=dev)
            hold(f'probe n={n}', probe.add_one(x), probe.add_one_plain(x), PROBE_TOL)
        x = torch.randn(1028, device=dev)[1:]
        hold('probe n=1027 at storage offset 1', probe.add_one(x), probe.add_one_plain(x),
             PROBE_TOL)

    # the main path's model: toy-reach at the default 5M config
    cfg = load_cfg(overrides=['task=toy-reach', f'seed={SEED}'])
    make_env(cfg)
    agent = TDMPC2(cfg, device='cuda')
    H, S, A, E = cfg.horizon, cfg.num_samples, cfg.action_dim, cfg.num_elites
    L, n_pi, I = cfg.latent_dim, cfg.num_pi_trajs, agent.iterations
    gen = torch.Generator().manual_seed(SEED)
    agent.load_params(perturbed(agent.model.init(gen), gen))
    prep = agent.prep
    heads = dict(log_std_min=agent.model.log_std_min,
                 log_std_dif=agent.model.log_std_dif,
                 simnorm_dim=cfg.simnorm_dim)
    g = torch.Generator(device=dev).manual_seed(SEED)

    # one env: the planner kernels' operands with a leading env axis of 1
    with Phase(f'value kernel vs plain (S={S}, L={L}, H={H}, A={A})'):
        z0 = simnorm(torch.randn(S, L, device=dev, generator=g), cfg.simnorm_dim)
        actions = torch.rand(H, S, A, device=dev, generator=g) * 2 - 1
        eps = torch.randn(S, A, device=dev, generator=g)
        qidx = torch.tensor([1, 3], dtype=torch.int32, device=dev)
        v_args = (prep, z0[None], actions[None], eps[None], qidx[None],
                  agent.discs[None])
        v_k = value.value_estimate(*v_args, **heads)
        v_p = value.value_estimate_plain(*v_args, **heads)
        torch.cuda.synchronize()
        if v_k.shape != (1, S, 1) or float(v_p.std()) == 0.0:
            raise AssertionError('value: wrong shape or tied values')
        results['value'] = hold('value', v_k, v_p, VALUE_TOL)
        log(f'  value range [{float(v_p.min()):.3f}, {float(v_p.max()):.3f}]')

    plans = {}
    wide_kernels = ('gemm_kernel', 'row_kernel<', 'row_narrow_kernel<', 'stage_kernel')
    with Phase('plans of the tensor-core kernels (default 5M model): the row tiles, '
               'and the wide engine the rollout takes'):
        for kname in ('value', 'pi_rollout', 'rollout'):
            plans[kname] = pl = value.kernel_plan(prep, cfg.simnorm_dim, H, kname)
            if pl['route'] == 'rows':
                regs = {k: v for k, v in usage.items() if k.startswith(kname + '_kernel<')}
                log(f'  {kname}_kernel: RT={pl["rt"]}, {pl["smem_bytes"]} bytes of shared '
                    f'memory, {pl["stages"]} ring stages, {pl["blocks_per_sm"]} block(s) '
                    f'per SM; ptxas {regs}')
            else:
                regs = {k: v for k, v in usage.items() if k.startswith(wide_kernels)}
                log(f'  {kname} (wide engine): product blocks of {pl["bm"]} rows x '
                    f'{pl["bn"]} columns ({pl["wgs"]} consumer warpgroup(s) on wgmma, a '
                    f'producer warpgroup issuing TMA), K {pl["bk"]} a stage, {pl["stages"]} '
                    f'stages, {pl["smem_bytes"]} bytes of shared memory, '
                    f'{pl["blocks_per_sm"]} block(s) per SM, {pl["regs"]} registers a thread '
                    f'at launch; ptxas {regs}')
            if pl['blocks_per_sm'] < 1:
                raise AssertionError(f'{kname}: no block fits an SM')
        if (plans['value']['route'], plans['pi_rollout']['route'],
                plans['rollout']['route']) != ('rows', 'rows', 'wide'):
            raise AssertionError(f'engines at the default widths: {plans}')
        log(f'  device functions: '
            f'{ {k: v for k, v in usage.items() if "_layer<" in k} }')

    with Phase('plain value (f32) vs the model heads (f32)'):
        prep32 = value.prepare_value_params(agent.params, cfg, torch.float32)
        n = 64
        hold('value_f32_vs_heads',
             value.value_estimate_plain(
                 prep32, z0[None, :n], actions[None, :, :n], eps[None, :n],
                 qidx[None], agent.discs[None], **heads)[0],
             agent._estimate_value(z0[:n], actions[:, :n], eps[:n], qidx),
             REF_TOL)

    dyn, rew = agent.params['dynamics'], agent.params['reward']
    r_kw = dict(horizon=H, discount=agent.discount,
                simnorm_dim=cfg.simnorm_dim)
    with Phase(f'rollout kernel vs plain (S={S}, L={L}, H={H}, A={A})'):
        prep_r = rollout.prepare_rollout_params(dyn, rew, L, cfg.vmin,
                                                cfg.vmax)
        r_args = (prep_r, z0, actions)
        G_k, zH_k = rollout.rollout_prepared(*r_args, **r_kw)
        G_p, zH_p = rollout.rollout_prepared_plain(*r_args, **r_kw)
        if G_k.shape != (S, 1) or zH_k.shape != (S, L):
            raise AssertionError('rollout: wrong output shapes')
        results['rollout'] = max(hold('rollout G', G_k, G_p, ROLLOUT_TOL),
                                 hold('rollout z_H', zH_k, zH_p, ROLLOUT_TOL))
        log(f'  G range [{float(G_p.min()):.3f}, {float(G_p.max()):.3f}]')

    obs = torch.randn(1, cfg.obs_shape['state'][0], device=dev, generator=g)
    zenc = agent.model.encode(agent.params, obs)
    noise = agent.draw_noise()      # one env's draws: a leading axis of 1

    with Phase(f'pi rollout kernel vs plain (n_pi={n_pi})'):
        pi_args = (prep, zenc[None], noise.pi_eps[:, :n_pi])
        pa_k = cem.pi_rollout(*pi_args, **heads)
        pa_p = cem.pi_rollout_plain(*pi_args, **heads)
        results['cem_pi_rollout'] = hold('pi_rollout', pa_k, pa_p, PI_TOL)

    mean0 = torch.zeros(1, H * A, device=dev)
    std0 = torch.full((1, H * A), cfg.max_std, device=dev)
    with Phase('fused value kernel (sampled mode) vs sample_actions_plain + value '
               'kernel, exact'):
        vs_args = (prep, zenc[None].expand(1, S, L), mean0 + 0.1, std0,
                   noise.sample[:, 0], pa_p, agent.amask, noise.eps[:, 0],
                   noise.qidx[:, 0], agent.discs[None])
        results['value_sampled'] = hold_sampled('one env', vs_args, heads)[0]
        v_in, acts = value.value_sampled(*vs_args, **heads)

    elite_kw = dict(num_elites=E, temperature=cfg.temperature,
                    min_std=cfg.min_std, max_std=cfg.max_std)
    with Phase('elite kernel vs plain on identical values'):
        errs = []
        for label, vv in (('distinct', v_in), ('all tied', torch.zeros_like(v_in))):
            mk, sk, gk = cem.elite_moments(vv, acts, agent.amask, **elite_kw)
            mp, sp, gp = cem.elite_moments_plain(vv, acts, agent.amask, **elite_kw)
            errs += [hold(f'elite mean ({label})', mk, mp, ELITE_TOL),
                     hold(f'elite std ({label})', sk, sp, ELITE_TOL),
                     hold(f'elite guarded v ({label})', gk, gp, GUARD_TOL)]
        results['cem_elite'] = max(errs)

    with Phase('elite kernel vs plain at its edges: S, HA, E, ties and guarded values'):
        ge = torch.Generator(device=dev).manual_seed(SEED)
        edge_err = 0.0
        for eS, eHA, eA in ELITE_EDGE_SHAPES:
            eacts = torch.rand(NE_EDGE, eS, eHA, device=dev, generator=ge) * 2 - 1
            emask = torch.ones(eA, device=dev)
            for kind in ('distinct', 'boundary ties', 'all tied', 'guarded'):
                ev = elite_edge_values(kind, NE_EDGE, eS, ge)
                for eE in sorted({1, min(E, eS), eS}):
                    ekw = dict(elite_kw, num_elites=eE)
                    got = cem.elite_moments(ev, eacts, emask, **ekw)
                    ref = cem.elite_moments_plain(ev, eacts, emask, **ekw)
                    tag = f'S={eS}, HA={eHA}, E={eE}, {kind}'
                    for j, tol in enumerate((ELITE_TOL, ELITE_TOL, GUARD_TOL)):
                        err = max_err(got[j], ref[j])
                        bad = (got[j] - ref[j]).abs() > tol['atol'] + tol['rtol'] * ref[j].abs()
                        if not bool(torch.isfinite(got[j]).all()) or bool(bad.any()):
                            raise AssertionError(f'elite {tag} [{j}]: max |err| {err:.3g} '
                                                 f'outside {tol}')
                        edge_err = max(edge_err, err if j < 2 else 0.0)
                    for i in range(NE_EDGE):
                        one = cem.elite_moments(ev[i:i + 1], eacts[i:i + 1], emask, **ekw)
                        if not all(torch.equal(a[i:i + 1], b) for a, b in zip(got, one)):
                            raise AssertionError(f'elite {tag}: env {i} of the '
                                                 f'N={NE_EDGE} launch differs from its '
                                                 'one-env launch')
            log(f'  S={eS}, HA={eHA}: 4 kinds of values x E in {{1, {min(E, eS)}, {eS}}}, '
                f'N={NE_EDGE} envs: within {ELITE_TOL}, guarded v exact, each env '
                'equal to its one-env launch bit for bit')
        log(f'  max |err| of mean/std over the edges {edge_err:.3g}')
        results['cem_elite'] = max(results['cem_elite'], edge_err)

    with Phase(f'cem_plan vs cem_plan_plain ({I} iterations)'):
        plan_kw = dict(iterations=I, n_pi=n_pi, **elite_kw, **heads)
        plan_args = (prep, zenc[None], noise.pi_eps, noise.sample, noise.eps,
                     noise.qidx, agent.discs[None], mean0, std0, agent.amask)
        mk, sk, vk, ak = cem.cem_plan(*plan_args, **plan_kw)
        mp, sp, vp, ap = cem.cem_plan_plain(*plan_args, **plan_kw)
        hold('cem_plan mean', mk, mp, CEM_TOL)
        hold('cem_plan std', sk, sp, CEM_TOL)
        if vk.shape != (1, S, 1) or ak.shape != (1, S, H * A):
            raise AssertionError('cem_plan: wrong output shapes')

    # the planner kernels' env axis, at the vectorised path's N and full width
    NE = N_ENVS
    obs_n = torch.randn(NE, cfg.obs_shape['state'][0], device=dev, generator=g)
    z_n = agent.model.encode(agent.params, obs_n)[:, None]          # [NE, 1, L]
    noise_n = agent.draw_noise(NE)
    discs_n = agent.discs.expand(NE, -1)
    mean_n = torch.rand(NE, H * A, device=dev, generator=g) * 0.4 - 0.2
    std_n = torch.rand(NE, H * A, device=dev, generator=g) * 1.9 + 0.1
    with Phase(f'N={NE} envs: each planner kernel vs plain, and vs {NE} '
               'one-env launches'):
        pa_n = cem.pi_rollout_plain(prep, z_n, noise_n.pi_eps[:, :n_pi], **heads)
        pi_n_args = (prep, z_n, noise_n.pi_eps[:, :n_pi])
        vs_n_args = (prep, z_n.expand(NE, S, L), mean_n, std_n, noise_n.sample[:, 0],
                     pa_n, agent.amask, noise_n.eps[:, 0], noise_n.qidx[:, 0], discs_n)
        acts_n = cem.sample_actions_plain(*vs_n_args[2:7])
        v_n_args = (prep, z_n.expand(NE, S, L),
                    acts_n.view(NE, S, H, A).permute(0, 2, 1, 3),
                    noise_n.eps[:, 0], noise_n.qidx[:, 0], discs_n)
        v_n_in = value.value_estimate_plain(*v_n_args, **heads)
        e_n_args = (v_n_in, acts_n, agent.amask)
        results['value_sampled'] = max(results['value_sampled'],
                                       hold_sampled(f'N={NE}', vs_n_args, heads)[0])
        n_env_calls = {
            'value': (value.value_estimate, value.value_estimate_plain, v_n_args,
                      heads, VALUE_TOL),
            'value_sampled': (value.value_sampled, value.value_sampled_plain,
                              vs_n_args, heads, VALUE_TOL),
            'cem_pi_rollout': (cem.pi_rollout, cem.pi_rollout_plain, pi_n_args,
                               heads, PI_TOL),
            'cem_elite': (cem.elite_moments, cem.elite_moments_plain, e_n_args,
                          elite_kw, ELITE_TOL),
        }
        shared = (prep, agent.amask)
        for name, (kern, plain, args, kw, tol) in n_env_calls.items():
            got, ref = as_tuple(kern(*args, **kw)), as_tuple(plain(*args, **kw))
            # the sampled actions (value_sampled's [1]) are exact
            errs = [hold(f'{name} N={NE} [{j}]', a, b,
                         SAMPLE_TOL if name == 'value_sampled' and j == 1 else tol)
                    for j, (a, b) in enumerate(zip(got, ref))]
            results[name] = max(results[name], *errs)
            for i in range(NE):
                one = as_tuple(kern(*[a if any(a is x for x in shared)
                                      else a[i:i + 1] for a in args], **kw))
                for a, b in zip(got, one):
                    if not torch.equal(a[i:i + 1], b):
                        raise AssertionError(f'{name}: env {i} of the N={NE} '
                                             'launch differs from its one-env launch')
            log(f'  {name}: the N={NE} launch equals {NE} one-env launches bit for bit')

    with Phase(f'plan_vec at N={NE} through the kernels vs cem_plan_plain'):
        plan_n_args = (prep, z_n, noise_n.pi_eps, noise_n.sample, noise_n.eps,
                       noise_n.qidx, discs_n, torch.zeros(NE, H * A, device=dev),
                       torch.full((NE, H * A), cfg.max_std, device=dev), agent.amask)
        mp, sp, vp, ap = cem.cem_plan_plain(*plan_n_args, **plan_kw)
        mk, sk, vk, ak = cem.cem_plan(*plan_n_args, **plan_kw)
        hold(f'cem_plan N={NE} mean', mk, mp, CEM_TOL)
        hold(f'cem_plan N={NE} std', sk, sp, CEM_TOL)
        if vk.shape != (NE, S, 1) or ak.shape != (NE, S, H * A):
            raise AssertionError('cem_plan N-env: wrong output shapes')
        agent.prev_mean = torch.zeros(NE, H, A, device=dev)
        a_pv, m_pv = agent.plan_vec(obs_n, np.ones(NE, bool), eval_mode=True,
                                    noise=noise_n)
        hold(f'plan_vec N={NE} means vs cem_plan_plain', m_pv.reshape(NE, H * A),
             mp, CEM_TOL)
        if a_pv.shape != (NE, A) or not bool(torch.isfinite(a_pv).all()):
            raise AssertionError('plan_vec: wrong or non-finite actions')

    # the value kernel's episodic branch, on toy-reach-episodic's agent at the
    # default 5M config, its termination head spread so that the flag splits
    ecfg = load_cfg(overrides=EP_ARGS + [f'seed={SEED}'])
    make_env(ecfg)
    e_agent = TDMPC2(ecfg, device='cuda')
    e_agent.load_params(perturbed(e_agent.model.init(gen), gen))
    split_termination(e_agent, g)
    e_prep = e_agent.prep
    e_discs_n = e_agent.discs.expand(NE, -1)

    def episodic_value_args(n):
        return (e_prep, simnorm(torch.randn(n, S, L, device=dev, generator=g),
                                cfg.simnorm_dim),
                torch.rand(n, H, S, A, device=dev, generator=g) * 2 - 1,
                torch.randn(n, S, A, device=dev, generator=g),
                torch.stack([torch.randperm(cfg.num_q, device=dev, generator=g)[:2]
                             for _ in range(n)]).to(torch.int32),
                e_agent.discs.expand(n, -1))

    def term_at_like(args):
        return torch.empty(args[1].shape[:2], dtype=torch.int32, device=dev)

    with Phase(f'episodic value kernel vs plain under the gate rule (one env '
               f'and N={NE})'):
        e_plan = value.kernel_plan(e_prep, cfg.simnorm_dim, H)
        log(f'  value kernel plan: {e_plan} (the same as without the head: the '
            'plan depends on the widths only)')
        if e_plan != plans['value']:
            raise AssertionError('value kernel: the episodic plan differs')
        ev1_args, evn_args = episodic_value_args(1), episodic_value_args(NE)
        errs = []
        for label, args in (('one env', ev1_args), (f'N={NE}', evn_args)):
            k_at, p_at = term_at_like(args), term_at_like(args)
            vk = value.value_estimate(*args, **heads, episodic=True, term_at=k_at)
            vp = value.value_estimate_plain(*args, **heads, episodic=True,
                                            term_at=p_at)
            logits, at = value.termination_trace_plain(*args[:3], args[5],
                                                       cfg.simnorm_dim)
            torch.cuda.synchronize()
            if not torch.equal(at, p_at):
                raise AssertionError('termination_trace_plain disagrees with the '
                                     'plain value step')
            shares = flag_shares(p_at, H)
            log(f'  {label}: rows flagged by step t=1..{H} (plain): '
                + ', '.join(f'{100 * x:.1f}%' for x in shares)
                + '; kernel: ' + ', '.join(f'{100 * x:.1f}%'
                                           for x in flag_shares(k_at, H)))
            if not FLAG_SPLIT[0] <= shares[-1] <= FLAG_SPLIT[1]:
                raise AssertionError(f'{label}: {100 * shares[-1]:.1f}% of the rows '
                                     f'flagged at t={H}: the gate is not split')
            errs.append(hold_gated(f'value episodic {label}', vk, vp, k_at, p_at,
                                   logits, VALUE_TOL))
        results['value_episodic'] = max(errs)
        k_at = term_at_like(evn_args)
        got = value.value_estimate(*evn_args, **heads, episodic=True, term_at=k_at)
        for i in range(NE):
            one_at = torch.empty(1, S, dtype=torch.int32, device=dev)
            one = value.value_estimate(e_prep, *[a[i:i + 1] for a in evn_args[1:]],
                                       **heads, episodic=True, term_at=one_at)
            if not (torch.equal(got[i:i + 1], one) and torch.equal(k_at[i:i + 1],
                                                                    one_at)):
                raise AssertionError(f'value episodic: env {i} of the N={NE} launch '
                                     'differs from its one-env launch')
        log(f'  value episodic: the N={NE} launch equals {NE} one-env launches bit '
            'for bit (values and flags)')
        # the planner's step on the episodic paths: the sampled mode with the gate
        evs_args = (e_prep, evn_args[1], mean_n, std_n, noise_n.sample[:, 1], pa_n,
                    agent.amask, *evn_args[3:])
        results['value_sampled_episodic'] = hold_sampled(
            f'episodic N={NE}', evs_args, heads, episodic=True)[0]
        got = value.value_sampled(*evs_args, **heads, episodic=True)
        for i in range(NE):
            one = value.value_sampled(*[a if a is e_prep or a is agent.amask
                                        else a[i:i + 1] for a in evs_args],
                                      **heads, episodic=True)
            if not all(torch.equal(a[i:i + 1], b) for a, b in zip(got, one)):
                raise AssertionError(f'value sampled episodic: env {i} of the N={NE} '
                                     'launch differs from its one-env launch')
        log(f'  value sampled episodic: the N={NE} launch equals {NE} one-env launches '
            'bit for bit (values and actions)')

    with Phase(f'episodic plan_vec at N={NE} through the kernels vs cem_plan_plain'):
        e_noise = e_agent.draw_noise(NE)
        z_e = e_agent.model.encode(e_agent.params, obs_n)[:, None]
        e_plan_args = (e_prep, z_e, e_noise.pi_eps, e_noise.sample, e_noise.eps,
                       e_noise.qidx, e_discs_n, torch.zeros(NE, H * A, device=dev),
                       torch.full((NE, H * A), cfg.max_std, device=dev),
                       e_agent.amask)
        e_plan_kw = dict(plan_kw, episodic=True)
        mp, sp, vp, ap = cem.cem_plan_plain(*e_plan_args, **e_plan_kw)
        mk, sk, vk, ak = cem.cem_plan(*e_plan_args, **e_plan_kw)
        hold(f'episodic cem_plan N={NE} mean', mk, mp, CEM_TOL)
        hold(f'episodic cem_plan N={NE} std', sk, sp, CEM_TOL)
        e_agent.prev_mean = torch.zeros(NE, H, A, device=dev)
        a_pv, m_pv = e_agent.plan_vec(obs_n, np.ones(NE, bool), eval_mode=True,
                                      noise=e_noise)
        hold(f'episodic plan_vec N={NE} means vs cem_plan_plain',
             m_pv.reshape(NE, H * A), mp, CEM_TOL)
        if a_pv.shape != (NE, A) or not bool(torch.isfinite(a_pv).all()):
            raise AssertionError('episodic plan_vec: wrong or non-finite actions')
        _, at = value.termination_trace_plain(
            e_prep, z_e.expand(NE, S, L), ap.view(NE, S, H, A).permute(0, 2, 1, 3),
            e_discs_n, cfg.simnorm_dim)
        log(f'  the last iteration\'s samples flagged by step t=1..{H} (plain): '
            + ', '.join(f'{100 * x:.1f}%' for x in flag_shares(at, H)))

    with Phase(f'plan_vec graph vs its eager body, bit for bit (n=1 and N={NE}, '
               'episodic too)'):
        for label, ag, n, ev in (('one env', agent, 1, False),
                                 (f'N={NE}, eval', agent, NE, True),
                                 (f'N={NE}', agent, NE, False),
                                 (f'episodic N={NE}', e_agent, NE, False)):
            hold_plan_graph(label, ag, n, ev, SEED + n)

    sweep = {}
    with Phase(f'width sweep: value (and its episodic branch), pi rollout and rollout '
               f'kernels vs plain at model_size {SWEEP_SIZES}, one env, S={S}'):
        for size in SWEEP_SIZES:
            wcfg = load_cfg(overrides=EP_ARGS + [f'seed={SEED}', f'model_size={size}'])
            make_env(wcfg)
            w_agent = TDMPC2(wcfg, device='cuda')
            # generators of its own: the later phases' draws stay as they were
            wg = torch.Generator().manual_seed(SEED + size)
            wgd = torch.Generator(device=dev).manual_seed(SEED + size)
            w_agent.load_params(perturbed(w_agent.model.init(wg), wg,
                                          sweep_scale(wcfg.mlp_dim)))
            split_termination(w_agent, wgd)
            w_prep, wL = w_agent.prep, wcfg.latent_dim
            wplan = value.kernel_plan(w_prep, wcfg.simnorm_dim, H)
            w_args = (w_prep,
                      simnorm(torch.randn(1, S, wL, device=dev, generator=wgd),
                              wcfg.simnorm_dim),
                      torch.rand(1, H, S, A, device=dev, generator=wgd) * 2 - 1,
                      torch.randn(1, S, A, device=dev, generator=wgd),
                      torch.randperm(wcfg.num_q, device=dev,
                                     generator=wgd)[None, :2].to(torch.int32),
                      w_agent.discs[None])
            tag = f'model_size {size} (L={wL}, M={wcfg.mlp_dim}, num_q={wcfg.num_q})'
            err_v = hold(f'{tag} value', value.value_estimate(*w_args, **heads),
                         value.value_estimate_plain(*w_args, **heads), VALUE_TOL)
            k_at, p_at = term_at_like(w_args), term_at_like(w_args)
            vk = value.value_estimate(*w_args, **heads, episodic=True, term_at=k_at)
            vp = value.value_estimate_plain(*w_args, **heads, episodic=True,
                                            term_at=p_at)
            logits, _ = value.termination_trace_plain(*w_args[:3], w_args[5],
                                                      wcfg.simnorm_dim)
            err_e = hold_gated(f'{tag} value episodic', vk, vp, k_at, p_at, logits,
                               VALUE_TOL)
            zw = w_agent.model.encode(w_agent.params, obs)
            pi_w = (w_prep, zw[None], w_agent.draw_noise().pi_eps[:, :n_pi])
            err_p = hold(f'{tag} pi_rollout', cem.pi_rollout(*pi_w, **heads),
                         cem.pi_rollout_plain(*pi_w, **heads), PI_TOL)
            wp_r = rollout.prepare_rollout_params(w_agent.params['dynamics'],
                                                  w_agent.params['reward'], wL,
                                                  wcfg.vmin, wcfg.vmax)
            wr_args = (wp_r, w_args[1][0], w_args[2][0])
            wr_kw = dict(horizon=H, discount=w_agent.discount, simnorm_dim=wcfg.simnorm_dim)
            Gw, zHw = rollout.rollout_prepared(*wr_args, **wr_kw)
            Gwp, zHwp = rollout.rollout_prepared_plain(*wr_args, **wr_kw)
            err_r = max(hold(f'{tag} rollout G', Gw, Gwp, ROLLOUT_TOL),
                        hold(f'{tag} rollout z_H', zHw, zHwp, ROLLOUT_TOL))
            results['rollout'] = max(results['rollout'], err_r)
            ms = time_ms(lambda: value.value_estimate(*w_args, **heads), 20)
            ms_pi = time_ms(lambda: cem.pi_rollout(*pi_w, **heads), 20)
            ms_r = time_ms(lambda: rollout.rollout_prepared(*wr_args, **wr_kw), 20)
            sweep[size] = dict(plan=wplan, value_err=err_v, episodic_err=err_e,
                               pi_err=err_p, rollout_err=err_r, value_ms=ms, pi_ms=ms_pi,
                               rollout_ms=ms_r)
            log(f'  {tag}: plan {wplan}; value kernel {ms:.4f} ms, pi rollout '
                f'{ms_pi:.4f} ms, rollout (wide engine) {ms_r:.4f} ms (CUDA events)')
            del w_agent, w_prep, w_args, wp_r, wr_args

    with Phase('weight prep: prepare_value_params with its packed copies, 5M model'):
        prep_ms = host_ms(lambda: value.prepare_value_params(agent.params, cfg), 20)
        pack_ms = host_ms(lambda: [
            value.pack_matrix(*[prep[p] for p in parts],
                              cat_dim=-1 if k == 'pP2' else -2)
            for k, parts in value.PACKED.items() if all(p in prep for p in parts)], 20)
        busy, n_dev, _ = device_share(
            lambda: value.prepare_value_params(agent.params, cfg), 5)
        log(f'  prepare_value_params {prep_ms:.3f} ms, of it packing {pack_ms:.3f} ms '
            f'(host clock, synchronised); device busy {busy} ms over {n_dev} '
            'activities (torch.profiler)')

        def refresh():
            agent._prep = None
            return agent.prep

        refresh()       # the prep graph is captured by now
        reps = 50
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            refresh()
        issue_ms = 1e3 * (time.perf_counter() - t0) / reps
        torch.cuda.synchronize()
        refresh_ms = host_ms(refresh, 20)
        r_busy, r_dev, _ = device_share(refresh, 5)
        if agent.prep is not prep:
            raise AssertionError('the prep refresh made new tensors')
        log(f'  prep refresh (the prep graph replayed in place): host {issue_ms:.4f} ms '
            f'to issue, {refresh_ms:.3f} ms synchronised (host clock); device busy '
            f'{r_busy} ms over {r_dev} activities (torch.profiler)')

    wrappers, zero_counts, read_counts, check_plan_counts = plan_counters(I)
    planner = ('value_sampled', 'cem_pi_rollout', 'cem_elite')

    with Phase('path: evaluate toy-reach, 5M model, 2 episodes'):
        ev_cfg = load_cfg(overrides=['task=toy-reach', 'eval_episodes=2',
                                     f'seed={SEED}', 'device=cuda'])
        zero_counts()
        res = evaluate(ev_cfg)['toy-reach']
        ev_launches = read_counts()
        log(f'  reward {res["reward"]:.4f}, {res["plans"]} plans, '
            f'{res["plans"] / res["seconds"]:.1f} plans/s; launches {ev_launches}')
        if not math.isfinite(res['reward']):
            raise AssertionError('evaluate: non-finite reward')
        for k in planner:
            if ev_launches[k] <= 0:
                raise AssertionError(f'evaluate: kernel {k} never launched')
        check_plan_counts('evaluate', ev_launches, res['plans'])

    with Phase(f'path: fused_value_rollout (S={S}, H={H}, 5M heads)'):
        zero_counts()
        G_e, zH_e = rollout.fused_value_rollout(
            dyn, rew, z0, actions, vmin=cfg.vmin, vmax=cfg.vmax, **r_kw)
        ro_launches = read_counts()
        log(f'  launches {ro_launches}')
        if ro_launches['rollout'] <= 0:
            raise AssertionError('fused_value_rollout: the kernel never launched')
        if not (bool(torch.isfinite(G_e).all()) and bool(torch.isfinite(zH_e).all())):
            raise AssertionError('fused_value_rollout: non-finite output')
        hold('fused_value_rollout G vs rollout_prepared', G_e, G_k,
             dict(rtol=0.0, atol=0.0))

    # the training paths, as `python -m tdmpc2_tpu_torch.train` runs them: a
    # fresh process has no canary verdict yet, so agent construction runs it
    update_step = TDMPC2._step
    orig_evals = {c: c.eval for c in (OnlineTrainer, VecOnlineTrainer)}
    orig_add = Buffer.add

    def train_path(name, extra, schedule=()):
        """Run `train` with the counts zeroed just before; returns (trainer,
        launches, seconds, eval results, lengths of the episodes flushed to
        the buffer) and logs the [total, pi, termination] losses. Each of
        the agent's calls in `schedule` must have been made."""
        losses, evals, lengths = [], [], []
        calls = {k: 0 for k in schedule}
        orig_calls = {k: getattr(TDMPC2, k) for k in schedule}

        def counted(k):
            def run(self, *args, **kw):
                calls[k] += 1
                return orig_calls[k](self, *args, **kw)
            return run

        def recording_update(self, *args):
            info = update_step(self, *args)
            losses.append(torch.stack([info['total_loss'], info['pi_loss'],
                                       info['termination_loss']]))
            return info

        def recording_add(self, ep):
            lengths.append(int(ep.get('valid_rows', len(ep['reward']))) - 1)
            return orig_add(self, ep)

        def recording_eval(cls):
            def run(self):
                evals.append(orig_evals[cls](self))
                return evals[-1]
            return run
        TDMPC2._step = recording_update
        Buffer.add = recording_add
        for c in orig_evals:
            c.eval = recording_eval(c)
        for k in schedule:
            setattr(TDMPC2, k, counted(k))
        try:
            probe._verdict = None       # as in a fresh process
            zero_counts()
            t0 = time.perf_counter()
            tr = train_mod.main([
                'task=toy-reach', f'steps={TRAIN_STEPS}',
                f'eval_freq={TRAIN_STEPS}', 'eval_episodes=1', f'seed={SEED}',
                'save_agent=false', 'device=cuda', f'exp_name=chip_smoke_{name}',
                *extra])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read_counts()
        finally:
            TDMPC2._step = update_step
            Buffer.add = orig_add
            for c, f in orig_evals.items():
                c.eval = f
            for k, f in orig_calls.items():
                setattr(TDMPC2, k, f)
        losses = torch.stack(losses)
        if schedule:
            log(f'  the collection schedule\'s calls: {calls}')
            if not all(calls.values()):
                raise AssertionError(f'{name}: the schedule\'s calls {calls}')
        log(f'  {tr._step} env steps, {len(losses)} updates in {secs:.1f} s '
            f'({tr._step / secs:.1f} env-steps/s over the whole run); '
            f'launches {counts}; canary child {probe.verdict()["seconds"]:.2f} s')
        log(f'  last losses: total {float(losses[-1, 0]):.4f}, '
            f'pi {float(losses[-1, 1]):.4f}, termination {float(losses[-1, 2]):.4f}')
        log(f'  eval reward: {[round(e["episode_reward"], 4) for e in evals]}, '
            f'mean eval episode length {[e["episode_length"] for e in evals]}')
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError(f'{name}: non-finite loss')
        # the seed_steps burst at step seed_steps, then one per later env step,
        # each a replay of the update graph but the capture's eager warm-up
        check_update_counts(name, counts, len(losses))
        if len(losses) != TRAIN_STEPS:
            raise AssertionError(f'{name}: {len(losses)} updates')
        for k in planner + ('probe',):
            if counts[k] <= 0:
                raise AssertionError(f'{name}: kernel {k} never launched')
        check_plan_counts(name, counts)
        if not evals or not all(math.isfinite(e['episode_reward']) for e in evals):
            raise AssertionError(f'{name}: eval results {evals}')
        return tr, counts, secs, evals, lengths, losses

    def check_episodic(name, lengths, losses=None):
        """Episodes must end early on this task, and the termination loss
        (losses[:, 2]) must not be zero."""
        short = sorted(x for x in lengths if x < MAX_EP_LEN)
        log(f'  episode lengths: {len(lengths)} episodes, {len(short)} shorter '
            f'than {MAX_EP_LEN}: {short}')
        if not short:
            raise AssertionError(f'{name}: no episode ended before the time limit')
        if losses is not None and not float(losses[-1, 2]) > 0:
            raise AssertionError(f'{name}: the termination loss is zero')

    # the two toy-reach runs save their checkpoints and replay snapshots, from
    # which checkpoint_phases resumes them
    snap = ['save_agent=true', f'buffer_snapshot_eps={SNAPSHOT_EPS}']
    with Phase(f'path: train toy-reach, 5M model, {TRAIN_STEPS} steps, one env'):
        trainer, launches, _, _, _, _ = train_path('one_env', snap)

    with Phase(f'main path (vectorised): train toy-reach num_envs={NE}, 5M '
               f'model, {TRAIN_STEPS} env steps'):
        vtrainer, vec_launches, vec_s, vec_evals, _, _ = train_path(
            'vec', [f'num_envs={NE}', *snap], ('vec_step',))
        if not isinstance(vtrainer, VecOnlineTrainer) or vtrainer._n != NE:
            raise AssertionError('vec path: not the vectorised trainer')
        if len(vec_evals) < 2:
            raise AssertionError(f'vec path: eval results {vec_evals}')

    env_paths, env_metrics = env_phases(zero_counts, read_counts, check_plan_counts)

    with Phase(f'path: train {EP_TASK} episodic=true, 5M model, {TRAIN_STEPS} '
               'steps, one env'):
        ep_trainer, ep_launches, _, ep_evals, ep_lengths, ep_losses = train_path(
            'episodic_one_env', EP_ARGS)
        check_episodic('episodic one env', ep_lengths + [
            round(e['episode_length']) for e in ep_evals], ep_losses)
    with Phase(f'path: train {EP_TASK} episodic=true num_envs={NE}, 5M model, '
               f'{TRAIN_STEPS} env steps'):
        vep_trainer, vep_launches, _, vep_evals, vep_lengths, vep_losses = train_path(
            'episodic_vec', EP_ARGS + [f'num_envs={NE}', 'save_agent=true'], ('vec_step',))
        check_episodic(f'episodic num_envs={NE}', vep_lengths + [
            round(e['episode_length']) for e in vep_evals], vep_losses)

    with Phase(f'path: train toy-reach bf16_update=true, 5M model, {TRAIN_STEPS} steps, '
               'one env'):
        bf_trainer, bf16_launches, _, _, _, _ = train_path('bf16', ['bf16_update=true'])
        if bf_trainer.agent.model_upd.dtype != torch.bfloat16:
            raise AssertionError('bf16 path: the update view is not bf16')
        del bf_trainer

    with Phase(f'path: evaluate {EP_TASK} episodic=true from the num_envs={NE} '
               f'run\'s checkpoint, {EP_EVAL_EPISODES} episodes'):
        ckpt = Path(vep_trainer.cfg.work_dir) / 'models' / 'latest.pkl'
        ev_ep_cfg = load_cfg(overrides=EP_ARGS + [
            f'eval_episodes={EP_EVAL_EPISODES}', f'seed={SEED}', 'device=cuda',
            f'checkpoint={ckpt}'])
        zero_counts()
        t0 = time.perf_counter()
        res = evaluate(ev_ep_cfg)[EP_TASK]
        ev_ep_launches = read_counts()
        log(f'  reward {res["reward"]:.4f}, success {res["success"]:.2f}, '
            f'{res["plans"]} plans, {res["plans"] / res["seconds"]:.1f} plans/s, '
            f'{time.perf_counter() - t0:.1f} s; launches {ev_ep_launches}')
        if not math.isfinite(res['reward']):
            raise AssertionError('episodic evaluate: non-finite reward')
        for k in planner:
            if ev_ep_launches[k] <= 0:
                raise AssertionError(f'episodic evaluate: kernel {k} never launched')
        check_plan_counts('episodic evaluate', ev_ep_launches, res['plans'])
        check_episodic('episodic evaluate', res['lengths'])
    t_agent, buffer, env = trainer.agent, trainer.buffer, trainer.env

    with Phase('one update on the card vs the same update on the CPU'):
        hold_update(t_agent, buffer.sample())

    with Phase('one episodic update on the card vs the same update on the CPU, '
               'a fifth of the batch terminated'):
        batch = list(ep_trainer.buffer.sample())
        batch[3] = (torch.rand(batch[3].shape, device=dev, generator=g) < 0.2).float()
        log(f'  terminated: {100 * float(batch[3].mean()):.1f}% of the batch')
        info = hold_update(ep_trainer.agent, batch)
        if not float(info['termination_loss']) > 0:
            raise AssertionError('episodic update: the termination loss is zero')

    update_records = {}
    with Phase('the update graph vs its eager body, bit for bit: 5M state (toy-reach) and '
               f'{EP_TASK}; update_many({NE}) vs {NE} eager steps'):
        hold_update_graph('5M state', t_agent, buffer.sample())
        e_batch = list(ep_trainer.buffer.sample())
        e_batch[3] = (torch.rand(e_batch[3].shape, device=dev, generator=g) < 0.2).float()
        hold_update_graph('5M episodic', ep_trainer.agent, e_batch)
        hold_update_many(t_agent, buffer, NE)
    with Phase('the update: eager body vs graph (CUDA events, torch.profiler), capture'):
        update_records['5M state'] = update_record('5M state', t_agent, buffer.sample(),
                                                   buffer)
        update_records['5M episodic'] = update_record('5M episodic', ep_trainer.agent,
                                                      e_batch, ep_trainer.buffer)
    with Phase('the bf16 update (bf16_update=true) beside the f32 one: its graph vs its '
               'eager body, JAX\'s contract against f32, its plan, its times; 5M state '
               'and episodic'):
        bf16_twin_hold('5M state', t_agent, buffer.sample(), update_records)
        bf16_twin_hold('5M episodic', ep_trainer.agent, e_batch, update_records)

    with Phase('training path timing (update steps/s, env-steps/s)'):
        B = trainer.cfg.batch_size
        upd_ms = time_ms(lambda: t_agent.update(buffer), 30)

        def update_with_item():
            return {k: float(v) for k, v in t_agent.update(buffer).items()}
        upd_item_ms = time_ms(update_with_item, 30)
        n_loop = 100
        act_s = upd_s = env_s = 0.0
        obs = env.reset()
        torch.cuda.synchronize()
        t_loop = time.perf_counter()
        for t in range(n_loop):
            t1 = time.perf_counter()
            a = t_agent.act(obs, t0=(t % 50 == 0))
            t2 = time.perf_counter()
            obs, _, done, _ = env.step(a)
            if done:
                obs = env.reset()
            t3 = time.perf_counter()
            t_agent.update(buffer)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            act_s, env_s, upd_s = act_s + t2 - t1, env_s + t3 - t2, upd_s + t4 - t3
        loop_s = time.perf_counter() - t_loop
        log(f'  update: {upd_ms:.3f} ms ({1e3 / upd_ms:.1f} update steps/s at '
            f'batch {B}); with .item() of each info value: {upd_item_ms:.3f} ms')
        log(f'  collect+update loop: {n_loop / loop_s:.1f} env-steps/s; per step '
            f'act {1e3 * act_s / n_loop:.3f} ms ({100 * act_s / loop_s:.1f}%), '
            f'update {1e3 * upd_s / n_loop:.3f} ms ({100 * upd_s / loop_s:.1f}%), '
            f'env {1e3 * env_s / n_loop:.3f} ms ({100 * env_s / loop_s:.1f}%)')
        act_ms = 1e3 * act_s / n_loop
        for name, fn, ms in (('update', lambda: t_agent.update(buffer), upd_ms),
                             ('act', lambda: t_agent.act(obs), act_ms)):
            busy, n_dev, top = device_share(fn, 5)
            if busy is None:
                log(f'  {name}: device busy time not measured (no device '
                    'events in the profiler trace)')
                continue
            log(f'  {name}: device busy {busy:.3f} ms of {ms:.3f} ms '
                f'(idle share {100 * (1 - busy / ms):.1f}%), '
                f'{n_dev:.0f} device activities per call (torch.profiler)')
            for t, n, k in top:
                log(f'    {t:.3f} ms in {n:.0f} x {k[:90]}')

    with Phase('profile_dir: the one-env trainer\'s trace of ten updates'), \
            tempfile.TemporaryDirectory() as prof_dir:
        trainer.cfg.profile_dir = prof_dir
        replays = Graph.replays['update']
        trainer._profile_updates(10)
        trainer.cfg.profile_dir = None
        trace = Path(prof_dir) / 'updates.trace.json'
        with open(trace) as f:
            events = json.load(f)['traceEvents']
        if Graph.replays['update'] != replays + 10 or not events:
            raise AssertionError(f'profile_dir: {Graph.replays["update"] - replays} '
                                 f'replays, {len(events)} trace events')
        log(f'  {trace.name}: {trace.stat().st_size / 1e6:.1f} MB, {len(events)} events, '
            'ten update graph replays')

    with Phase(f'vec path timing (plans/s of batched act at N=1, 8, 16; '
               f'env-steps/s of the N={NE} training loop)'):
        v_agent, v_buf, v_env = vtrainer.agent, vtrainer.buffer, vtrainer.env
        cfg16 = load_cfg(overrides=['task=toy-reach', f'seed={SEED}', 'num_envs=16'])
        make_env(cfg16)
        agent16 = TDMPC2(cfg16, device='cuda')
        agent16.load_params(tree.map(torch.clone, v_agent.params))
        obs16 = np.random.default_rng(SEED).normal(size=(16, 6)).astype(np.float32)
        act_plans = {}
        for n in (1, 8, 16):
            o = obs16[0] if n == 1 else obs16[:n]
            t0 = time.perf_counter()
            agent16.act(o, t0=True)                  # captures the plan's graph
            log(f'  act N={n}, the first call of a fresh agent (the eager warm-up and '
                f'the capture): {1e3 * (time.perf_counter() - t0):.1f} ms')
            reps = 30
            t0 = time.perf_counter()
            for r in range(reps):
                agent16.act(o, t0=(r % 50 == 0))     # ends in a copy to the host
            dt = (time.perf_counter() - t0) / reps
            act_plans[n] = (1e3 * dt, n / dt)
            log(f'  act N={n}: {1e3 * dt:.3f} ms per call, {n / dt:.1f} plans/s '
                f'({1 / dt:.1f} calls/s)')
        busy, n_dev, _ = device_share(lambda: agent16.act(obs16[:NE]), 5)
        if busy is not None:
            ms8 = act_plans[NE][0]
            log(f'  act N={NE}: device busy {busy:.3f} ms of {ms8:.3f} ms (idle share '
                f'{100 * (1 - busy / ms8):.1f}%), {n_dev:.0f} device activities')
        # the episodic plan (the termination head in each value launch)
        for n in (1, NE):
            o = obs16[0] if n == 1 else obs16[:n]
            e_agent.act(o, t0=True)
            ms = host_ms(lambda: e_agent.act(o), 30)
            busy, _, _ = device_share(lambda: e_agent.act(o), 5)
            log(f'  episodic act N={n}: {ms:.3f} ms per call, {1e3 * n / ms:.1f} plans/s; '
                f'device busy {busy} ms (idle share '
                f'{"not measured" if busy is None else f"{100 * (1 - busy / ms):.1f}%"})')

        def vec_loop(steps, schedule):
            """The trainer's vector step under `schedule`: 'vec_step' (the
            plan, the updates, one fetch, env.step; the trainer's), 'act,
            update_many' (act's fetch, the updates queued, env.step while
            they run), or 'waited' (act, update_many, the host waiting for
            the updates)."""
            o = v_env.reset()
            t_in = np.zeros(NE, np.int64)
            ph = dict(act=0.0, update=0.0, env=0.0)
            torch.cuda.synchronize()
            t_all = time.perf_counter()
            for _ in range(steps):
                t1 = time.perf_counter()
                if schedule == 'vec_step':
                    a, _ = v_agent.vec_step(v_buf, o, t_in == 0, NE)
                    t2 = time.perf_counter()
                else:
                    a = v_agent.act(o, t0=t_in == 0)
                    t2 = time.perf_counter()
                    v_agent.update_many(v_buf, NE)
                if schedule == 'waited':
                    torch.cuda.synchronize()
                t3 = time.perf_counter()
                o, _, dones, _ = v_env.step(a)
                t_in += 1
                for i in np.flatnonzero(dones):
                    o[i] = v_env.reset_at(i)
                    t_in[i] = 0
                t4 = time.perf_counter()
                ph['act'] += t2 - t1
                ph['update'] += t3 - t2
                ph['env'] += t4 - t3
            torch.cuda.synchronize()
            total = time.perf_counter() - t_all
            log(f'  N={NE} loop, {schedule}: '
                f'{NE * steps / total:.2f} env-steps/s, {1e3 * total / steps:.1f} ms '
                'per vector step; ' + ', '.join(
                    f'{k} {1e3 * v / steps:.1f} ms ({100 * v / total:.1f}%)'
                    for k, v in ph.items()) + ' (host clock)')
            return total / steps
        hold_schedules(v_agent, v_buf, obs16[:NE], np.arange(NE) % 3 == 0, NE)
        schedules, loops = ('vec_step', 'act, update_many', 'waited'), {}
        for schedule in schedules:
            vec_loop(2, schedule)                    # warm-up
        for _ in range(2):                           # in turns, two readings each
            for schedule in schedules:
                t = vec_loop(12, schedule)
                loops[schedule] = min(loops.get(schedule, t), t)
        log(f'  N={NE} env-steps/s by schedule (the better of two readings): ' + ', '.join(
            f'{k} {NE / v:.2f}' for k, v in loops.items()))
        um_ms = time_ms(lambda: v_agent.update_many(v_buf, NE), 5)
        # the same NE updates one call each, on both trained agents, in turns
        for label, ag, buf in (('vec agent', v_agent, v_buf),
                               ('one-env agent', t_agent, buffer)):
            many, seq = [], []
            for _ in range(2):
                many.append(time_ms(lambda: ag.update_many(buf, NE), 3))
                seq.append(time_ms(lambda: [ag.update(buf) for _ in range(NE)], 3))
            log(f'  {label}: update_many({NE}) {many[0]:.1f} / {many[1]:.1f} ms, '
                f'{NE} x update() {seq[0]:.1f} / {seq[1]:.1f} ms (CUDA events, '
                'in turns)')
        busy, n_dev, top = device_share(lambda: v_agent.update_many(v_buf, NE), 2)
        log(f'  update_many({NE}): {um_ms:.3f} ms ({NE * 1e3 / um_ms:.1f} update '
            'steps/s, CUDA events)' + (
                '' if busy is None else
                f'; device busy {busy:.3f} ms (idle share '
                f'{100 * (1 - busy / um_ms):.1f}%), {n_dev:.0f} device activities'))

    mt_errs, mt_paths, mt_rows = multitask_phases(zero_counts, read_counts,
                                                  check_plan_counts, update_records)
    with Phase('the wide engine\'s product alone (wgmma on a TMA ring) against the plain '
               'product and torch.matmul, at the 317M model\'s shapes and the 5M rollout\'s'):
        prod_records, prod_err = product_phase()
        sass = sass_counts()
        log(f'  SASS of the product kernels (cuobjdump): '
            + ('not available' if sass is None else json.dumps(sass)))
        for lib_name, fns in (sass or {}).items():
            for fn, c in fns.items():
                if not (c['HGMMA'] and c['UTMALDG']) or c['HMMA'] or c['LDGSTS']:
                    raise AssertionError(f'{lib_name} {fn}: SASS {c}: not wgmma on TMA copies')
    with Phase('the wide engine\'s row kernel alone (rows streamed by bulk copies into a ring) '
               'against rows_plain, at the 317M model\'s widths'):
        row_records, row_err = row_phase()
        log(f'  largest share of a tolerance used: {row_err[0]:.3f}, max |err| {row_err[1]:.3g}')
    with Phase('the wide engine\'s staging alone against stage_plain, in each launch\'s mode'):
        stage_records = stage_phase()
    with Phase('the folded first layer\'s two kernels alone (the u product on packed env '
               'rows; the action product fused with its LayerNorm + Mish) against their plain '
               'versions, beside torch.mm and the product + row kernel pair they replace'):
        fold_records, fold_err = fold_phase()
        log(f'  largest share of a tolerance used: {fold_err[0]:.3f}, max |err| '
            f'{fold_err[1]:.3g}')
    w_errs, w_paths, w_rows = wide_phases(zero_counts, read_counts, check_plan_counts,
                                          update_records)
    ckpt_errs, ckpt_paths, ckpt_read_s = checkpoint_phases(
        zero_counts, read_counts, check_plan_counts, hold_update)
    pix_errs, pix_paths, _ = pixel_phases(zero_counts, read_counts, check_plan_counts,
                                          update_records)
    for k, e in pix_errs.items():
        ckpt_errs.setdefault(k, {})[f'{PIXEL_CKPT[0]}-rgb'] = e
    fleet_paths, fleet_metrics = fleet_phases(zero_counts, read_counts, check_plan_counts)

    with Phase('timing (CUDA events) and bounds, one env and N envs'):
        HA = H * A
        q_heads = [k for k in value.PREP_NAMES if k[0] == 'q']
        w_all = nbytes(*[prep[k] for k in value.PREP_NAMES
                         if k in prep and k[0] not in 'qt'])
        w_term = nbytes(*[e_prep[k] for k in value.TERM_NAMES])
        w_q1 = nbytes(*[prep[k][0] for k in q_heads])
        M, B = prep['dWz'].shape[1], prep['rW2'].shape[1]
        mac_rew = L * M + A * M + M * M + M * B
        mac_dyn = L * M + A * M + M * M + M * L
        mac_pi = L * M + M * M + 2 * M * A
        mac_term = L * M + M * M + M
        pi_w = nbytes(*[prep[k] for k in value.PREP_NAMES if k[0] in 'dp'])
        e_flops = 35 * S + 8 * S * HA

        def value_step_bound(z, eps_, qidx_, discs_, act_bytes, episodic,
                             f32_flops=0):
            n = z.shape[0]
            heads_used = len(set(qidx_.flatten().tolist()))   # this run's data
            mac_step = mac_rew + mac_dyn + (mac_term if episodic else 0)
            flops = 2 * n * S * (H * mac_step + mac_pi + 2 * mac_rew)
            # a latent broadcast over the rows (stride 0) is read once per env
            z_bytes = n * L * 4 if z.stride(1) == 0 else nbytes(z)
            by = (w_all + (w_term if episodic else 0) + heads_used * w_q1
                  + z_bytes + act_bytes + nbytes(eps_, qidx_, discs_) + n * S * 4)
            return bound_ms(by, flops, BF16_FLOPS, f32_flops)

        def value_bound(args, episodic=False):
            z, acts_, eps_, qidx_, discs_ = args[1:]
            return value_step_bound(z, eps_, qidx_, discs_, nbytes(acts_), episodic)

        def value_episodic_bound(args):
            return value_bound(args, episodic=True)

        def value_sampled_bound(args, episodic=False):
            # the actions' operands in, the actions out; the first n_pi rows
            # come from pi_acts: their noise is never read
            z, mean_, std_, noise_, pi_, amask_, eps_, qidx_, discs_ = args[1:]
            n = z.shape[0]
            act_bytes = (nbytes(mean_, std_, pi_, amask_) + n * (S - n_pi) * HA * 4
                         + n * S * HA * 4)
            return value_step_bound(z, eps_, qidx_, discs_, act_bytes, episodic,
                                    3 * n * S * HA)

        def value_sampled_episodic_bound(args):
            return value_sampled_bound(args, episodic=True)

        def pi_bound(args):
            n = args[2].numel() // (n_pi * HA)
            return bound_ms(pi_w + nbytes(args[1], args[2]) + n * n_pi * HA * 4,
                            2 * n * n_pi * H * (mac_pi + mac_dyn), BF16_FLOPS)

        def elite_bound(args):
            n = args[1].numel() // (S * HA)
            return bound_ms(nbytes(*args) + n * S * 4 + 2 * n * HA * 4,
                            n * e_flops, F32_FLOPS)

        r_flops = 2 * S * H * (mac_rew + mac_dyn)
        r_bytes = (nbytes(*[prep_r[k] for k in value.ROLLOUT_NAMES])
                   + nbytes(z0, actions) + S * 4 + S * L * 4)
        e_args = (v_in, acts, agent.amask)
        evs1_args = tuple(a if a is e_prep or a is agent.amask else a[:1]
                          for a in evs_args)
        ep_heads = dict(heads, episodic=True)
        # name -> ((kernel, plain, args, kw, bound) at one env, the same at N)
        planner_calls = {
            # the planner's step: the value kernel's sampled mode
            'value_sampled': (value.value_sampled, value.value_sampled_plain,
                              vs_args, vs_n_args, heads, value_sampled_bound),
            'cem_pi_rollout': (cem.pi_rollout, cem.pi_rollout_plain,
                               pi_args, pi_n_args, heads, pi_bound),
            'cem_elite': (cem.elite_moments, cem.elite_moments_plain,
                          e_args, e_n_args, elite_kw, elite_bound),
            # the same, with the termination branch, on the episodic paths
            'value_sampled_episodic': (value.value_sampled, value.value_sampled_plain,
                                       evs1_args, evs_args, ep_heads,
                                       value_sampled_episodic_bound),
            # the value kernel on given actions (value_estimate), no main path's
            'value': (value.value_estimate, value.value_estimate_plain,
                      v_args, v_n_args, heads, value_bound),
            'value_episodic': (value.value_estimate, value.value_estimate_plain,
                               ev1_args, evn_args, ep_heads, value_episodic_bound),
        }
        paths = {'evaluate': ev_launches, 'rollout entry': ro_launches,
                 'train, one env': launches, f'train, num_envs={NE}': vec_launches,
                 'evaluate episodic': ev_ep_launches,
                 'train episodic, one env': ep_launches,
                 f'train episodic, num_envs={NE}': vep_launches, **mt_paths,
                 **w_paths, **ckpt_paths, **pix_paths, 'train bf16, one env': bf16_launches,
                 **fleet_paths, **env_paths}
        episodic_paths = ('evaluate episodic', 'train episodic, one env',
                          f'train episodic, num_envs={NE}')
        kernels = []
        for name, (kern, plain, a1, an, kw, bound) in planner_calls.items():
            wname = name.replace('_episodic', '')
            by_path = {k: v[wname] for k, v in paths.items()
                       if wname != 'value_sampled'
                       or (k in episodic_paths) == name.endswith('_episodic')}
            row = {'name': name, 'route': 'cuda',
                   'source': ('tdmpc2_tpu_torch/csrc/value.cu' if name.startswith('value')
                              else 'tdmpc2_tpu_torch/csrc/cem.cu'),
                   'replaces': ('tdmpc2_tpu/ops/pallas_rollout.py:437'
                                if wname == 'value' else 'tdmpc2_tpu/ops/pallas_cem.py:53'),
                   'launches': (vep_launches if name.endswith('_episodic')
                                else vec_launches)[wname],
                   'launches_by_path': by_path,
                   'max_abs_err': results[name], 'n_envs': NE,
                   # the same checks on the committed checkpoints' trained weights
                   'max_abs_err_trained': ckpt_errs.get(name)}
            for suffix, args in (('', an), ('_n1', a1)):
                ms = time_ms(lambda: kern(*args, **kw), 50)
                dev_ms = device_share(lambda: kern(*args, **kw), 20)[0]
                plain_ms = time_ms(lambda: plain(*args, **kw), 10)
                b_ms, b_by = bound(args)
                row.update({f'ms{suffix}': ms, f'device_ms{suffix}': dev_ms,
                            f'plain_ms{suffix}': plain_ms,
                            f'bound_ms{suffix}': b_ms, f'bound_by{suffix}': b_by})
                log(f'  {name} ({"N=%d" % NE if not suffix else "one env"}): kernel '
                    f'{ms:.4f} ms (its own device time {dev_ms} ms), plain '
                    f'{plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})')
            if name != 'cem_elite':
                kname = 'pi_rollout' if name == 'cem_pi_rollout' else 'value'
                row['plan'] = plans[kname]
                row['ptxas'] = {k: v for k, v in usage.items()
                                if k.startswith(kname + '_kernel<')}
            row['library_ms'] = None
            kernels.append(row)
        others = {
            'rollout': (lambda: rollout.rollout_prepared(*r_args, **r_kw),
                        lambda: rollout.rollout_prepared_plain(*r_args, **r_kw),
                        None, bound_ms(r_bytes, r_flops, BF16_FLOPS),
                        'tdmpc2_tpu_torch/csrc/rollout.cu',
                        'tdmpc2_tpu/ops/pallas_rollout.py:50', ro_launches),
            # x + 1 is itself one PyTorch call: the library time
            'probe': (lambda: probe.add_one(x_probe),
                      lambda: probe.add_one_plain(x_probe),
                      lambda: torch.add(x_probe, 1.0),
                      bound_ms(2 * nbytes(x_probe), x_probe.numel(), F32_FLOPS),
                      'tdmpc2_tpu_torch/csrc/probe.cu',
                      'tdmpc2_tpu/ops/pallas_rollout.py:233', vec_launches),
        }
        for name, (kern, plain, lib, (b_ms, b_by), src, rpl, own) in others.items():
            w0 = wide.engine_launches.launches
            kern()
            counted = wide.engine_launches.launches - w0
            if counted != (wide.rollout_launches(H) if name == 'rollout' else 0):
                raise AssertionError(f'{name}: {counted} launches of the wide engine counted')
            ms = time_ms(kern, 50)
            plain_ms = time_ms(plain, 10)
            lib_ms = time_ms(lib, 50) if lib is not None else None
            if lib is None:
                dev_ms, lib_dev_ms = device_share(kern, 20)[0], None
            else:
                # kernel and library device times a microsecond apart: the
                # median of interleaved readings of each
                reads = [(device_share(kern, 20)[0], device_share(lib, 20)[0])
                         for _ in range(PROBE_READINGS)]
                if any(x is None for r in reads for x in r):
                    raise AssertionError(f'{name}: a profiler reading has no device time')
                dev_ms, lib_dev_ms = (float(np.median([r[j] for r in reads]))
                                      for j in (0, 1))
                log(f'  {name}: device time, median of {PROBE_READINGS} interleaved '
                    f'readings: kernel {dev_ms:.6f} ms, library {lib_dev_ms:.6f} ms, '
                    f'kernel / library {dev_ms / lib_dev_ms:.3f}; readings {reads}')
            log(f'  {name}: kernel {ms:.4f} ms (its own device time {dev_ms} ms), '
                f'plain {plain_ms:.4f} ms, library {lib_ms} ms (its kernel\'s device '
                f'time {lib_dev_ms} ms), bound {b_ms:.6f} ms ({b_by})')
            row = {
                'name': name, 'route': 'cuda', 'source': src, 'replaces': rpl,
                'launches': own[name],
                'launches_by_path': {k: v[name] for k, v in paths.items()},
                'max_abs_err': results[name], 'ms': ms, 'device_ms': dev_ms,
                'plain_ms': plain_ms, 'bound_ms': b_ms, 'bound_by': b_by,
                'library_ms': lib_ms, 'library_device_ms': lib_dev_ms}
            if name == 'rollout':
                row['plan'] = plans['rollout']
                row['engine'] = 'wide'
                row['device_launches_a_call'] = counted
                row['ptxas'] = {k: v for k, v in usage.items()
                                if k.startswith(wide_kernels)}
            kernels.append(row)
        kernels.extend(mt_rows)
        fold_lines = {r['name']: r for r in fold_rows(fold_records)}
        for row in w_rows:
            if row['name'] == 'wide_stage':
                row['launches_by_path'] = {k: v['wide_stage'] for k, v in paths.items()}
                row.update(stage_headline(stage_records), modes=stage_records)
            if row['name'] in ('wide_fold_u', 'wide_fold_hidden'):
                row['launches_by_path'] = {k: v[row['name']] for k, v in paths.items()}
                row.update({k: v for k, v in fold_lines[row['name']].items()
                            if k != 'launches'})
            if row['name'] == 'wide_row':
                row['launches_by_path'] = {k: v['wide_row'] for k, v in paths.items()}
                top = next(r for r in row_records
                           if (r['template'], r['rows']) == ROW_HEADLINE)
                row.update({'headline': f'{top["template"]}, {top["rows"]} rows',
                            'max_abs_err': row_err[1], 'tol_used': row_err[0],
                            **{k: top[k] for k in ('ms', 'device_ms', 'plain_ms', 'bound_ms',
                                                   'bound_launched_ms', 'bound_by',
                                                   'layer_norm_ms', 'plan')},
                            'templates': row_records})
        kernels.extend(w_rows)
        top = next(r for r in prod_records
                   if (r['shape'], r['n_envs'], r['model']) == (*PRODUCT_HEADLINE, 317))
        kernels.append({
            'name': 'wide_gemm', 'route': 'cuda', 'engine': 'wide',
            'source': 'tdmpc2_tpu_torch/csrc/mlp_wide.cuh',
            'replaces': 'tdmpc2_tpu/ops/pallas_rollout.py:437',
            'launches': w_paths['act_tasks mt80']['wide_gemm'],
            'launches_by_path': {k: v['wide_gemm'] for k, v in paths.items()},
            'max_abs_err': prod_err, 'headline': f'{top["shape"]}, {top["rows"]} rows',
            'ms': top['ms'], 'device_ms': top['device_ms'], 'plain_ms': top['plain_ms'],
            'bound_ms': top['bound_ms'], 'bound_by': top['bound_by'],
            'library_ms': top['library_ms'], 'library_device_ms': top['library_device_ms'],
            'sass': sass, 'shapes': prod_records})
        for label, args, kw in (('one env', plan_args, plan_kw),
                                (f'N={NE}', plan_n_args, plan_kw),
                                (f'episodic N={NE}', e_plan_args, e_plan_kw)):
            plan_ms = time_ms(lambda: cem.cem_plan(*args, **kw), 10)
            plan_plain_ms = time_ms(lambda: cem.cem_plan_plain(*args, **kw), 3)
            log(f'  whole cem_plan, {label}: kernels {plan_ms:.3f} ms, plain '
                f'{plan_plain_ms:.3f} ms')

    log(f'  seconds to read each committed checkpoint on this machine: {ckpt_read_s}')
    log(json.dumps({'update_graph': update_records}))
    log(json.dumps({'fleet': fleet_metrics}, default=str))
    log(json.dumps({'envs': env_metrics}, default=str))
    log(f'[done] {time.perf_counter() - t_start:.1f} s')
    log(smi)
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    if len(sys.argv) in (3, 4) and sys.argv[1] == '--time-kernels':
        sys.exit(time_kernels(*sys.argv[2:]))
    if len(sys.argv) in (3, 4) and sys.argv[1] == '--compare':
        sys.exit(compare(sys.argv[2], *map(int, sys.argv[3:])))
    if len(sys.argv) == 2 and sys.argv[1] == '--cycles':
        sys.exit(cycles())
    if len(sys.argv) == 2 and sys.argv[1] == '--rows':
        sys.exit(rows_only())
    if len(sys.argv) == 2 and sys.argv[1] == '--stage':
        sys.exit(stage_only())
    if len(sys.argv) == 2 and sys.argv[1] == '--bf16-fleet':
        sys.exit(bf16_fleet_only())
    if len(sys.argv) == 2 and sys.argv[1] == '--pixels':
        sys.exit(pixels_only())
    if len(sys.argv) == 2 and sys.argv[1] == '--envs':
        sys.exit(envs_only())

    sys.exit(main())
