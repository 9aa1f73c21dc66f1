"""tdmpc2_tpu_torch — the PyTorch/CUDA port of tdmpc2_tpu for NVIDIA Hopper.

A package of its own beside the JAX one, which stays the reference. It
imports torch and numpy, never jax and never tdmpc2_tpu. Every TPU kernel
on a ported path is a hand-written CUDA kernel under `csrc/`, built with
nvcc for sm_90a on first use (ops/_build.py), with a plain PyTorch version
beside it that the CPU runs.

Ported so far: single-task online training and evaluation — config,
world-model heads, the MPPI planner (ops/value.py, ops/cem.py), the update
and its optimisers, the replay buffer, the online, vectorised and fleet
trainers, `train` and `evaluate` — the environment adapters (the toy
tasks, dm_control with the 28 custom tasks, Gymnasium, Meta-World,
ManiSkill2, MyoSuite, the mt30/mt80 envs, env copies in this process or
in worker processes; each backend imported only where an env needs it),
multi-task offline training (task embeddings, action masks, per-task
discounts, the offline trainer, lockstep planning over tasks through the
same kernels), checkpoints (the JAX package's, the port's and the
reference's `.pt`, read without jax, optax or ml_dtypes) and resuming,
pixel observations (the conv encoder with ShiftAug, uint8 frames stored
unstacked in the replay ring, the frame-stack wrapper), and every TPU
kernel of the JAX package (value step, CEM loop, reward+dynamics
rollout, canary).
"""

__version__ = "0.1.0"
