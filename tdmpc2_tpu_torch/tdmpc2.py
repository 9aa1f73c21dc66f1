"""TD-MPC2 agent: acting and learning (port of tdmpc2_tpu/tdmpc2.py).

`act` encodes one observation, or a stack of N envs' observations, and
plans for all of them at once with MPPI, as the JAX agent's `_plan_vec`
(tdmpc2.py:378-394) over `_plan` (:523-641) with the whole-CEM kernel:
the policy-prior rollouts, `iterations` x (sample and value, elite moment
update), then each env's top E of the last iteration and a Gumbel pick of
one elite's first action. The loop runs on the hand-written kernels of
ops/cem.py on the card, one launch per step for all N envs, and on their
plain versions on the CPU. The encoder, the final top-k and the Gumbel
pick are plain torch, as they are plain XLA in the JAX package. Each env
keeps its own warm-start mean (`prev_mean` [max(1, num_envs), H, A]). On
episodic tasks (`cfg.episodic`) the value step gates later rewards and
the terminal Q by the termination head's sticky flag.

A multi-task model (`cfg.multitask`, tdmpc2.py:95-100, 188-197) plans each
env for a task: `act(obs, task=i)` plans every env for task i, and
`act_tasks` plans n tasks in lockstep, one env each with its own warm
start (JAX `act_tasks`, tdmpc2.py:396-429). A task enters the planner's
kernels only through its row of the prep's first-layer bias tables (the
folded embedding), its action mask and its discounts, so n tasks are one
plan at N = n: the same 1 + 2 x iterations launches, the same kind of
graph. The JAX agent plans there in plain XLA (its kernels take one
task's folded weights); the port has no plain path on the card.

On the card a plan is one CUDA graph (utils/cuda_graph.py), as the JAX
agent's plan is one jitted program (tdmpc2.py:153-157): one graph for each
(n, eval_mode), captured at the first plan of that pair, whose eager
warm-up is that plan's result; later plans refill its inputs in place and
replay it. It holds the encoder, the planner's 1 + 2 x iterations kernel
calls, the final pick and the write of `prev_mean[:n]`. At model_size 317
the pi rollout and the value steps run on the layer-per-launch engine
(ops/wide.py): the same calls, 31 + 57 x iterations device launches of it
a plan (75 a value step on episodic tasks) beside the elite kernel's, and
still one replay; their scratch buffers come from the graph's pool. The generator's
draws run outside it, into its input buffers. The weight prep is a graph
too (the JAX agent's `_prep_jit`), replayed in place at the first plan
after the weights changed; the weights change in place (`update`), and a
new parameter tree (`load_params`, `load`, a new `state`) drops every
graph, so that the next plan captures anew. On the CPU the same body runs
eagerly.

`update` is one training step (`_update`, tdmpc2.py:928-1057; on a
multi-task model each sample carries its task, whose embedding, action
mask and discount the step gathers): TD targets
without gradient, the consistency, reward and value losses, the model's
Adam step, the policy loss with the running Q scale on the updated
weights, the policy's Adam step and the Polyak update of the target Q
heads, and on episodic tasks the termination loss. It is plain autograd,
as it is plain XLA in the JAX package. The step updates the train state in
place and keeps its info on the device. On the card a step is one replay
of a CUDA graph of the whole of `_update` (both `autograd.grad` calls, the
clips, both Adam steps, the scale and Polyak), as the JAX agent's step is
one jitted program (`_update_jit`, tdmpc2.py:160): the batch and the draws
are copied into its inputs, which stay where they are; the first step of a
train state runs eagerly as the capture's warm-up and then captures. A
failed capture or replay raises. On the CPU the same `_update` runs
eagerly. `update_many` takes n such steps on n batches drawn at once
(`Buffer.sample_many`; JAX `_update_scan_jit`), at most `update_chunk` a
draw. The vectorised trainer's collection step is `vec_step` (the plan,
the updates, then one fetch of the actions), equal to `act` then
`update_many` on the same draws (JAX tdmpc2.py:774-832). The JAX agent's
`act_collect` and `update_many_fused` have no counterpart: they would be
`act` and `update_many`, which already replay their graphs with no host
sync but the fetch of the actions.

All noise is data. `draw_noise` and `draw_update_noise` draw it from the
agent's explicit `torch.Generator` on the device; `plan_vec` takes a
`PlanNoise` and `_update` an `UpdateNoise`, so a test can feed the draws
the JAX agent made.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from functools import partial
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from tdmpc2_tpu_torch import interop
from tdmpc2_tpu_torch.data.buffer import device_free_bytes
from tdmpc2_tpu_torch.models import layers
from tdmpc2_tpu_torch.models.world_model import WorldModel
from tdmpc2_tpu_torch.ops import cem, math, optim, probe, wide
from tdmpc2_tpu_torch.ops.scale import update_scale
from tdmpc2_tpu_torch.ops.value import prepare_value_params, value_sampled
from tdmpc2_tpu_torch.utils import torch_interop, tree
from tdmpc2_tpu_torch.utils.cuda_graph import Graph
from tdmpc2_tpu_torch.utils.seed import generator_state, restore_generator

# the kernel wrappers a plan runs, whose launch counts a replay adds
PLAN_WRAPPERS = (cem.pi_rollout, value_sampled, cem.elite_moments)
# and the wide engine's device launches and the products, row kernels,
# stagings, u products and fused folded layers among them (ops/wide.py),
# which a replay adds too: 0 a plan below 2048 columns; at model_size 317
# (H 3, 6 iterations) 373, 165 of them products, 165 row kernels, 19
# stagings, 12 u products and 12 fused layers (ops/wide.py plan_launches)
PLAN_COUNTS = PLAN_WRAPPERS + wide.COUNTERS


@dataclass
class PlanNoise:
    """Every random draw of one plan for n envs (shapes for H, S, A, E, I,
    n_pi); env i's draws are the JAX `_plan`'s from its own key."""
    pi_eps: torch.Tensor    # [n, n_pi, H*A] policy-prior rollout eps
    sample: torch.Tensor    # [n, I, S, H*A] sampling noise (rows < n_pi unused)
    eps: torch.Tensor       # [n, I, S, A] terminal policy eps
    qidx: torch.Tensor      # [n, I, 2] int32 Q heads
    gumbel: torch.Tensor    # [n, E] Gumbel noise of the final pick
    act: torch.Tensor       # [n, A] exploration noise (not in eval mode)
    # [n, 2] long in [0, 6]: ShiftAug's shifts of each env's frames, on
    # pixels only (the JAX `_plan`'s k_enc, tdmpc2.py:545-546)
    shift: Optional[torch.Tensor] = None


@dataclass
class PlanDraws:
    """The generator's raw draws behind a PlanNoise, in the order they are
    drawn: `gumbel` is made from `u`, `qidx` from `qr`."""
    u: torch.Tensor         # [n, E] uniform
    pi_eps: torch.Tensor    # [n, max(n_pi, 1), H*A]
    sample: torch.Tensor    # [n, I, S, H*A]
    eps: torch.Tensor       # [n, I, S, A]
    qr: torch.Tensor        # [n, I, num_q] uniform
    act: torch.Tensor       # [n, A]
    shift: Optional[torch.Tensor] = None   # [n, 2] long, pixels only, last


@dataclass
class UpdateNoise:
    """Every random draw of one update step (T horizon, B batch, A action,
    N Q heads, M mlp width); the JAX step splits them from its key as
    k_td (td_eps, td_qidx), k_drop, k_pi_upd, k_pi_q and k_pi_drop, and on
    pixels k_enc_next and k_enc0 (tdmpc2.py:933-949)."""
    td_eps: torch.Tensor               # [T, B, A] TD-target policy eps
    td_qidx: torch.Tensor              # [2] long, TD-target Q heads
    q_keep: Optional[torch.Tensor]     # [N, T, B, M] bool, Q('all') dropout
    pi_eps: torch.Tensor               # [T+1, B, A] policy-loss eps
    pi_qidx: torch.Tensor              # [2] long, policy-loss Q heads
    pi_keep: Optional[torch.Tensor]    # [N, T+1, B, M] bool, its dropout
    next_shift: Optional[torch.Tensor] = None   # [T, B, 2] ShiftAug, obs[1:]
    shift0: Optional[torch.Tensor] = None       # [B, 2] ShiftAug, obs[0]


@dataclass
class TrainState:
    """The JAX TrainState without its PRNG key: the agent draws from its
    own `torch.Generator` instead. An update step reads and writes all but
    `prev_mean`, which only acting touches."""
    params: dict
    target_Qs: tuple
    opt_state: dict       # {'enc', 'rest'}: Adam states (ops/optim.py)
    pi_opt_state: dict    # the policy's Adam state
    scale: torch.Tensor   # [] running Q scale (ops/scale.py)
    prev_mean: torch.Tensor   # [max(1, num_envs), H, A] warm starts

    def to(self, device) -> 'TrainState':
        """A copy of the state on `device`."""
        def mv(x):
            return x.detach().to(device, copy=True)
        return TrainState(*[tree.map(mv, x) for x in (
            self.params, self.target_Qs, self.opt_state, self.pi_opt_state,
            self.scale, self.prev_mean)])


def device_of(name: str) -> torch.device:
    """torch.device for `name`; 'cuda' without a card raises."""
    dev = torch.device(name)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'device=cuda but torch.cuda.is_available() is False; '
            'pass device=cpu to run the plain versions on the CPU')
    return dev


class TDMPC2:
    """TD-MPC2 agent: single- and multi-task, state observations; single-task
    pixel observations (uint8 frame stacks through the conv encoder)."""

    # cfg fields that fix the parameter tree's shapes, written into every
    # checkpoint in the JAX package's format (tdmpc2.py:214-226)
    _ARCH_FIELDS = (
        'obs', 'action_dim', 'latent_dim', 'mlp_dim', 'enc_dim',
        'num_enc_layers', 'num_channels', 'num_q', 'num_bins', 'episodic',
        'multitask', 'task_dim', 'simnorm_dim', 'model_size')

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = device_of(device or cfg.device)
        # the kernel-engine canary before anything runs on the card (the
        # JAX agent's probe site, tdmpc2.py:124-128); no fallback behind it
        if not probe.kernel_engine_alive(self.device):
            raise RuntimeError('the CUDA kernels cannot run on this card: '
                               f'{probe.verdict()["reason"]}')
        self.model = WorldModel(cfg).to(self.device)
        # the update's view of the same parameters: bf16 products with f32
        # sums under cfg.bf16_update (JAX tdmpc2.py:81-85); acting, the
        # plan and the weight prep keep the f32 model
        self.model_upd = (WorldModel(cfg, torch.bfloat16).to(self.device)
                          if cfg.get('bf16_update') else self.model)
        # heuristic for large action spaces (reference tdmpc2.py:34)
        self.iterations = cfg.iterations + 2 * int(cfg.action_dim >= 20)
        H = cfg.horizon
        powers = torch.arange(H + 1, dtype=torch.float32)
        if cfg.multitask:
            # one discount per task (tdmpc2.py:95-100): [tasks], and each
            # task's powers discs [tasks, H+1]; amask [tasks, A]
            self.discount = torch.tensor(
                [self._get_discount(n) for n in cfg.episode_lengths],
                dtype=torch.float32)
            self.discs = (self.discount[:, None] ** powers).to(self.device)
            self.discount = self.discount.to(self.device)
            self.amask = self.model.action_masks
        else:
            self.discount = float(self._get_discount(cfg.episode_length))
            self.discs = (torch.tensor(self.discount, dtype=torch.float32)
                          ** powers).to(self.device)
            self.amask = torch.ones(cfg.action_dim, device=self.device)
        self.rho = (torch.tensor(cfg.rho, dtype=torch.float32)
                    ** torch.arange(H + 1, dtype=torch.float32)).to(self.device)
        # the kernels take bf16 weights; the CPU path keeps f32 (reference)
        self.dot_dtype = (torch.bfloat16 if self.device.type == 'cuda'
                          else torch.float32)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._auto_chunk_cache = None    # (ring, its auto update-chunk cap)
        self.load_params(self.model.init(
            torch.Generator().manual_seed(cfg.seed)))

    def _get_discount(self, episode_length):
        """Episode-length -> discount heuristic (reference tdmpc2.py:57-70)."""
        frac = episode_length / self.cfg.discount_denom
        return min(max((frac - 1) / frac, self.cfg.discount_min),
                   self.cfg.discount_max)

    # ---------------------------------------------------------------- state

    def load_params(self, params):
        """Take a parameter tree (e.g. from interop.params_from_jax) as a
        fresh train state: targets copied from the Q heads, new optimiser
        states and scale, as the JAX agent's init and weights-only load."""
        cfg = self.cfg
        params = _to(params, self.device)
        self.state = TrainState(
            params=params,
            target_Qs=tree.map(torch.clone, params['Qs']),
            opt_state=optim.model_opt_init(params),
            pi_opt_state=optim.adam_init(params['pi']),
            scale=torch.ones((), dtype=torch.float32, device=self.device),
            prev_mean=torch.zeros(max(1, int(cfg.num_envs or 1)), cfg.horizon,
                                  cfg.action_dim, device=self.device))
        self._prep = None
        self._task_means = {}     # act_tasks' warm starts, by task count
        self._drop_graphs()

    @property
    def params(self):
        return self.state.params

    @property
    def prev_mean(self):
        """The planner's warm starts, one [H, A] mean per env."""
        return self.state.prev_mean

    @prev_mean.setter
    def prev_mean(self, value):
        """Copied into the warm starts in place where the shapes agree (the
        plan graphs write there); otherwise they are replaced."""
        pm = self.state.prev_mean
        if (isinstance(value, torch.Tensor) and value.shape == pm.shape
                and value.dtype == pm.dtype and value.device == pm.device):
            pm.copy_(value)
        else:
            self.state.prev_mean = value

    @property
    def prep(self):
        """The planner's prepared weights, redone after the weights change
        (`_prep` None); on the card in place, by the prep graph."""
        self._check_bound()
        if self._prep is None:
            self._prep = self._prepare()
        return self._prep

    def _prepare(self) -> dict:
        def prep():
            return prepare_value_params(self.params, self.cfg, self.dot_dtype)
        if self.device.type != 'cuda':
            return prep()
        g = self._graphs.get('prep')
        if g is None:
            g = self._graphs['prep'] = Graph(prep, (), self.device, 'prep')
        return g.replay()

    def _drop_graphs(self):
        self._graphs, self._bound = {}, None

    def _check_bound(self):
        """Drop the graphs (and the prep) when the state holds other
        parameters or warm starts than they were captured on."""
        st, bound = self.state, self._bound
        if bound is not None and bound[0] is not st.params:
            self._graphs, self._prep = {}, None
        elif bound is not None and bound[1] is not st.prev_mean:
            # the update graph reads no warm start either
            self._graphs = {k: g for k, g in self._graphs.items()
                            if k in ('prep', 'update')}
        self._bound = (st.params, st.prev_mean)

    def _arch_meta(self) -> dict:
        meta = {k: self.cfg.get(k) for k in self._ARCH_FIELDS}
        meta['obs_shape'] = {k: tuple(v)
                             for k, v in dict(self.cfg.obs_shape).items()}
        meta['num_tasks'] = len(self.cfg.tasks) if self.cfg.multitask else 1
        return meta

    def save(self, fp, extra: Optional[dict] = None, buffer=None):
        """Pickle the train state. 'model', 'target_Qs' and 'scale' are in
        the JAX package's pytree names as numpy arrays, so interop and the
        JAX agent's `load` read them; the port's optimiser states, the
        agent's generator state and, with `buffer`, the replay buffer's go
        under keys of their own (the port's counterpart of the JAX state's
        PRNG key, tdmpc2.py:255), which the JAX agent does not read."""
        def np_(x):
            return x.detach().cpu().numpy()
        blob = {
            'model': tree.map(np_, self.state.params),
            'target_Qs': tree.map(np_, self.state.target_Qs),
            'scale': np_(self.state.scale),
            'torch_opt_state': tree.map(np_, self.state.opt_state),
            'torch_pi_opt_state': tree.map(np_, self.state.pi_opt_state),
            'torch_rng': generator_state(self.generator),
            'arch': self._arch_meta(),
        }
        if buffer is not None and buffer.generator is not None:
            blob['torch_buffer_rng'] = generator_state(buffer.generator)
        if extra:
            blob['extra'] = dict(extra)
        Path(fp).parent.mkdir(parents=True, exist_ok=True)
        with open(fp, 'wb') as f:
            pickle.dump(blob, f)

    def load(self, fp, buffer=None) -> dict:
        """Load a checkpoint (JAX tdmpc2.py:275-335); returns its 'extra'
        dict ({} for the reference's formats). `fp` is one of:

        - a pickle of the port or of the JAX package, plain or gzipped, read
          without jax, optax or ml_dtypes (`interop.load_blob`): a full JAX
          train state carries its optimiser states and `scale` across
          (`interop.opt_states_from_jax`), a stripped one (weights only)
          leaves them fresh, as the JAX agent does; the JAX state's PRNG
          key is not read (threefry draws cannot become a torch
          generator's). The port's own pickles also restore the agent's
          generator and, given `buffer`, the buffer's, where the saved
          generator is on the same kind of device; a checkpoint is refused
          when its architecture differs from the config's;
        - a reference-format state dict passed as a dict, or a reference
          PyTorch `.pt` checkpoint (`utils/torch_interop.py`): parameters
          and target heads; the optimiser states and `scale` stay as they
          were, as in the JAX agent;
        - an `.orbax` directory raises: reading it needs orbax, which the
          port does not use.

        A checkpoint holds no warm starts: `prev_mean` stays as it was.
        Every plan graph and the prep are dropped."""
        if isinstance(fp, dict):
            blob = fp
        elif str(fp).endswith('.pt'):
            return self._load_reference(*torch_interop.load_reference_checkpoint(
                fp, self.params))
        elif str(fp).endswith('.orbax'):
            raise NotImplementedError(
                f'{fp}: Orbax checkpoints need the orbax package, which the '
                'port does not use; save the JAX agent to a .pkl instead')
        else:
            blob = interop.load_blob(fp)
        model = blob.get('model', blob)
        if isinstance(model, dict) and any(
                str(k).startswith('_') and '.' in str(k) for k in model):
            # a reference-format state dict (reference tdmpc2.py:87-90)
            return self._load_reference(*torch_interop.convert_reference_state_dict(
                blob if 'model' in blob else model, self.params))
        arch = blob.get('arch')
        if isinstance(arch, dict):
            mine = self._arch_meta()
            diffs = {k: (arch.get(k), v) for k, v in mine.items()
                     if _canon(arch.get(k)) != _canon(v)}
            if diffs:
                raise ValueError(f'checkpoint architecture does not match '
                                 f'the configured model: {diffs}')
        prev_mean = self.prev_mean
        self.load_params(interop.params_from_jax(blob['model'], self.device))
        st = self.state
        st.prev_mean = prev_mean
        if 'target_Qs' in blob:
            st.target_Qs = interop.params_from_jax(blob['target_Qs'], self.device)

        def t(x):
            return torch.tensor(np.asarray(x), device=self.device)
        if 'opt_state' in blob:             # a full JAX train state
            st.opt_state, st.pi_opt_state = interop.opt_states_from_jax(
                blob['opt_state'], blob['pi_opt_state'], self.device)
            st.scale = t(blob['scale']).float()
        elif 'torch_opt_state' in blob:     # the port's
            st.opt_state = tree.map(t, blob['torch_opt_state'])
            st.pi_opt_state = tree.map(t, blob['torch_pi_opt_state'])
            st.scale = t(blob['scale']).float()
        if 'torch_rng' in blob:
            restore_generator(self.generator, blob['torch_rng'], 'the agent')
        if buffer is not None and 'torch_buffer_rng' in blob:
            buffer.set_rng_state(blob['torch_buffer_rng'])
        return blob.get('extra', {})

    def _load_reference(self, params, target_Qs) -> dict:
        """Take a reference checkpoint's parameters and target heads; the
        optimiser states, `scale` and warm starts stay as they were."""
        old = self.state
        self.load_params(interop.params_from_jax(params, self.device))
        self.state.target_Qs = interop.params_from_jax(target_Qs, self.device)
        for k in ('opt_state', 'pi_opt_state', 'scale', 'prev_mean'):
            setattr(self.state, k, getattr(old, k))
        return {}

    # ------------------------------------------------------------------ act

    def _task_ids(self, task, n: int):
        """int32 [n] task ids on the device from an int or n ints; None on a
        single-task model (which takes no task)."""
        if not self.cfg.multitask:
            if task is not None:
                raise ValueError('task given to a single-task model')
            return None
        if task is None:
            raise ValueError('a multi-task model plans for a task: pass task')
        ids = np.broadcast_to(np.asarray(task, np.int64).reshape(-1), (n,))
        if ids.min() < 0 or ids.max() >= len(self.cfg.tasks):
            raise ValueError(f'task ids {ids} outside [0, {len(self.cfg.tasks)})')
        return torch.from_numpy(ids.astype(np.int32)).to(self.device)

    def _obs_array(self, obs):
        """A host observation as the encoder takes it: pixel frames stay
        uint8 (a quarter of f32's bytes to the card), state becomes f32."""
        if self.cfg.obs == 'rgb':
            return np.ascontiguousarray(obs, np.uint8)
        return np.asarray(obs, np.float32)

    def _shifts(self, *lead):
        """ShiftAug's shifts [*lead, 2] from the agent's generator (rgb)."""
        return torch.randint(0, 2 * layers.SHIFT_PAD + 1, (*lead, 2),
                             generator=self.generator, device=self.device)

    @torch.no_grad()
    def act(self, obs, t0=False, eval_mode=False, task=None):
        """Plan for one observation (numpy [obs_dim] -> action [A]) or for a
        stack of n envs' observations ([n, obs_dim] -> [n, A]), the JAX
        agent's rank test (tdmpc2.py:349-352); pixel observations are
        [C, H, W] uint8 frame stacks, or [n, C, H, W]. `t0` (a bool, or one
        per env) starts an env's episode: its warm start is reset. A
        multi-task model plans for `task` (an index into cfg.tasks)."""
        obs = self._obs_array(obs)
        single = obs.ndim == len(self.cfg.obs_shape[self.cfg.obs])
        if single:
            obs = obs[None]
        n = obs.shape[0]
        obs = torch.from_numpy(obs)
        task = self._task_ids(task, n)
        if not self.cfg.mpc:
            tl = None if task is None else task.long()
            eps = torch.randn(n, self.cfg.action_dim, generator=self.generator,
                              device=self.device)
            # the JAX agent shifts the frames here too, eval or not
            # (tdmpc2.py:369-372)
            shifts = self._shifts(n) if self.cfg.obs == 'rgb' else None
            z = self.model.encode(self.params, obs.to(self.device), tl, shifts)
            a, info = self.model.pi(self.params, z, eps, tl)
            a = info['mean'] if eval_mode else a
        else:
            t0 = np.broadcast_to(np.asarray(t0, bool).reshape(-1), (n,))
            a, _ = self.plan_vec(obs, t0, eval_mode=eval_mode, task=task)
        a = a.cpu().numpy()
        return a[0] if single else a

    @torch.no_grad()
    def act_tasks(self, obs, prev_mean, t0, tasks, noise: PlanNoise = None):
        """Greedy eval actions for n tasks in lockstep, one env each (JAX
        `act_tasks`, tdmpc2.py:396-429): obs [n, obs_dim]; prev_mean
        [n, H, A], the caller's warm starts (numpy or a tensor); t0 a bool
        or [n]; tasks [n] task ids -> (actions [n, A] numpy, the new warm
        starts [n, H, A] on the device). One plan at N = n: on the card one
        graph replay of the planner's 1 + 2 x iterations launches for all
        tasks. The returned warm starts are the agent's buffer, which the
        next call for n tasks overwrites. `noise` replaces the draws."""
        if not self.cfg.multitask:
            raise ValueError('act_tasks needs a multi-task model')
        obs = torch.from_numpy(np.array(obs, np.float32))
        n = obs.shape[0]
        pm = self._task_means.get(n)
        if pm is None:
            pm = self._task_means[n] = torch.zeros(
                n, self.cfg.horizon, self.cfg.action_dim, device=self.device)
        if prev_mean is not pm:
            pm.copy_(torch.as_tensor(np.asarray(prev_mean, np.float32)
                                     if not isinstance(prev_mean, torch.Tensor)
                                     else prev_mean))
        t0 = np.broadcast_to(np.asarray(t0, bool).reshape(-1), (n,))
        a, _ = self.plan_vec(obs, t0, eval_mode=True, noise=noise,
                             task=self._task_ids(tasks, n), prev_mean=pm)
        return a.cpu().numpy(), pm

    def draw_noise(self, n: int = 1) -> PlanNoise:
        """Every draw of one plan for n envs, from the agent's generator."""
        return self._noise_from(self._draw(n))

    def _draws(self, n: int) -> dict:
        """{field of PlanDraws: (draw function, shape)}, in the order of the
        draws; the pixel encoder's shifts (long) come last, on rgb only, so
        that the state path's draws are what they were."""
        cfg = self.cfg
        H, S, A, I = cfg.horizon, cfg.num_samples, cfg.action_dim, self.iterations
        d = dict(u=(torch.rand, (n, cfg.num_elites)),
                 pi_eps=(torch.randn, (n, max(cfg.num_pi_trajs, 1), H * A)),
                 sample=(torch.randn, (n, I, S, H * A)),
                 eps=(torch.randn, (n, I, S, A)),
                 qr=(torch.rand, (n, I, cfg.num_q)),
                 act=(torch.randn, (n, A)))
        if cfg.obs == 'rgb':
            d['shift'] = (partial(torch.randint, 0, 2 * layers.SHIFT_PAD + 1), (n, 2))
        return d

    def _draw(self, n: int, out: Optional[PlanDraws] = None) -> PlanDraws:
        """The raw draws of one plan for n envs, in their order; into the
        tensors of `out` when given (the same bits)."""
        g, dev = self.generator, self.device
        return PlanDraws(**{
            k: fn(shape, generator=g, device=dev) if out is None
            else fn(shape, generator=g, out=getattr(out, k))
            for k, (fn, shape) in self._draws(n).items()})

    @staticmethod
    def _noise_from(d: PlanDraws) -> PlanNoise:
        """The plan's noise from its raw draws: two distinct Q heads (the
        first two of a random permutation), Gumbel noise; a pixel model's
        shifts as drawn."""
        return PlanNoise(
            pi_eps=d.pi_eps, sample=d.sample, eps=d.eps,
            qidx=torch.argsort(d.qr, dim=-1)[..., :2].to(torch.int32).contiguous(),
            gumbel=-torch.log(-torch.log(
                d.u.clamp(min=torch.finfo(torch.float32).tiny))),
            act=d.act, shift=d.shift)

    def _qpair(self, *lead):
        """Two distinct Q heads (the first two of a random permutation)."""
        r = torch.rand(*lead, self.cfg.num_q, generator=self.generator,
                       device=self.device)
        return torch.argsort(r, dim=-1)[..., :2]

    @torch.no_grad()
    def plan_vec(self, obs, t0, eval_mode=False, noise: PlanNoise = None,
                 task=None, prev_mean=None):
        """MPPI plan for n envs (JAX `_plan_vec`, tdmpc2.py:378-394): obs
        [n, obs_dim] on the host or the device, t0 [n] bool (numpy) ->
        (actions [n, A], means [n, H, A]) on the device. Writes the n means
        into `prev_mean[:n]`; rows past n keep theirs. `noise` replaces the
        generator's draws. `task`, on a multi-task model, is each env's task
        id (int32 [n] on the device). `prev_mean` (default: the agent's
        warm starts) is the [>= n, H, A] tensor the plan reads and writes.
        On the card this replays the plan's graph, and the returned tensors
        are its outputs, which the next plan for the same n and mode
        overwrites."""
        n = obs.shape[0]
        own = prev_mean is None
        pm = self.prev_mean if own else prev_mean
        if n > pm.shape[0]:
            raise ValueError(f'{n} observations for {pm.shape[0]} '
                             'warm starts (cfg.num_envs)')
        if self.cfg.multitask and task is None:
            raise ValueError('a multi-task model plans for a task: pass task')
        if self.cfg.obs == 'rgb' and noise is not None and noise.shift is None:
            raise ValueError('a pixel plan shifts its frames: the noise needs '
                             'ShiftAug shifts (PlanNoise.shift)')
        prep = self.prep
        t0 = torch.tensor(np.asarray(t0, bool).reshape(n))
        if self.device.type == 'cuda':
            return self._plan_graphed(prep, obs, t0, eval_mode, noise, task, pm,
                                      own)
        if noise is None:
            noise = self.draw_noise(n)
        return self._plan_body(prep, obs, t0, noise, eval_mode, task, pm)

    def _plan_graphed(self, prep, obs, t0, eval_mode, noise, task, pm, own):
        """`plan_vec` on the card: the draws (or `noise`), obs, t0 and the
        task ids into the graph's inputs, then its replay; the first plan of
        a key captures."""
        n = obs.shape[0]
        key = (n, bool(eval_mode), None if noise is None else tuple(
            None if x is None else tuple(x.shape) for x in vars(noise).values()),
            task is not None, own)
        entry = self._graphs.get(key)
        if entry is None:
            ins = dict(
                # the observation's own dtype: pixel frames stay uint8
                obs=torch.empty(obs.shape, dtype=obs.dtype, device=self.device),
                t0=torch.empty(n, dtype=torch.bool, device=self.device),
                task=(None if task is None else
                      torch.empty(n, dtype=torch.int32, device=self.device)),
                draws=(PlanDraws(**{
                    k: torch.empty(shape, device=self.device, dtype=(
                        torch.long if k == 'shift' else torch.float32))
                    for k, (_, shape) in self._draws(n).items()})
                       if noise is None else
                       PlanNoise(**{k: None if v is None else torch.empty(
                           v.shape, dtype=v.dtype, device=self.device)
                           for k, v in vars(noise).items()})))
        else:
            ins = entry[1]
        ins['obs'].copy_(obs)
        ins['t0'].copy_(t0)
        if task is not None:
            ins['task'].copy_(task)
        if noise is None:
            self._draw(n, out=ins['draws'])
        else:
            for k, v in vars(noise).items():
                if v is not None:
                    getattr(ins['draws'], k).copy_(v)
        if entry is not None:
            return entry[0].replay()

        def body():
            d = ins['draws']
            return self._plan_body(
                prep, ins['obs'], ins['t0'],
                self._noise_from(d) if isinstance(d, PlanDraws) else d,
                eval_mode, ins['task'], pm)
        g = Graph(body, PLAN_COUNTS, self.device, 'plan')
        self._graphs[key] = (g, ins)
        return g.first

    def _plan_body(self, prep, obs, t0, noise: PlanNoise, eval_mode,
                   task=None, pm=None):
        """The plan on device tensors (obs [n, obs_dim], or uint8 frames
        [n, C, H, W], t0 [n] bool, the draws in `noise`, task ids int32 [n]
        or None, the warm starts `pm`, by default the agent's): what the
        plan's graph captures, and the CPU's plan."""
        cfg = self.cfg
        H, E, A = cfg.horizon, cfg.num_elites, cfg.action_dim
        n = obs.shape[0]
        pm = self.prev_mean if pm is None else pm
        if task is None:
            tl, discs, amask = None, self.discs.expand(n, -1), self.amask
        else:
            tl = task.long()
            discs, amask = self.discs[tl], self.amask[tl]
        if self.cfg.obs == 'rgb':
            # each env's frames shifted by its own draw (JAX tdmpc2.py:545-546)
            z0 = self.model.encode(self.params, obs, tl, noise.shift)
        else:
            z0 = self.model.encode(self.params, obs.reshape(n, -1).float(), tl)
        mean0 = torch.cat([pm[:n, 1:],
                           torch.zeros(n, 1, A, device=self.device)], 1)
        # a reset row is +0.0, never -0.0
        mean0 = torch.where(t0[:, None, None], 0.0, mean0)
        std0 = torch.full((n, H * A), cfg.max_std, device=self.device)
        mean, std, value, acts = cem.cem_plan(
            prep, z0[:, None], noise.pi_eps, noise.sample, noise.eps,
            noise.qidx, discs, mean0.reshape(n, H * A),
            std0, amask, iterations=self.iterations,
            n_pi=cfg.num_pi_trajs, num_elites=E, temperature=cfg.temperature,
            min_std=cfg.min_std, max_std=cfg.max_std,
            log_std_min=self.model.log_std_min,
            log_std_dif=self.model.log_std_dif, simnorm_dim=cfg.simnorm_dim,
            episodic=cfg.episodic, task=task)
        # each env's last-iteration elites + Gumbel pick (JAX tdmpc2.py:630-641)
        elite_value, elite_idx = torch.topk(value[..., 0], E, dim=-1)
        score = torch.exp(cfg.temperature * (
            elite_value - elite_value.max(-1, keepdim=True).values))
        score = score / score.sum(-1, keepdim=True)
        idx = math.gumbel_softmax_sample(score, noise.gumbel)
        rows = torch.arange(n, device=self.device)
        a = acts[rows, elite_idx[rows, idx], :A]
        if not eval_mode:
            a = a + std[:, :A] * noise.act
        means = mean.reshape(n, H, A)
        pm[:n] = means
        return torch.clamp(a, -1.0, 1.0), means

    def _estimate_value(self, z, actions, eps, qidx):
        """H-step value through the model heads, the JAX agent's plain
        branch (tdmpc2.py:498-521): z [S, L]; actions [H, S, A];
        eps [S, A]; qidx [2] -> [S, 1]. A reference for the planner's value
        step; the planner itself runs ops/value.py. On episodic tasks a
        sticky flag, set where the termination probability of the new
        latent exceeds 0.5, zeroes later rewards and the terminal Q."""
        params, cfg = self.params, self.cfg
        G = torch.zeros(z.shape[0], 1, device=z.device)
        term = torch.zeros_like(G)
        disc = 1.0
        for a_t in actions:
            r = math.two_hot_inv(self.model.reward(params, z, a_t),
                                 cfg.num_bins, cfg.vmin, cfg.vmax)
            z = self.model.next(params, z, a_t)
            G = G + disc * (1.0 - term) * r
            disc = disc * self.discount
            if cfg.episodic:
                hit = (self.model.termination(params, z) > 0.5).float()
                term = torch.clamp(term + hit, max=1.0)
        action, _ = self.model.pi(params, z, eps)
        q = self.model.Q(params, z, action, qidx=qidx.long(), return_type='avg')
        return G + disc * (1.0 - term) * q

    # ------------------------------------------------------------- learning

    def draw_update_noise(self) -> UpdateNoise:
        """Every draw of one update step, from the agent's generator."""
        cfg, g, dev = self.cfg, self.generator, self.device
        T, B, A = cfg.horizon, cfg.batch_size, cfg.action_dim
        N, M = cfg.num_q, cfg.mlp_dim

        def keep(*shape):
            if cfg.dropout <= 0.0:
                return None
            return torch.rand(*shape, generator=g, device=dev) < 1.0 - cfg.dropout
        noise = UpdateNoise(
            td_eps=torch.randn(T, B, A, generator=g, device=dev),
            td_qidx=self._qpair(),
            q_keep=keep(N, T, B, M),
            pi_eps=torch.randn(T + 1, B, A, generator=g, device=dev),
            pi_qidx=self._qpair(),
            pi_keep=keep(N, T + 1, B, M))
        if cfg.obs == 'rgb':    # after the state path's draws
            noise.next_shift, noise.shift0 = self._shifts(T, B), self._shifts(B)
        return noise

    def update(self, buffer) -> dict:
        """One learning step on a batch from `buffer` (reference
        tdmpc2.py:334-349); returns the step's info as device tensors (on
        the card the update graph's outputs, which its next replay
        overwrites)."""
        return self._updates(buffer, 1)

    def _updates(self, buffer, n: int) -> dict:
        """n steps on one `sample`/`sample_many(n)` draw; the last info."""
        if n == 1:
            info = self._step(buffer.sample())
        else:
            batch = buffer.sample_many(n)
            for i in range(n):
                info = self._step(tuple(x[i] for x in batch))
        self._prep = None
        return info

    def _step(self, batch, noise: Optional[UpdateNoise] = None) -> dict:
        """One training step on `batch` (the buffer's layout; a multi-task
        batch ends with its tasks) with `noise`, by default the agent's
        next draws. On the CPU the eager `_update`. On the card one replay
        of the update's CUDA graph (JAX `_update_jit`): the batch and the
        draws are copied into its inputs first; the first step of a train
        state captures it, and the eager run before that capture is this
        step. Each graph is bound to the state's parameter, target, Adam
        and scale tensors, which the step writes in place; another state
        captures anew."""
        if noise is None:
            noise = self.draw_update_noise()
        st = self.state
        if self.device.type != 'cuda':
            return self._update(st, *batch[:4], noise, *batch[4:])
        bound = (st.params, st.target_Qs, st.opt_state, st.pi_opt_state,
                 st.scale)
        entry = self._graphs.get('update')
        if entry is not None and all(a is b for a, b in zip(entry[2], bound)):
            graph, ins = entry[:2]
        else:
            graph, ins = None, (
                tuple(torch.empty_like(x) for x in batch),
                UpdateNoise(**{k: None if v is None else torch.empty_like(v)
                               for k, v in vars(noise).items()}))
        for x, y in zip(ins[0], batch):
            x.copy_(y)
        for k, v in vars(noise).items():
            if v is not None:
                getattr(ins[1], k).copy_(v)
        if graph is not None:
            return graph.replay()
        b, nz = ins
        graph = Graph(lambda: self._update(st, *b[:4], nz, *b[4:]), (),
                      self.device, 'update')
        self._graphs['update'] = (graph, ins, bound)
        return graph.first

    # the update-chunk cap's memory model (JAX tdmpc2.py:703-745): the card's
    # free memory, less a reserve for all but the sampled batches (the
    # graphs' pools, the 317M update's logged by chip_smoke.py; the
    # planner's scratch; fragmentation). The reserve's 8 GB is a guess: no
    # run has yet been held to a cap that binds.
    _MEM_RESERVE_BYTES = 8_000_000_000

    def _auto_update_chunk(self, buffer) -> int:
        """Updates whose sampled batches fit beside the rest (JAX
        tdmpc2.py:711-729): (free bytes - the reserve) // one batch's
        bytes, at least 1; 0 (no cap) while the batch bytes are unknown or
        the device reports no free bytes (the CPU)."""
        bb = buffer.sample_batch_bytes()
        free = device_free_bytes(self.device)
        if not bb or free is None:
            return 0
        return max(1, int((free - self._MEM_RESERVE_BYTES) // bb))

    def _update_chunk(self, buffer) -> int:
        """cfg.update_chunk where it is > 0; 0 means the auto cap, taken once
        per ring (its geometry is fixed once it exists; JAX
        tdmpc2.py:731-745)."""
        chunk = self.cfg.get('update_chunk', 0)
        if chunk:
            return chunk
        storage = buffer._storage
        if storage is None:
            return 0
        cached = self._auto_chunk_cache
        if cached is None or cached[0] is not storage:
            cached = self._auto_chunk_cache = (
                storage, self._auto_update_chunk(buffer))
        return cached[1]

    def update_many(self, buffer, n: int) -> dict:
        """`n` learning steps on `n` batches drawn at once
        (`Buffer.sample_many`, JAX tdmpc2.py:747-772); returns the last
        step's info. On the same n batches and draws this is n sequential
        `update`s: on the card n replays of the update's graph, each after
        its batch and draws are copied in. More than the update-chunk cap
        runs as ceil(n / chunk) such calls, each with its own draw."""
        chunk = self._update_chunk(buffer)
        if chunk and n > chunk:
            info = None
            for m in range(0, n, chunk):
                info = self.update_many(buffer, min(chunk, n - m))
            return info
        return self._updates(buffer, n)

    @torch.no_grad()
    def _plan_collect(self, obs, t0):
        """The training plan for n envs' observations, left on the device."""
        obs = torch.from_numpy(self._obs_array(obs))
        t0 = np.broadcast_to(np.asarray(t0, bool).reshape(-1), (obs.shape[0],))
        return self.plan_vec(obs, t0)[0]

    def vec_step(self, buffer, obs, t0, n_updates: int):
        """The vectorised trainer's collection step (JAX tdmpc2.py:774-832):
        the plan's replay for every env, then `update_many(buffer,
        n_updates)` (none at 0), then one fetch of the actions, which were
        planned with the weights before the updates. Equal to
        `act(obs, t0=t0)` then `update_many(buffer, n_updates)` on the same
        draws, which is what a pi-only or multi-task agent, or a ring in host
        RAM, takes instead. Returns (actions [n, A] numpy, the last info or
        None)."""
        one_call = self.cfg.mpc and not self.cfg.multitask and buffer.on_device
        a = self._plan_collect(obs, t0) if one_call else self.act(obs, t0=t0)
        info = self.update_many(buffer, n_updates) if n_updates else None
        return (a.cpu().numpy() if one_call else a), info

    def _td_target(self, params, target_Qs, next_z, reward, terminated,
                   noise: UpdateNoise, task=None):
        """Min-Q TD target (reference tdmpc2.py:241-257), with each sample's
        task discount on a multi-task model."""
        action, _ = self.model_upd.pi(params, next_z, noise.td_eps, task)
        discount = self.discount if task is None else self.discount[task][..., None]
        q = self.model_upd.Q(params, next_z, action, qidx=noise.td_qidx,
                         return_type='min', target_params=target_Qs, task=task)
        return reward + discount * (1.0 - terminated) * q

    def _update(self, state: TrainState, obs, action, reward, terminated,
                noise: UpdateNoise, task=None) -> dict:
        """The training step on a batch in the buffer's layout (obs
        [T+1, B, ...], action [T, B, A], reward and terminated [T, B, 1];
        task [B], a multi-task model's), in place on `state` (reference
        tdmpc2.py:259-332), through `model_upd` (bf16 products under
        cfg.bf16_update, cuBLAS summing in f32)."""
        with layers.bf16_f32_sums():
            return self._update_body(state, obs, action, reward, terminated,
                                     noise, task)

    def _update_body(self, state, obs, action, reward, terminated, noise,
                     task):
        cfg, model = self.cfg, self.model_upd
        T = cfg.horizon
        rho_t, rho_pi = self.rho[:T], self.rho
        if task is not None:
            task = task.long()

        with torch.no_grad():
            next_z = model.encode(state.params, obs[1:], task, noise.next_shift)
            td_targets = self._td_target(state.params, state.target_Qs,
                                         next_z, reward, terminated, noise,
                                         task)

        # -- model loss (reference tdmpc2.py:268-304)
        live = tree.map(lambda p: p.detach().requires_grad_(True),
                        state.params)
        z = model.encode(live, obs[0], task, noise.shift0)
        zs = [z]
        for t in range(T):
            z = model.next(live, z, action[t], task)
            zs.append(z)
        zs = torch.stack(zs)                                   # [T+1, B, L]
        consistency = torch.sum(
            torch.mean((zs[1:] - next_z) ** 2, dim=(1, 2)) * rho_t) / T
        qs = model.Q(live, zs[:-1], action, return_type='all',
                     keep_mask=noise.q_keep, task=task)
        reward_preds = model.reward(live, zs[:-1], action, task)
        reward_loss = torch.sum(torch.mean(
            math.soft_ce(reward_preds, reward, cfg.num_bins, cfg.vmin,
                         cfg.vmax), dim=(1, 2)) * rho_t) / T
        value_loss = torch.sum(torch.mean(
            math.soft_ce(qs, td_targets[None], cfg.num_bins, cfg.vmin,
                         cfg.vmax), dim=(2, 3)) * rho_t[None]) / (T * cfg.num_q)
        total = cfg.consistency_coef * consistency + cfg.reward_coef * reward_loss
        if cfg.episodic:
            # the termination head on the predicted latents z_1..z_T
            # (JAX tdmpc2.py:977-987)
            term_logit = model.termination(live, zs[1:], task, unnormalized=True)
            termination_loss = torch.mean(
                math.sigmoid_binary_cross_entropy(term_logit, terminated))
            total = total + cfg.termination_coef * termination_loss
        else:
            termination_loss = torch.zeros((), device=total.device)
        total = total + cfg.value_coef * value_loss
        groups = optim.model_groups(live)
        flat = {g: tree.leaves(p) for g, p in groups.items()}
        # the conv encoder's backward in f32 too, by deterministic algorithms:
        # the same weight gradients in every run and in the graph's replays
        with layers.f32_convs(deterministic=True):
            grads = torch.autograd.grad(total, flat['enc'] + flat['rest'])
        n_enc = len(flat['enc'])
        grad_norm = optim.model_step_(
            state.params, {'enc': list(grads[:n_enc]),
                           'rest': list(grads[n_enc:])},
            state.opt_state, cfg)

        # -- policy loss on the updated weights (reference tdmpc2.py:208-239)
        zs = zs.detach()
        pi_live = tree.map(lambda p: p.detach().requires_grad_(True),
                           state.params['pi'])
        p = dict(state.params, pi=pi_live)
        a_pi, info = model.pi(p, zs, noise.pi_eps, task)
        qs_pi = model.Q(p, zs, a_pi, qidx=noise.pi_qidx, return_type='avg',
                        detach=True, keep_mask=noise.pi_keep, task=task)
        new_scale = update_scale(state.scale, qs_pi[0], cfg.tau)
        pi_loss = torch.mean(-torch.mean(
            cfg.entropy_coef * info['scaled_entropy'] + qs_pi / new_scale,
            dim=(1, 2)) * rho_pi)
        pi_grads = list(torch.autograd.grad(pi_loss, tree.leaves(pi_live)))
        pi_grad_norm = optim.pi_step_(state.params['pi'], pi_grads,
                                      state.pi_opt_state, cfg)

        # -- Polyak target update (reference tdmpc2.py:316)
        optim.polyak_(state.target_Qs, state.params['Qs'], cfg.tau)
        state.scale.copy_(new_scale)    # in place: an update graph reads it
        out = {
            'consistency_loss': consistency.detach(),
            'reward_loss': reward_loss.detach(),
            'value_loss': value_loss.detach(),
            'termination_loss': termination_loss.detach(),
            'total_loss': total.detach(),
            'grad_norm': grad_norm,
            'pi_loss': pi_loss.detach(),
            'pi_grad_norm': pi_grad_norm,
            'pi_entropy': info['entropy'].detach().mean(),
            'pi_scaled_entropy': info['scaled_entropy'].detach().mean(),
            'pi_scale': new_scale,
        }
        if cfg.episodic:
            out.update(math.termination_statistics(
                torch.sigmoid(term_logit[-1].detach()), terminated[-1]))
        return out


def _canon(v):
    """Compare across pickling: tuples for lists, Python scalars."""
    if isinstance(v, dict):
        return {k: _canon(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return tuple(_canon(x) for x in v)
    if isinstance(v, (np.generic, np.ndarray)) and np.ndim(v) == 0:
        return v.item()
    return v


def _to(tree_, device):
    return tree.map(lambda x: x.to(device=device, dtype=torch.float32), tree_)
