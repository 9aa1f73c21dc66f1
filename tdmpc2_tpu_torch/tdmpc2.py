"""TD-MPC2 agent, acting path (port of tdmpc2_tpu/tdmpc2.py).

`act` encodes the observation and plans with MPPI, as the JAX agent's
`_plan` (tdmpc2.py:523-641) with the whole-CEM kernel: the policy-prior
rollouts, `iterations` x (sample, value, elite moment update), then the top
E of the last iteration and a Gumbel pick of one elite's first action.
The loop runs on the hand-written kernels of ops/cem.py on the card, and
on their plain versions on the CPU. The encoder, the final top-k and the
Gumbel pick are plain torch, as they are plain XLA in the JAX package.

All noise is data. `draw_noise` draws it from the agent's explicit
`torch.Generator` on the device; `plan` takes a `PlanNoise` so a test can
feed the draws the JAX planner made.

No update or optimizer yet: training is a later part of the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tdmpc2_tpu_torch.models.world_model import WorldModel
from tdmpc2_tpu_torch.ops import math
from tdmpc2_tpu_torch.ops.cem import cem_plan
from tdmpc2_tpu_torch.ops.value import prepare_value_params


@dataclass
class PlanNoise:
    """Every random draw of one plan (shapes for H, S, A, E, I, n_pi)."""
    pi_eps: torch.Tensor    # [n_pi, H*A] policy-prior rollout eps
    sample: torch.Tensor    # [I, S, H*A] sampling noise (rows < n_pi unused)
    eps: torch.Tensor       # [I, S, A] terminal policy eps
    qidx: torch.Tensor      # [I, 2] int32 Q heads
    gumbel: torch.Tensor    # [E] Gumbel noise of the final pick
    act: torch.Tensor       # [A] exploration noise (not in eval mode)


def device_of(name: str) -> torch.device:
    """torch.device for `name`; 'cuda' without a card raises."""
    dev = torch.device(name)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'device=cuda but torch.cuda.is_available() is False; '
            'pass device=cpu to run the plain versions on the CPU')
    return dev


class TDMPC2:
    """TD-MPC2 agent: single-task, state observations, acting/eval only."""

    def __init__(self, cfg, device=None):
        if cfg.episodic:
            raise NotImplementedError('episodic tasks: later part of the port')
        self.cfg = cfg
        self.device = device_of(device or cfg.device)
        self.model = WorldModel(cfg)
        # heuristic for large action spaces (reference tdmpc2.py:34)
        self.iterations = cfg.iterations + 2 * int(cfg.action_dim >= 20)
        self.discount = float(self._get_discount(cfg.episode_length))
        H = cfg.horizon
        self.discs = (torch.tensor(self.discount, dtype=torch.float32)
                      ** torch.arange(H + 1, dtype=torch.float32)).to(self.device)
        self.amask = torch.ones(cfg.action_dim, device=self.device)
        # the kernels take bf16 weights; the CPU path keeps f32 (reference)
        self.dot_dtype = (torch.bfloat16 if self.device.type == 'cuda'
                          else torch.float32)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.prev_mean = torch.zeros(H, cfg.action_dim, device=self.device)
        self.load_params(self.model.init(
            torch.Generator().manual_seed(cfg.seed)))

    def _get_discount(self, episode_length):
        """Episode-length -> discount heuristic (reference tdmpc2.py:57-70)."""
        frac = episode_length / self.cfg.discount_denom
        return min(max((frac - 1) / frac, self.cfg.discount_min),
                   self.cfg.discount_max)

    def load_params(self, params):
        """Take a parameter pytree (e.g. from interop.params_from_jax) and
        prepare the planner's weights once."""
        self.params = _to(params, self.device)
        self.prep = prepare_value_params(self.params, self.cfg, self.dot_dtype)

    # ------------------------------------------------------------------ act

    @torch.no_grad()
    def act(self, obs, t0=False, eval_mode=False):
        """One observation (numpy) -> one action (numpy) by planning."""
        obs = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        if not self.cfg.mpc:
            z = self.model.encode(self.params, obs[None])
            eps = torch.randn(1, self.cfg.action_dim, generator=self.generator,
                              device=self.device)
            a, info = self.model.pi(self.params, z, eps)
            return (info['mean'] if eval_mode else a)[0].cpu().numpy()
        a, self.prev_mean = self.plan(obs, t0=t0, eval_mode=eval_mode)
        return a.cpu().numpy()

    def draw_noise(self) -> PlanNoise:
        cfg, g, dev = self.cfg, self.generator, self.device
        H, S, A = cfg.horizon, cfg.num_samples, cfg.action_dim
        I = self.iterations
        u = torch.rand(cfg.num_elites, generator=g, device=dev)
        return PlanNoise(
            pi_eps=torch.randn(max(cfg.num_pi_trajs, 1), H * A, generator=g,
                               device=dev),
            sample=torch.randn(I, S, H * A, generator=g, device=dev),
            eps=torch.randn(I, S, A, generator=g, device=dev),
            qidx=torch.argsort(torch.rand(I, cfg.num_q, generator=g,
                                          device=dev), dim=-1)[:, :2]
            .to(torch.int32).contiguous(),
            gumbel=-torch.log(-torch.log(
                u.clamp(min=torch.finfo(torch.float32).tiny))),
            act=torch.randn(A, generator=g, device=dev),
        )

    @torch.no_grad()
    def plan(self, obs, t0=False, eval_mode=False, noise: PlanNoise = None):
        """MPPI plan for one observation [obs_dim] -> (action [A], mean [H, A])."""
        cfg = self.cfg
        H, E, A = cfg.horizon, cfg.num_elites, cfg.action_dim
        if noise is None:
            noise = self.draw_noise()
        z0 = self.model.encode(self.params, obs.reshape(1, -1).float())
        if t0:
            mean0 = torch.zeros(H, A, device=self.device)
        else:
            mean0 = torch.cat([self.prev_mean[1:],
                               torch.zeros(1, A, device=self.device)], 0)
        std0 = torch.full((H * A,), cfg.max_std, device=self.device)
        mean, std, value, acts = cem_plan(
            self.prep, z0, noise.pi_eps, noise.sample, noise.eps, noise.qidx,
            self.discs, mean0.reshape(H * A), std0, self.amask,
            iterations=self.iterations, n_pi=cfg.num_pi_trajs, num_elites=E,
            temperature=cfg.temperature, min_std=cfg.min_std,
            max_std=cfg.max_std, log_std_min=self.model.log_std_min,
            log_std_dif=self.model.log_std_dif, simnorm_dim=cfg.simnorm_dim)
        # last iteration's elites + Gumbel pick (JAX tdmpc2.py:630-641)
        elite_value, elite_idx = torch.topk(value[:, 0], E)
        score = torch.exp(cfg.temperature * (elite_value - elite_value.max()))
        score = score / score.sum()
        idx = math.gumbel_softmax_sample(score, noise.gumbel)
        a = acts[elite_idx[idx], :A]
        if not eval_mode:
            a = a + std[:A] * noise.act
        return torch.clamp(a, -1.0, 1.0), mean.reshape(H, A)

    def _estimate_value(self, z, actions, eps, qidx):
        """H-step value through the model heads, the JAX agent's plain
        branch (tdmpc2.py:498-521): z [S, L]; actions [H, S, A];
        eps [S, A]; qidx [2] -> [S, 1]. A reference for the planner's value
        step; the planner itself runs ops/value.py."""
        params, cfg = self.params, self.cfg
        G = torch.zeros(z.shape[0], 1, device=z.device)
        disc = 1.0
        for a_t in actions:
            r = math.two_hot_inv(self.model.reward(params, z, a_t),
                                 cfg.num_bins, cfg.vmin, cfg.vmax)
            z = self.model.next(params, z, a_t)
            G = G + disc * r
            disc = disc * self.discount
        action, _ = self.model.pi(params, z, eps)
        q = self.model.Q(params, z, action, qidx=qidx.long(), return_type='avg')
        return G + disc * q


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_to(v, device) for v in tree)
    return tree.to(device=device, dtype=torch.float32)
