"""TD-MPC2 implicit world model, state and pixel observations, single- and
multi-task (port of tdmpc2_tpu/models/world_model.py:126-256).

The model is a parameter pytree (the JAX package's names and [in, out]
layout, torch tensors for leaves) plus pure apply methods. Where the JAX
heads draw randomness inside, the port takes it as input: `pi` takes its
Gaussian `eps`, `Q` takes the indices of the two heads it averages, and
the pixel encoder takes ShiftAug's integer shifts.

Networks (reference world_model.py:25-30); e is the task embedding, on
multi-task models only:
- encoder:     state MLP on [obs, e], SimNorm-capped; or, for rgb
               observations, the conv encoder (models/layers.py), whose
               flattened output is the latent
- dynamics:    MLP([z, e, a] -> z'), SimNorm-capped
- reward:      MLP([z, e, a] -> num_bins logits)
- termination: MLP([z, e] -> 1 logit), episodic tasks only
- pi:          MLP([z, e] -> 2*action_dim), tanh-squashed Gaussian, its
               mean, log-std and eps masked to the task's action columns
- Qs:          stacked ensemble of MLPs on [z, e, a] -> num_bins logits,
               zero-init output

On a multi-task model every head takes `task`: a long tensor of task
indices whose shape is the input's leading shape, or broadcasts to it from
the right (one task for all rows: shape [1]).
"""

from __future__ import annotations

import torch

from tdmpc2_tpu_torch.models import layers
from tdmpc2_tpu_torch.ops import math


class WorldModel:
    """Stateless apply-function namespace; all params are explicit."""

    def __init__(self, cfg):
        if cfg.obs not in ('state', 'rgb'):
            raise ValueError(f'obs={cfg.obs!r}: state or rgb observations only')
        if cfg.obs == 'rgb':
            if cfg.multitask:
                raise ValueError('obs=rgb: pixel observations are single-task '
                                 '(the JAX package has no multi-task conv encoder)')
            # the conv output is the latent (64 px and 32 channels -> 512,
            # the reference geometry; JAX world_model.py:72-80)
            shape = cfg.obs_shape['rgb']
            conv_out = layers.conv_output_dim(shape[1], shape[2], cfg.num_channels)
            if conv_out != cfg.latent_dim:
                raise ValueError(
                    f'latent_dim={cfg.latent_dim} must equal the conv encoder '
                    f'output {conv_out} for rgb input {tuple(shape)} with '
                    f'num_channels={cfg.num_channels}')
        self.cfg = cfg
        self.log_std_min = float(cfg.log_std_min)
        self.log_std_dif = float(cfg.log_std_max) - float(cfg.log_std_min)
        if cfg.multitask:
            # mask[i, :action_dims[i]] = 1 (reference world_model.py:22-24)
            masks = torch.zeros(len(cfg.tasks), cfg.action_dim)
            for i, ad in enumerate(cfg.action_dims):
                masks[i, :ad] = 1.0
            self.action_masks = masks
        else:
            self.action_masks = None

    def to(self, device) -> 'WorldModel':
        """Keep the action masks on `device`."""
        if self.action_masks is not None:
            self.action_masks = self.action_masks.to(device)
        return self

    def init(self, gen: torch.Generator) -> dict:
        """Fresh parameters on the CPU, drawn from `gen` (the JAX package's
        shapes and init rules, world_model.py:58-104)."""
        cfg = self.cfg
        n_bins = max(cfg.num_bins, 1)
        dt = cfg.task_dim if cfg.multitask else 0
        act_in = cfg.latent_dim + cfg.action_dim + dt
        z_in = cfg.latent_dim + dt
        if cfg.obs == 'rgb':
            encoder = {'rgb': layers.conv_encoder_init(
                gen, cfg.obs_shape['rgb'][0], cfg.num_channels)}
        else:
            encoder = {'state': layers.mlp_init(
                gen, cfg.obs_shape['state'][0] + dt,
                max(cfg.num_enc_layers - 1, 1) * [cfg.enc_dim],
                cfg.latent_dim, final_normed=True)}
        params = {
            'encoder': encoder,
            'dynamics': layers.mlp_init(
                gen, act_in, 2 * [cfg.mlp_dim], cfg.latent_dim,
                final_normed=True),
            'reward': layers.mlp_init(
                gen, act_in, 2 * [cfg.mlp_dim], n_bins, zero_final=True),
            'pi': layers.mlp_init(
                gen, z_in, 2 * [cfg.mlp_dim], 2 * cfg.action_dim),
            'Qs': layers.ensemble_init(
                cfg.num_q, lambda: layers.mlp_init(
                    gen, act_in, 2 * [cfg.mlp_dim], n_bins, zero_final=True)),
        }
        if cfg.episodic:
            params['termination'] = layers.mlp_init(
                gen, z_in, 2 * [cfg.mlp_dim], 1)
        if cfg.multitask:
            params['task_emb'] = layers.embedding_init(
                gen, len(cfg.tasks), cfg.task_dim)
        return params

    def task_emb(self, params, x, task):
        """[x, the task's embedding] (reference world_model.py:88-101): the
        lookup renorms each row to norm at most 1 (torch's
        Embedding(max_norm=1)), a rescale that takes no gradient, as the
        JAX package's stop-gradient at lookup (world_model.py:106-124)."""
        emb = params['task_emb']['w'][task]
        norm = torch.linalg.vector_norm(emb.detach(), dim=-1, keepdim=True)
        emb = emb * torch.clamp(1.0 / torch.clamp(norm, min=1e-12), max=1.0)
        return torch.cat([x, emb.expand(*x.shape[:-1], emb.shape[-1])], dim=-1)

    def _with_task(self, params, x, task):
        return self.task_emb(params, x, task) if self.cfg.multitask else x

    def _simnorm(self, x):
        return layers.simnorm(x, self.cfg.simnorm_dim)

    def encode(self, params, obs, task=None, shifts=None):
        """obs -> SimNorm latent (reference world_model.py:103-112). Pixel
        observations are uint8 frames [B, C, H, W], or [T, B, C, H, W]; with
        `shifts` ([B, 2] or [T, B, 2], ints in [0, 6]) they are ShiftAug'd
        first, each time step with its own draw as the JAX package's key
        split per step (world_model.py:139-143)."""
        if self.cfg.obs == 'rgb':
            lead = obs.shape[:-3]
            z = layers.conv_encoder_apply(
                params['encoder']['rgb'], obs.reshape(-1, *obs.shape[-3:]),
                self.cfg.simnorm_dim,
                None if shifts is None else shifts.reshape(-1, 2))
            return z.reshape(*lead, z.shape[-1])
        return layers.mlp(params['encoder']['state'],
                          self._with_task(params, obs, task),
                          final_act=self._simnorm)

    def next(self, params, z, a, task=None):
        """Latent dynamics (reference world_model.py:114-121)."""
        z = self._with_task(params, z, task)
        return layers.mlp(params['dynamics'], torch.cat([z, a], dim=-1),
                          final_act=self._simnorm)

    def reward(self, params, z, a, task=None):
        """Reward logits (reference world_model.py:123-130)."""
        z = self._with_task(params, z, task)
        return layers.mlp(params['reward'], torch.cat([z, a], dim=-1))

    def termination(self, params, z, task=None, unnormalized: bool = False):
        """Termination probability/logit (reference world_model.py:132-141)."""
        logit = layers.mlp(params['termination'],
                           self._with_task(params, z, task))
        return logit if unnormalized else torch.sigmoid(logit)

    def pi(self, params, z, eps, task=None):
        """Tanh-squashed Gaussian policy prior with the caller's standard
        normal `eps` (the shape of the action). Returns (action, info):
        the squashed mean, the log-std, the entropy and the entropy scaled
        by the action size (reference world_model.py:144-184). On a
        multi-task model the mean, log-std and eps are masked to the task's
        action columns and the size is the task's action count
        (world_model.py:158-162).
        """
        out = layers.mlp(params['pi'], self._with_task(params, z, task))
        mean, lstd = torch.chunk(out, 2, dim=-1)
        lstd = math.log_std(lstd, self.log_std_min, self.log_std_dif)
        if self.cfg.multitask:
            mask = self.action_masks[task]
            mean, lstd, eps = mean * mask, lstd * mask, eps * mask
            size = self.action_masks.sum(-1)[task][..., None]
        else:
            size = float(eps.shape[-1])
        log_prob = math.gaussian_logprob(eps, lstd)
        scaled_log_prob = log_prob * size
        mean, action, log_prob = math.squash(
            mean, mean + eps * torch.exp(lstd), log_prob)
        entropy_scale = scaled_log_prob / (log_prob + 1e-8)
        return action, {'mean': mean, 'log_std': lstd, 'entropy': -log_prob,
                        'scaled_entropy': -log_prob * entropy_scale}

    def Q(self, params, z, a, qidx=None, return_type: str = 'min',
          target_params=None, detach: bool = False, keep_mask=None,
          task=None):
        """State-action value through the stacked Q-ensemble.

        return_type 'all' gives every head's logits [num_q, ..., bins];
        'min'/'avg' decode the two heads `qidx` names (the JAX package draws
        them with a permutation, world_model.py:238-252). `target_params`
        replaces the online heads (the Polyak targets); `detach` stops
        gradients into the online heads; `keep_mask` [num_q, ..., mlp_dim]
        turns on each head's first-layer dropout (world_model.py:216-257).
        """
        cfg = self.cfg
        if target_params is not None:
            qp = target_params
        elif detach:
            qp = tuple({k: v.detach() for k, v in layer.items()}
                       for layer in params['Qs'])
        else:
            qp = params['Qs']
        z = self._with_task(params, z, task)
        out = layers.ensemble(qp, torch.cat([z, a], dim=-1),
                              keep_mask=keep_mask, dropout=cfg.dropout)
        if return_type == 'all':
            return out
        qsub = math.two_hot_inv(out[qidx], cfg.num_bins, cfg.vmin, cfg.vmax)
        if return_type == 'min':
            return torch.min(qsub, dim=0).values
        return torch.sum(qsub, dim=0) / 2
