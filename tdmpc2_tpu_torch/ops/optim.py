"""The update's optimisers: the port of the optax chains of the JAX agent
(tdmpc2_tpu/tdmpc2.py:102-114, labels `_optim_labels` :53-64).

- The model optimiser clips the gradient by its global norm over the whole
  parameter tree (the policy's zero gradients count for nothing), then
  runs Adam with lr * enc_lr_scale on the encoder ('enc') and lr on the
  dynamics, reward and Q heads ('rest'). The policy is left untouched
  (optax.set_to_zero).
- The policy's own optimiser clips, then runs Adam with eps 1e-5.
- `polyak_` is optax.incremental_update, in place.

Clipping is optax's: the gradient is scaled by max_norm / norm only when
norm >= max_norm (torch.nn.utils.clip_grad_norm_ adds 1e-6 to the norm and
so computes something else). An Adam state is a dict of plain tensors,
{'count': int32 [], 'mu': tree, 'nu': tree}, one to one with optax's
ScaleByAdamState. Updates are in place, through torch's multi-tensor
(`_foreach`) ops, so a step costs a few launches and no host sync.
"""

from __future__ import annotations

import torch

from tdmpc2_tpu_torch.utils import tree

B1, B2 = 0.9, 0.999


def model_groups(params) -> dict:
    """The model optimiser's parameter groups: {'enc': encoder subtree,
    'rest': every other subtree but the policy's}."""
    return {'enc': params['encoder'],
            'rest': {k: v for k, v in params.items()
                     if k not in ('encoder', 'pi')}}


def adam_init(params) -> dict:
    return {'count': torch.zeros((), dtype=torch.int32,
                                 device=tree.leaves(params)[0].device),
            'mu': tree.map(torch.zeros_like, params),
            'nu': tree.map(torch.zeros_like, params)}


def model_opt_init(params) -> dict:
    return {g: adam_init(p) for g, p in model_groups(params).items()}


def global_norm(grads: list) -> torch.Tensor:
    """sqrt of the sum of squares of every element of `grads`."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


@torch.no_grad()
def clip_by_global_norm_(grads: list, max_norm: float) -> torch.Tensor:
    """Scale `grads` in place to a global norm of at most `max_norm`, as
    optax.clip_by_global_norm does; returns the norm before clipping."""
    norm = global_norm(grads)
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


@torch.no_grad()
def adam_(params: list, grads: list, state: dict, lr: float,
          eps: float = 1e-8):
    """One Adam step (optax.adam: scale_by_adam, then -lr) on the leaves
    `params`, in place, with `state`'s moments in the same leaf order."""
    mu, nu = tree.leaves(state['mu']), tree.leaves(state['nu'])
    state['count'] += 1
    torch._foreach_mul_(mu, B1)
    torch._foreach_add_(mu, grads, alpha=1.0 - B1)
    torch._foreach_mul_(nu, B2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - B2)
    count = state['count'].float()
    bc1, bc2 = 1.0 - B1 ** count, 1.0 - B2 ** count
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    step = torch._foreach_div(mu, bc1)
    torch._foreach_div_(step, denom)
    torch._foreach_mul_(step, -lr)
    torch._foreach_add_(params, step)


@torch.no_grad()
def model_step_(params, grads: dict, state: dict, cfg) -> torch.Tensor:
    """Clip and step the model optimiser in place. `grads` maps each group
    of `model_groups` to its gradient leaves. Returns the global norm."""
    norm = clip_by_global_norm_(grads['enc'] + grads['rest'],
                                cfg.grad_clip_norm)
    lrs = {'enc': cfg.lr * cfg.enc_lr_scale, 'rest': cfg.lr}
    for g, p in model_groups(params).items():
        adam_(tree.leaves(p), grads[g], state[g], lrs[g])
    return norm


@torch.no_grad()
def pi_step_(pi_params, grads: list, state: dict, cfg) -> torch.Tensor:
    """Clip and step the policy's optimiser in place; returns the norm."""
    norm = clip_by_global_norm_(grads, cfg.grad_clip_norm)
    adam_(tree.leaves(pi_params), grads, state, cfg.lr, eps=1e-5)
    return norm


@torch.no_grad()
def polyak_(target, online, tau: float):
    """target <- tau * online + (1 - tau) * target, leaf by leaf, in place."""
    t = tree.leaves(target)
    torch._foreach_mul_(t, 1.0 - tau)
    torch._foreach_add_(t, tree.leaves(online), alpha=tau)
