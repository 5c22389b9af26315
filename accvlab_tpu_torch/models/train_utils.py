"""Training-step utilities: EMA of the parameters and gradient accumulation.

PyTorch port of ``accvlab_tpu/models/train_utils.py``. The JAX package's
parameter pytrees become (nested) dicts of tensors, such as
``model.state_dict()``. JAX's ``lax.scan`` over microbatches becomes a
Python loop with one optimizer step at the end.
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from ..ragged import RaggedBatch

__all__ = ["make_grad_accum_step", "ema_init", "ema_update", "ema_params"]


def _tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def ema_init(params):
    """An exponential-moving-average state: a detached copy of ``params``
    (not an alias, so updating the parameters in place leaves it alone)."""
    return _tree_map(lambda x: x.detach().clone(), params)


def ema_update(ema, params, decay: float = 0.999, step=None):
    """One EMA step: ``ema = decay * ema + (1 - decay) * params``, with the
    warm-up correction ``min(decay, (1 + step) / (10 + step))`` when
    ``step`` (an int or a device scalar) is given. Computed in float32 as
    in the JAX package; integer leaves take the parameter's value."""
    if isinstance(step, torch.Tensor):
        s = step.to(torch.float32)
        d = torch.minimum(torch.full_like(s, decay), (1.0 + s) / (10.0 + s))
    else:
        d = np.float32(decay)
        if step is not None:
            s = np.float32(step)
            d = min(d, (np.float32(1.0) + s) / (np.float32(10.0) + s))

    def upd(e: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        if not (e.is_floating_point() or e.is_complex()):
            return p
        if isinstance(d, torch.Tensor):
            de = d.to(e.dtype)
            return e * de + p.to(e.dtype) * (1 - de)
        de = np.float32(d)
        return e * float(de) + p.to(e.dtype) * float(np.float32(1.0) - de)

    return _tree_map(upd, ema, params)


def ema_params(ema):
    """The EMA state is the serving parameters; returned as is."""
    return ema


def _split(leaf, accum_steps: int) -> List[Any]:
    """``leaf`` cut along its leading (batch) axis into ``accum_steps``
    equal microbatches."""
    if isinstance(leaf, RaggedBatch):
        parts = [_split(x, accum_steps) for x in (leaf.tensor, leaf.mask, leaf.sample_sizes)]
        return [RaggedBatch(t, m, s, leaf.non_uniform_dim) for t, m, s in zip(*parts)]
    if isinstance(leaf, dict):
        keys = list(leaf)
        parts = [_split(leaf[k], accum_steps) for k in keys]
        return [dict(zip(keys, vals)) for vals in zip(*parts)]
    if isinstance(leaf, (list, tuple)):
        parts = [_split(v, accum_steps) for v in leaf]
        return [type(leaf)(vals) for vals in zip(*parts)]
    n = leaf.shape[0]
    if n % accum_steps:
        raise ValueError(f"batch leading dim {n} is not divisible by accum_steps={accum_steps}")
    return list(leaf.reshape(accum_steps, n // accum_steps, *leaf.shape[1:]).unbind(0))


def make_grad_accum_step(loss_fn: Callable, accum_steps: int, remat: bool = False):
    """Build a gradient-accumulation train step.

    Splits the leading (batch) axis of every batch leaf into
    ``accum_steps`` equal microbatches, sums their gradients in order,
    scales the sum by ``1 / accum_steps`` and applies one optimizer step.
    For a mean-reduced ``loss_fn`` this is the full-batch step at about
    ``1 / accum_steps`` of the activation memory; ``remat=True`` also
    recomputes each microbatch's activations in its backward pass.

    Args:
        loss_fn: ``loss_fn(model, microbatch) -> scalar tensor``.
        accum_steps: number of microbatches; every batch leaf's leading
            dim must be divisible by it.
        remat: checkpoint the loss computation (``torch.utils.checkpoint``).

    Returns:
        ``train_step(model, optimizer, batch) -> (model, optimizer, loss)``,
        the loss being the mean over the microbatches (a device scalar).
        The optimizer (built over ``model.parameters()``) is the state that
        the JAX package passes as ``opt_state``.
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps={accum_steps} must be >= 1")

    def micro_loss(model, mb):
        if remat:
            return torch.utils.checkpoint.checkpoint(loss_fn, model, mb, use_reentrant=False)
        return loss_fn(model, mb)

    def train_step(model: nn.Module, optimizer: torch.optim.Optimizer, batch):
        params = [p for p in model.parameters() if p.requires_grad]
        acc = [torch.zeros_like(p) for p in params]
        loss_sum = None
        for mb in _split(batch, accum_steps):
            loss = micro_loss(model, mb)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            acc = [a if g is None else a + g for a, g in zip(acc, grads)]
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        scale = 1.0 / accum_steps
        for p, a in zip(params, acc):
            p.grad = a * scale
        optimizer.step()
        return model, optimizer, loss_sum * scale

    return train_step
