"""Mixture-of-Experts block with expert parallelism (PyTorch port of
``accvlab_tpu/models/moe.py``).

A top-k routed expert FFN in the dense-dispatch form: every expert sees
every token and the gates mask the combine, so the shapes are fixed. The
expert weights carry a leading expert dim; on a mesh they are ``DTensor``\\ s
``Shard(0)`` over the ``expert`` axis and each rank computes its own
experts. What GSPMD inserts in JAX is written out here
(:mod:`..parallel._collectives`):

* the tokens and the gates enter the rank's experts through the identity
  whose gradient is summed over ``expert`` (each rank sees the cotangent of
  its own experts only);
* the combine is the rank's partial sum, then a sum over ``expert`` whose
  cotangent passes through (``torch.distributed.nn.functional.all_reduce``
  would multiply every gradient behind it by the axis size);
* the batch may be split over ``data`` (the inputs are ``DTensor``\\ s
  ``Shard(0)`` there): the aux loss is built from global means over
  (B, T), each of ``frac`` and ``mean_prob`` summed over ``data`` before
  their product, and every parameter's gradient is summed over ``data``,
  so ``backward()`` gives ``jax.grad``'s gradients.

Numerics follow flax's: the router is a float32 ``Dense``; top-k is a
stable descending sort (ties to the lower index, as ``lax.top_k``); the
three expert einsums run in bfloat16, ``nn.gelu`` is the tanh
approximation, and the combine runs in float32; ``LayerNorm`` uses eps 1e-6
and the fast variance.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from .._device import device_of, resolve_device
from ..parallel import _collectives as col
from .centernet import LECUN_TRUNCATION

Tensor = torch.Tensor
LAYER_NORM_EPS = 1e-6


def _lecun_normal_(weight: Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / LECUN_TRUNCATION
    draws = torch.empty(weight.shape, dtype=weight.dtype)
    nn.init.trunc_normal_(draws, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    weight.copy_(draws)


def _top_k(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``lax.top_k``: descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class _Placement:
    """Where one forward runs: the mesh (or none), the axes the batch is
    split over, and the expert axis with this rank's first expert."""

    def __init__(self, x, w_in):
        self.mesh: Optional[DeviceMesh] = None
        self.data_axes: Tuple[str, ...] = ()
        self.expert_axis: Optional[str] = None
        for t in (x, w_in):
            if isinstance(t, DTensor):
                if self.mesh is not None and t.device_mesh != self.mesh:
                    raise ValueError("the tokens and the expert weights lie on different meshes")
                self.mesh = t.device_mesh
        if self.mesh is None:
            return
        names = self.mesh.mesh_dim_names
        if isinstance(x, DTensor):
            self.data_axes = tuple(n for n, p in zip(names, x.placements) if p == Shard(0))
        if isinstance(w_in, DTensor):
            experts = [n for n, p in zip(names, w_in.placements) if p == Shard(0)]
            if len(experts) > 1:
                raise ValueError(f"the expert weights are split over {experts}: one axis at most")
            self.expert_axis = experts[0] if experts else None

    def param(self, p: Tensor) -> Tensor:
        """A parameter's local tensor; its gradient summed over the axes the
        batch is split over (every parameter is replicated there)."""
        local = p.to_local() if isinstance(p, DTensor) else p
        if self.mesh is None or not self.data_axes:
            return local
        return col.sum_grad_over(local, self.mesh, self.data_axes)

    def global_mean(self, x: Tensor, count: int) -> Tensor:
        """The mean over (B, T) of the whole batch, from this rank's rows."""
        if self.mesh is None or not self.data_axes:
            return x.mean(dim=(0, 1))
        total = x.sum(dim=(0, 1))
        for axis in self.data_axes:
            total = col.psum(total, self.mesh, axis)
            count *= col.axis_size(self.mesh, axis)
        return total / count


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _as_input(x: Tensor, like) -> Tensor:
    """``x`` (this rank's rows) as a DTensor with the batch placements of
    ``like`` when ``like`` is one."""
    if not isinstance(like, DTensor):
        return x
    placements = tuple(Shard(0) if p == Shard(0) else Replicate() for p in like.placements)
    shape = (like.shape[0],) + tuple(x.shape[1:])
    return DTensor.from_local(x, like.device_mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _replicated(x: Tensor, like) -> Tensor:
    if not isinstance(like, DTensor):
        return x
    mesh = like.device_mesh
    return DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim, run_check=False)


class SwitchFFN(nn.Module):
    """Top-k routed expert FFN (dense dispatch).

    ``num_selected=1`` is the Switch Transformer (a token weighted by its raw
    top-1 router probability); ``num_selected=2`` is GShard-style top-2 (the
    selected gates renormalized to sum to 1). Input and output ``(batch,
    tokens, dim)``; the aux output is the load-balancing loss
    ``E * sum_e f_e * P_e`` with ``f_e`` the top-1 dispatch fraction.

    Parameters: ``router`` (a ``Linear(dim, num_experts)``), ``w_in``
    ``(E, dim, hidden)`` and ``w_out`` ``(E, hidden, dim)``. On a mesh,
    ``w_in`` and ``w_out`` are ``DTensor``\\ s ``Shard(0)`` over the expert
    axis and the input may be a ``DTensor`` ``Shard(0)`` over ``data``; the
    output then is one too, and the aux a replicated ``DTensor``.
    """

    def __init__(self, num_experts: int, dim: int, hidden: int, num_selected: int = 1):
        super().__init__()
        if not 1 <= num_selected <= num_experts:
            raise ValueError(f"num_selected={num_selected} must be in [1, num_experts="
                             f"{num_experts}]")
        self.num_experts, self.dim, self.hidden = num_experts, dim, hidden
        self.num_selected = num_selected
        self.router = nn.Linear(dim, num_experts)
        self.w_in = nn.Parameter(torch.empty(num_experts, dim, hidden))
        self.w_out = nn.Parameter(torch.empty(num_experts, hidden, dim))

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        at = _Placement(x, self.w_in)
        out, aux = self.local_forward(_local(x), at)
        return _as_input(out, x), _replicated(aux, x)

    def local_forward(self, x: Tensor, at: _Placement) -> Tuple[Tensor, Tensor]:
        """The block on this rank's tokens ``x`` (a plain tensor)."""
        e, k = self.num_experts, self.num_selected
        b, t, _ = x.shape
        logits = x.float() @ at.param(self.router.weight).t() + at.param(self.router.bias)
        probs = torch.softmax(logits, dim=-1)
        gate_vals, top_idx = _top_k(probs, k)
        if k == 1:
            gates = gate_vals
        else:
            gates = gate_vals / (gate_vals.sum(dim=-1, keepdim=True) + 1e-9)
        sel = F.one_hot(top_idx, e).to(x.dtype)  # (B, T, k, E)
        gate_e = torch.einsum("btk,btke->bte", gates, sel)

        w_in, w_out = at.param(self.w_in), at.param(self.w_out)
        x_e = x
        if at.expert_axis is not None:
            # the tokens and gates enter this rank's experts: their cotangents
            # from the other experts arrive through the sum over the axis
            first = at.mesh.get_local_rank(at.expert_axis) * w_in.shape[0]
            x_e = col.sum_grad_over(x, at.mesh, (at.expert_axis,))
            gate_e = col.sum_grad_over(gate_e, at.mesh, (at.expert_axis,))
            gate_e = gate_e[..., first: first + w_in.shape[0]]
        hdn = torch.einsum("btd,edh->beth", x_e.to(torch.bfloat16), w_in.to(torch.bfloat16))
        hdn = F.gelu(hdn, approximate="tanh")
        y = torch.einsum("beth,ehd->betd", hdn, w_out.to(torch.bfloat16))
        out = torch.einsum("bte,betd->btd", gate_e, y.float())
        if at.expert_axis is not None:
            out = col.psum(out, at.mesh, at.expert_axis)

        frac = at.global_mean(sel[:, :, 0, :], b * t)
        mean_prob = at.global_mean(probs, b * t)
        aux = e * torch.sum(frac * mean_prob)
        return out, aux


def _layer_norm(x: Tensor, scale: Tensor, bias: Tensor) -> Tensor:
    """flax ``nn.LayerNorm()``: fast variance, eps 1e-6."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * (torch.rsqrt(var + LAYER_NORM_EPS) * scale) + bias


class MoEClassifier(nn.Module):
    """Tiny token classifier around :class:`SwitchFFN`: ``Dense(dim)``, the
    block with a residual, ``LayerNorm``, the mean over tokens and
    ``Dense(num_classes)``. Returns ``(logits, aux)``.

    ``in_dim`` is the tokens' feature size (flax infers it at ``init``);
    left ``None``, the first ``Dense`` is built by :meth:`build`, which
    ``make_moe_train_step``'s ``init_fn`` and ``load_jax_params`` call.
    """

    def __init__(self, num_experts: int, dim: int, num_classes: int, num_selected: int = 1,
                 *, in_dim: Optional[int] = None):
        super().__init__()
        self.num_experts, self.dim, self.num_classes = num_experts, dim, num_classes
        self.num_selected = num_selected
        self.dense_0: Optional[nn.Linear] = None
        if in_dim is not None:
            self.build(in_dim)
        self.switch = SwitchFFN(num_experts, dim, dim * 2, num_selected=num_selected)
        self.norm = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.dense_1 = nn.Linear(dim, num_classes)

    def build(self, in_dim: int) -> "MoEClassifier":
        """Make the first ``Dense`` for tokens of ``in_dim`` features (once)."""
        if self.dense_0 is None:
            self.dense_0 = nn.Linear(in_dim, self.dim)
        elif self.dense_0.in_features != in_dim:
            raise ValueError(f"the classifier takes {self.dense_0.in_features} features, "
                             f"not {in_dim}")
        return self

    def forward(self, tokens: Tensor) -> Tuple[Tensor, Tensor]:
        if self.dense_0 is None:
            raise RuntimeError("MoEClassifier has no input layer yet: pass in_dim= or call "
                               "build(in_dim) (make_moe_train_step's init_fn does)")
        at = _Placement(tokens, self.switch.w_in)
        x = _local(tokens).float()
        x = x @ at.param(self.dense_0.weight).t() + at.param(self.dense_0.bias)
        y, aux = self.switch.local_forward(x, at)
        x = _layer_norm(x + y, at.param(self.norm.weight), at.param(self.norm.bias))
        logits = x.mean(dim=1) @ at.param(self.dense_1.weight).t() + at.param(self.dense_1.bias)
        return _as_input(logits, tokens), _replicated(aux, tokens)


def _init_order(model: nn.Module) -> list:
    """The modules in flax's parameter order (``Dense_0``, ``SwitchFFN_0``
    with its router, ``LayerNorm_0``, ``Dense_1``), whatever order they were
    registered in."""
    if isinstance(model, SwitchFFN):
        return [model.router, model]
    return [model.dense_0, model.switch.router, model.switch, model.norm, model.dense_1]


def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's initialisers, drawn on the CPU from ``generator`` in flax's
    parameter order: ``lecun_normal`` kernels (the expert weights' fan-in is
    ``E * fan_in``, as flax counts the leading expert dim as a receptive
    field), zero biases, unit LayerNorm scales. The distribution matches
    flax's, the bits cannot."""
    with torch.no_grad():
        for mod in _init_order(model):
            if isinstance(mod, nn.Linear):
                _lecun_normal_(mod.weight, mod.weight.shape[1], generator)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            else:
                for w in (mod.w_in, mod.w_out):
                    _lecun_normal_(w, w.shape[0] * w.shape[1], generator)
    return model


def make_moe_shardings(mesh: DeviceMesh, params, batch):
    """Placements for expert-parallel training on ``mesh`` (axes ``("data",
    "expert")``), in the form of :func:`..parallel.make_fsdp_shardings`: the
    expert weights ``Shard(0)`` over ``expert``, every other parameter
    replicated, every batch leaf ``Shard(0)`` over ``data``.

    ``params`` is the model or a dict of its named parameters; the result's
    parameter tree is a dict of the same names. Apply them with
    :func:`shard_moe_params` and :func:`..parallel.shard_batch`.
    """
    names = mesh.mesh_dim_names
    named = dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)

    def param_spec(name):
        if name.split(".")[-1] in ("w_in", "w_out"):
            return tuple(Shard(0) if n == "expert" else Replicate() for n in names)
        return (Replicate(),) * len(names)

    batch_sh = pytree.tree_map(
        lambda leaf: tuple(Shard(0) if n == "data" else Replicate() for n in names), batch)
    return {name: param_spec(name) for name in named}, batch_sh


def shard_moe_params(model: nn.Module, mesh: DeviceMesh, placements: dict) -> nn.Module:
    """Replace each parameter of ``model`` by a ``DTensor`` on ``mesh`` with
    its placements (from :func:`make_moe_shardings`); every rank keeps its
    own shard of the full parameter it holds (in place; returns the model)."""
    for name, p in list(model.named_parameters()):
        owner = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
        leaf = name.rsplit(".", 1)[-1]
        full = p.to_local() if isinstance(p, DTensor) else p.detach()
        setattr(owner, leaf, nn.Parameter(col.from_full(full, mesh, placements[name])))
    return model


def _cross_entropy_sum(logits: Tensor, labels: Tensor) -> Tensor:
    """The summed ``softmax_cross_entropy_with_integer_labels`` of the rows."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None]).sum()


def moe_loss(params: MoEClassifier, batch, aux_weight: float = 0.01) -> Tensor:
    """The mean cross-entropy over the whole batch plus ``aux_weight`` *
    aux (one replicated scalar on a mesh)."""
    tokens, labels = batch["tokens"], batch["labels"]
    logits, aux = params(tokens)
    at = _Placement(tokens, params.switch.w_in)
    ce = _cross_entropy_sum(_local(logits), _local(labels))
    n = _local(labels).shape[0]
    for axis in at.data_axes:
        ce = col.psum(ce, at.mesh, axis)
        n *= col.axis_size(at.mesh, axis)
    return ce / n + aux_weight * _local(aux)


def make_moe_train_step(model: MoEClassifier, aux_weight: float = 0.01):
    """``(init_fn, train_step)``: cross-entropy + ``aux_weight`` * aux, plain
    SGD (no optimizer state to shard).

    ``init_fn(key, tokens, device=None)`` builds the model for the tokens'
    feature size, draws its parameters from ``key`` (an int seed or a CPU
    ``torch.Generator``) and moves it to the tokens' device (for numpy
    tokens ``device``, default the card); it returns the model.

    ``train_step(params, batch, lr=1e-2)`` updates ``params`` (the model) in
    place and returns ``(params, {"loss": loss})``. With ``DTensor`` batch
    leaves (``Shard(0)`` over ``data``) the loss is the mean over the whole
    batch and the gradients are ``jax.grad``'s.
    """

    def init_fn(key: Union[int, torch.Generator], tokens, device=None):
        dev = device_of(_local(tokens), device)
        gen = key if isinstance(key, torch.Generator) else torch.Generator().manual_seed(int(key))
        model.build(int(tokens.shape[-1]))
        init_params(model, gen)
        return model.to(dev)

    def train_step(params: MoEClassifier, batch, lr: float = 1e-2):
        for p in params.parameters():
            p.grad = None
        loss = moe_loss(params, batch, aux_weight)
        loss.backward()
        with torch.no_grad():
            for p in params.parameters():
                p.sub_(lr * p.grad)
                p.grad = None
        return params, {"loss": loss.detach()}

    return init_fn, train_step


def make_moe_example_batch(batch_size: int, tokens: int, in_dim: int, num_classes: int,
                           device=None) -> dict:
    """A synthetic batch from a CPU ``torch.Generator`` seeded 7: tokens
    ``(B, T, in_dim)`` normal float32, labels ``(B,)`` int64 in
    ``[0, num_classes)`` (JAX's values come from ``jax.random`` and cannot be
    matched). ``device`` defaults to the card."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(7)
    return {"tokens": torch.randn((batch_size, tokens, in_dim), generator=gen).to(dev),
            "labels": torch.randint(0, num_classes, (batch_size,), generator=gen).to(dev)}


__all__ = ["SwitchFFN", "MoEClassifier", "make_moe_shardings", "make_moe_train_step",
           "make_moe_example_batch"]
