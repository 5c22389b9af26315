"""GPipe pipeline parallelism over a mesh ``pipe`` axis (port of
``accvlab_tpu/parallel/pipeline_parallel.py``).

Each rank holds its stage's slice of the stage parameters and runs JAX's
tick loop by hand: ``n_micro + n_stages - 1`` ticks; stage 0 takes
microbatch ``clip(t)``, every other stage what the previous stage sent last
tick, and each tick's output moves one stage along the ring
(:class:`_PPermute`: one ``batch_isend_irecv`` on the ``pipe`` group, and
the gradient the other way in the backward). A ``pipe`` axis of one rank
calls no collective, as JAX's ``ppermute`` with perm ``[(0, 0)]`` is the
identity.

Every rank posts the same exchanges in the same tick order, forward and
backward: the stage choice and the bubble masks are ``torch.where`` on
tensors, as in JAX, so every tick's received activation stays in the
autograd graph (with a zero gradient where it is masked out) and no rank
skips an exchange that its neighbour waits on. The last tick's carry is
dropped by every rank, so no rank sends it.

Gradients: the loss' sum over ``pipe`` and mean over the data axes pass
their cotangent through unchanged (the loss is one replicated scalar), and
a stage parameter's gradient is summed over the data axes of ``data_spec``
it is replicated on, as the transpose of a replicated input of JAX's
``shard_map`` does there. Over the other axes (``model`` in a
tensor-parallel stage) the stage function owns its collectives, with
``shard_map``'s transposes (:mod:`._collectives`): a replicated value that
enters work split over ``model`` goes through ``sum_grad_over``, and a
``psum`` passes its cotangent through. ``jax.grad`` of JAX's
:func:`pipeline_loss` and ``backward()`` of this one give the same
gradients.

With ``remat=True`` each stage application runs under
``torch.utils.checkpoint`` (non-reentrant): the backward keeps the
inter-stage activations and recomputes the rest, GPipe's memory.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ._collectives import _SumGradOver
from ._collectives import axis_size as _axis_size
from ._collectives import psum as _psum


def _data_axis_names(data_spec):
    """Flatten a spec's entries (``None``, an axis name or a tuple of names
    per trailing dim) to the mesh-axis names it uses."""
    names = []
    for entry in data_spec:
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            names.extend(entry)
        else:
            names.append(entry)
    return tuple(names)


def _peer(mesh: DeviceMesh, axis: str, offset: int) -> int:
    """Global rank of the rank ``offset`` steps along ``axis`` (cyclic)."""
    dim = mesh.mesh_dim_names.index(axis)
    coord = list(mesh.get_coordinate())
    coord[dim] = (coord[dim] + offset) % mesh.size(dim)
    return int(mesh.mesh[tuple(coord)])


def _exchange(x: torch.Tensor, group, send_to: int, recv_from: int) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, send_to, group), dist.P2POp(dist.irecv, out, recv_from, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PPermute(torch.autograd.Function):
    """``lax.ppermute`` one step along the ring: forward sends to the next
    stage and receives from the previous one; backward sends the gradient
    back and receives the next stage's."""

    @staticmethod
    def forward(ctx, y, group, nxt: int, prv: int):
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return _exchange(y, group, nxt, prv)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group, ctx.prv, ctx.nxt), None, None, None


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _is_placements(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(p, Placement) for p in x)


def _stage_slices(stage_params, mesh: DeviceMesh, pipe_axis: str, param_specs, data_axes=()):
    """Each leaf's slice for this rank's stage, its gradient summed over the
    data axes the leaf is replicated on (each such rank saw its own part of
    the batch). Over any other axis the stage function owns the collectives,
    as under ``shard_map``: a replicated leaf that enters work split over
    that axis goes through ``sum_grad_over`` there."""
    pipe_dim = mesh.mesh_dim_names.index(pipe_axis)
    default = tuple(Shard(0) if d == pipe_dim else Replicate() for d in range(mesh.ndim))
    leaves, spec = pytree.tree_flatten(stage_params)
    specs = ([default] * len(leaves) if param_specs is None
             else pytree.tree_flatten(param_specs, is_leaf=_is_placements)[0])
    if len(specs) != len(leaves):
        raise ValueError("param_specs needs one placement tuple per stage_params leaf")
    out = []
    for leaf, placements in zip(leaves, specs):
        placements = tuple(placements)
        if len(placements) != mesh.ndim or placements[pipe_dim] != Shard(0):
            raise ValueError(f"a stage parameter's placements {placements} must shard its "
                             f"leading stage dim over {pipe_axis!r} (one per mesh dim)")
        if isinstance(leaf, DTensor) and tuple(leaf.placements) != placements:
            raise ValueError(f"a DTensor stage parameter has placements {leaf.placements}, "
                             f"not {placements}")
        local = _local(leaf)
        if local.shape[0] != 1:
            raise ValueError(f"this rank's slice of a stage parameter has {local.shape[0]} "
                             "stages, not 1")
        groups = [mesh.get_group(name) for d, name in enumerate(mesh.mesh_dim_names)
                  if placements[d] == Replicate() and mesh.size(d) > 1 and name in data_axes]
        if groups:
            local = _SumGradOver.apply(local, groups)
        out.append(local[0])
    return pytree.tree_unflatten(out, spec)


def _pipeline_ticks(stage_fn, params_slice, xs_local, *, mesh, pipe_axis, emit):
    """Shared tick loop: stream the microbatches through the stage ring,
    calling ``emit(y, t)`` on each tick's local stage output; returns the
    emitted values in tick order."""
    n_stages = _axis_size(mesh, pipe_axis)
    n_micro = xs_local.shape[0]
    stage = mesh.get_local_rank(pipe_axis)
    ticks = n_micro + n_stages - 1
    if n_stages > 1:
        group = mesh.get_group(pipe_axis)
        nxt, prv = _peer(mesh, pipe_axis, 1), _peer(mesh, pipe_axis, -1)
    first = torch.full((), stage == 0, device=xs_local.device)
    buf = torch.zeros_like(xs_local[0])
    emitted = []
    for t in range(ticks):
        # stage 0 ingests microbatch t (clamped in the drain phase); later
        # stages consume what the previous stage sent last tick
        x_in = torch.where(first, xs_local[min(t, n_micro - 1)], buf)
        y = stage_fn(params_slice, x_in)
        if t + 1 < ticks:
            buf = y if n_stages == 1 else _PPermute.apply(y, group, nxt, prv)
        emitted.append(emit(y, t))
    return emitted


def _remat(stage_fn, remat: bool):
    if not remat:
        return stage_fn
    return lambda p, x: checkpoint(stage_fn, p, x, use_reentrant=False)


def pipeline_apply(
    stage_params,
    xs: torch.Tensor,
    stage_fn,
    *,
    mesh: DeviceMesh,
    pipe_axis: str = "pipe",
    data_spec=(),
    remat: bool = True,
    param_specs=None,
):
    """Run ``stage_fn`` as an ``n_stages``-deep pipeline over microbatches.

    Args:
        stage_params: tree whose leaves have a LEADING stage dim: ``DTensor``\\ s
            of global shape ``(n_stages, ...)`` sharded over ``pipe_axis``, or
            this rank's slice ``(1, ...)`` as a plain tensor.
        xs: ``(n_micro, micro_batch, ...)`` microbatched input, the same on
            every stage (a ``DTensor`` or this rank's local shard); sharded
            over the data axes that ``data_spec`` names, applied to the
            trailing dims (``("data",)``: ``micro_batch`` over ``data``).
        stage_fn: ``stage_fn(params_slice, x) -> y`` with ``y.shape == x.shape``.
        remat: run each stage application under ``torch.utils.checkpoint``.
        param_specs: optional tree of placement tuples (one placement per mesh
            dim) matching ``stage_params``, for tensor-parallel stages: each
            keeps ``Shard(0)`` on ``pipe_axis`` and may shard other dims over
            further axes; ``stage_fn`` then sees per-rank shards and owns the
            matching collectives (``_collectives.psum`` and
            ``_collectives.sum_grad_over``; a leaf's gradient is summed over
            the data axes only). Default: ``Shard(0)`` on ``pipe_axis``,
            ``Replicate()`` elsewhere.

    Returns:
        ``(n_micro, micro_batch_local, ...)``: the final stage's outputs on
        the last stage's ranks, and zeros on the others (their part of JAX's
        pipe-sharded output). No collective crosses the stages for it.
    """
    n_stages = _axis_size(mesh, pipe_axis)
    last = torch.full((), mesh.get_local_rank(pipe_axis) == n_stages - 1,
                        device=_local(xs).device)
    params_slice = _stage_slices(stage_params, mesh, pipe_axis, param_specs,
                                 _data_axis_names(data_spec))

    def emit(y, t):
        # only the final stage's outputs are real; other stages fill their
        # part with zeros that nobody reads
        return torch.where(last, y, torch.zeros_like(y))

    outs = _pipeline_ticks(_remat(stage_fn, remat), params_slice, _local(xs), mesh=mesh,
                           pipe_axis=pipe_axis, emit=emit)
    # the last stage emitted microbatch i at tick (n_stages - 1) + i
    return torch.stack(outs[n_stages - 1:])


def pipeline_loss(
    stage_params,
    xs: torch.Tensor,
    targets,
    stage_fn,
    loss_fn,
    *,
    mesh: DeviceMesh,
    pipe_axis: str = "pipe",
    data_spec=(),
    remat: bool = True,
    param_specs=None,
):
    """Pipelined forward and per-microbatch loss, fused into the tick loop;
    ``backward()`` of the result is the GPipe training schedule.

    Args:
        targets: tree of ``(n_micro, micro_batch, ...)`` tensors aligned with
            ``xs``'s microbatch dim (sharded like ``xs``).
        loss_fn: ``loss_fn(y, target_slice) -> scalar`` mean loss over the
            (local shard of the) microbatch. It also runs on zeroed
            activations in bubble ticks (masked out of the result), so keep
            it finite at zero inputs.
        The rest as :func:`pipeline_apply`.

    Returns:
        The scalar mean loss over all microbatches and over the data axes in
        ``data_spec``, the same on every rank.
    """
    n_stages = _axis_size(mesh, pipe_axis)
    xs_local = _local(xs)
    n_micro = xs_local.shape[0]
    tgt_local = pytree.tree_map(_local, targets)
    is_last = mesh.get_local_rank(pipe_axis) == n_stages - 1
    params_slice = _stage_slices(stage_params, mesh, pipe_axis, param_specs,
                                 _data_axis_names(data_spec))

    def emit(y, t):
        # tick t >= n_stages-1 completes microbatch t - (n_stages-1)
        i = min(max(t - (n_stages - 1), 0), n_micro - 1)
        valid = torch.full((), t >= n_stages - 1 and is_last, device=y.device)
        # double where: zero the activation on invalid ticks BEFORE the loss
        # so bubble-tick garbage cannot poison the gradients through NaN * 0
        y_safe = torch.where(valid, y, torch.zeros_like(y))
        loss = loss_fn(y_safe, pytree.tree_map(lambda a: a[i], tgt_local))
        return torch.where(valid, loss, torch.zeros_like(loss))

    per_tick = _pipeline_ticks(_remat(stage_fn, remat), params_slice, xs_local, mesh=mesh,
                               pipe_axis=pipe_axis, emit=emit)
    total = torch.stack(per_tick).sum() / n_micro
    # a scalar per collective: the sum pulls the loss off the final stage,
    # the mean averages the per-data-shard means
    total = _psum(total, mesh, pipe_axis)
    data_axes = _data_axis_names(data_spec)
    if data_axes:
        for axis in data_axes:
            total = _psum(total, mesh, axis)
        total = total / math.prod(_axis_size(mesh, a) for a in data_axes)
    return total
