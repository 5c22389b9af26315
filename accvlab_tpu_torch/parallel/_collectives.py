"""The collectives of the port's mesh code, with GSPMD's transposes.

A value that every rank of a mesh axis holds alike (replicated) has one
cotangent, which every rank holds alike too. GSPMD transposes its
collectives with that in mind, and so do these ``torch.autograd.Function``\\ s:

* :func:`psum`: the sum over an axis of each rank's part; the cotangent of
  the one replicated sum passes through to every part.
* :func:`all_gather`: the concatenation of the ranks' slices along a dim;
  the backward takes the rank's own slice of the (replicated) cotangent.
* :func:`sum_grad_over`: the identity, whose gradient is summed over the
  axes: a replicated value that enters a computation split over those axes
  (each rank sees only its part of the cotangent).

``torch.distributed.nn.functional.all_reduce`` and ``all_gather`` sum the
cotangents over the ranks instead, which multiplies every gradient behind
them by the axis size. An axis of one rank calls no collective.

:func:`local_shard` and :func:`from_full` place a full tensor on a mesh
without communication: every rank slices its own shard by its index in
each axis' process group.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


class _SumOfReplicas(torch.autograd.Function):
    """``lax.psum`` of a value every rank then holds: the sum over
    ``group``; the cotangent of the one replicated result passes through."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumGradOver(torch.autograd.Function):
    """The identity, whose gradient is summed over ``groups``: a value
    replicated over those mesh axes (GSPMD's gradient reduction)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        for group in ctx.groups:
            dist.all_reduce(grad, group=group)
        return grad, None


class _AllGather(torch.autograd.Function):
    """The ranks' slices concatenated along ``dim``; the backward keeps the
    rank's own slice of the replicated cotangent."""

    @staticmethod
    def forward(ctx, x, group, dim: int, n: int, index: int):
        ctx.dim, ctx.n, ctx.index = dim, n, index
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.n, dim=ctx.dim)[ctx.index].contiguous(), None, None, None, None


def psum(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis``; its cotangent passes through."""
    if axis_size(mesh, axis) == 1:
        return x
    return _SumOfReplicas.apply(x, mesh.get_group(axis))


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' ``x`` along ``axis`` concatenated on ``dim`` in the axis'
    order; the backward takes this rank's slice of the cotangent."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    return _AllGather.apply(x, mesh.get_group(axis), dim % x.ndim, n, mesh.get_local_rank(axis))


def sum_grad_over(x: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str]) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over ``axes`` (those of one
    rank are skipped)."""
    groups = [mesh.get_group(a) for a in axes if axis_size(mesh, a) > 1]
    return _SumGradOver.apply(x, groups) if groups else x


def local_shard(full: torch.Tensor, mesh: DeviceMesh,
                placements: Sequence[Placement]) -> torch.Tensor:
    """This rank's shard of ``full`` under ``placements`` (one per mesh
    dim): ``Shard(d)`` splits dim ``d`` into equal parts, ``Replicate()``
    keeps it whole. No communication.

    The part is the rank's index in the axis' process group, as DTensor's
    collectives order the parts: a group orders its ranks ascending, so on
    a mesh whose axis lists ranks in another order this index differs from
    ``mesh.get_coordinate()``."""
    out = full
    for d, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(d)
            if out.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of size {out.shape[p.dim]} does not split "
                                 f"evenly over {n} ranks of {mesh.mesh_dim_names[d]!r}")
            out = out.chunk(n, dim=p.dim)[mesh.get_local_rank(d)]
        elif not isinstance(p, Replicate):
            raise ValueError(f"a full tensor cannot be placed as {p}")
    return out


def from_full(full: torch.Tensor, mesh: DeviceMesh,
              placements: Sequence[Placement]) -> DTensor:
    """``full`` as a ``DTensor`` on ``mesh``: each rank keeps its own shard
    (every rank holds the same ``full``)."""
    placements = tuple(placements)
    return DTensor.from_local(local_shard(full, mesh, placements).contiguous(), mesh,
                              placements, run_check=False, shape=full.shape,
                              stride=full.contiguous().stride())
