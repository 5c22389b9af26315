"""Mesh construction and batch sharding helpers (port of
``accvlab_tpu/parallel/mesh.py``).

JAX drives many devices from one process; torch runs one process (rank) per
device. The port keeps JAX's multi-host contract on the torch idiom:

* a mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` over ranks;
* each rank runs its own input pipeline on its shard of the input, keyed by
  :func:`host_shard_info`, and its batch is the process-local batch, as
  ``jax.make_array_from_process_local_data`` takes it;
* the global batch is a ``DTensor`` that is ``Shard(0)`` over the ``data``
  axis (:func:`shard_batch`).

Multi-rank callers initialise the process group themselves (``torchrun``, or
``torch.distributed.init_process_group`` with an explicit store), as JAX
callers call ``jax.distributed.initialize``. With no group, :func:`make_mesh`
makes a group of one rank on an in-memory store, the counterpart of
``jax.devices()`` in a single process.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..hostcopy.async_copy import canonical


def _device_type(device_type: Optional[str]) -> str:
    """``"cuda"`` by default (raises without a card) or ``"cpu"`` (gloo)."""
    kind = "cuda" if device_type is None else str(device_type)
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device_type='cpu' for a mesh "
                           "of CPU ranks over gloo")
    return kind


def _ensure_group(device_type: str) -> None:
    """A process group of one rank (NCCL on the card, gloo on the CPU) on an
    in-memory store, unless the caller initialised one; reads no
    environment variable. On the card the rank keeps its current device
    (selected before the mesh, so that ``DeviceMesh`` does not guess one)."""
    if device_type == "cuda":
        torch.cuda.set_device(torch.cuda.current_device())
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def _ranks(devices: Optional[Sequence]) -> list:
    return list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]


def make_mesh(
    data_parallel: Optional[int] = None,
    model_parallel: int = 1,
    devices: Optional[Sequence] = None,
    axis_names: Tuple[str, str] = ("data", "model"),
    *,
    device_type: Optional[str] = None,
) -> DeviceMesh:
    """Build a 2-D (data, model) mesh over ranks.

    Args:
        data_parallel: size of the data axis; defaults to
            ``num_ranks // model_parallel``.
        model_parallel: size of the model axis.
        devices: ranks to use (default: the whole world), row-major.
        device_type: ``"cuda"`` (the default; raises without a card) or
            ``"cpu"`` (gloo).

    Every rank of the group calls this with the same arguments.
    """
    kind = _device_type(device_type)
    _ensure_group(kind)
    ranks = _ranks(devices)
    n = len(ranks)
    if data_parallel is None:
        assert n % model_parallel == 0, (
            f"{n} devices not divisible by model_parallel={model_parallel}"
        )
        data_parallel = n // model_parallel
    assert data_parallel * model_parallel == n, (
        f"mesh {data_parallel}x{model_parallel} != {n} devices"
    )
    return DeviceMesh(kind, torch.tensor(ranks).reshape(data_parallel, model_parallel),
                      mesh_dim_names=tuple(axis_names))


def make_mesh_nd(
    shape: Sequence[int],
    axis_names: Sequence[str],
    devices: Optional[Sequence] = None,
    *,
    device_type: Optional[str] = None,
) -> DeviceMesh:
    """Build an N-D mesh (e.g. ``(dp, sp, tp)`` with axis names
    ``("data", "seq", "model")``) over ranks in row-major order.

    JAX orders the devices by the physical ICI topology
    (``mesh_utils.create_device_mesh``); ranks here carry no topology, so the
    order is the ranks' own.
    """
    kind = _device_type(device_type)
    _ensure_group(kind)
    shape = tuple(int(s) for s in shape)
    assert len(shape) == len(axis_names), "one axis name per mesh dimension"
    ranks = _ranks(devices)
    n = int(np.prod(shape))
    assert n == len(ranks), f"mesh {shape} needs {n} devices, have {len(ranks)}"
    return DeviceMesh(kind, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def host_shard_info(mesh: Optional[DeviceMesh] = None) -> Tuple[int, int]:
    """(shard_id, num_shards) for this rank's input pipeline: ``(rank,
    world_size)``, or ``(0, 1)`` with no process group. Feed these to
    ``ShuffledShardedInputCallable`` (the reference's rank/world_size).

    JAX returns ``(process_index, process_count)``, and one process holds
    every device of its hosts. Here each device is its own process, so on a
    mesh whose ``model`` axis spans ranks the ranks of one ``data``
    coordinate must read the same shard: key their input by
    :func:`data_shard_info`, not by this pair.
    """
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def data_shard_info(mesh: DeviceMesh, data_axis: str = "data") -> Tuple[int, int]:
    """(shard_id, num_shards) of this rank's input on ``mesh``: its
    coordinate on ``data_axis`` and that axis' size. The ranks of one
    ``data`` coordinate read the same shard, so the batch that
    :func:`shard_batch` declares replicated over the other axes is."""
    return mesh.get_local_rank(data_axis), mesh.size(mesh.mesh_dim_names.index(data_axis))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The torch device of this rank on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_like_batch(mesh: DeviceMesh, ndim: int, data_axis: str = "data") -> tuple:
    """The ``DTensor`` placements of a rank-``ndim`` tensor sharded on its
    leading dim over ``data_axis`` (one placement per mesh dim)."""
    if ndim < 1:
        raise ValueError("a batch leaf needs a leading batch dim (ndim >= 1)")
    return tuple(Shard(0) if name == data_axis else Replicate()
                 for name in mesh.mesh_dim_names)


def shard_batch(batch, mesh: DeviceMesh, data_axis: str = "data"):
    """Wrap a (tree of) process-local batch tensor(s) as ``DTensor``\\ s on
    the mesh, sharded along the leading (batch) dim over ``data_axis``.

    Each leaf is this rank's shard (a numpy leaf goes to the mesh's device
    first, 64-bit leaves as 32-bit, as JAX places them); the global batch is
    the data axis' shards in order. No collective runs: the global shape and
    stride are given, not checked.
    """
    dev = mesh_device(mesh)
    n_data = mesh.size(mesh.mesh_dim_names.index(data_axis))

    def put(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(canonical(np.ascontiguousarray(x)))
        local = x.to(dev)
        placements = shard_like_batch(mesh, local.ndim, data_axis)
        shape = (local.shape[0] * n_data,) + tuple(local.shape[1:])
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local, mesh, placements, run_check=False, shape=shape,
                                  stride=stride)

    return pytree.tree_map(put, batch)


def make_fsdp_shardings(params, mesh: DeviceMesh, *, axis: str = "data",
                        min_size: int = 2**16):
    """ZeRO-3/FSDP-style parameter placements: each large leaf is sharded
    over ``axis`` along its largest evenly divisible dimension (the lowest
    such dimension among equals); small leaves replicate.

    Returns a tree of placement tuples (one placement per mesh dim) of
    ``params``' structure; apply it with
    ``torch.distributed.tensor.distribute_tensor(leaf, mesh, placements)``.
    The rule is JAX's (``accvlab_tpu/parallel/mesh.py:99-137``).
    """
    dim = mesh.mesh_dim_names.index(axis)
    n = mesh.size(dim)

    def spec(leaf) -> tuple:
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
        placements = [Replicate()] * mesh.ndim
        if int(np.prod(shape, dtype=np.int64)) >= int(min_size):
            # largest divisible dim -> most even byte split per device
            for d in sorted(range(len(shape)), key=lambda i: -shape[i]):
                if shape[d] % n == 0:
                    placements[dim] = Shard(d)
                    break
        return tuple(placements)

    return pytree.tree_map(spec, params)
