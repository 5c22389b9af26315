"""accvlab_tpu_torch.parallel — meshes, batch sharding and pipeline
parallelism over ``torch.distributed`` (port of ``accvlab_tpu.parallel``).

* :func:`make_mesh` / :func:`make_mesh_nd` — a
  ``torch.distributed.device_mesh.DeviceMesh`` over (data, model) axes, or
  any N-D layout, one rank per device (NCCL on the card, gloo on the CPU).
* :func:`shard_batch` — wrap a rank's process-local batch as ``DTensor``\\ s
  sharded over the data axis (the global batch).
* :func:`host_shard_info` — the (shard_id, num_shards) pair to feed
  :class:`~accvlab_tpu_torch.pipeline.inputs.ShuffledShardedInputCallable`.
* :func:`make_fsdp_shardings` — ZeRO-3/FSDP-style parameter placements over
  the data axis, by JAX's rule.
* :func:`pipeline_apply` / :func:`pipeline_loss` — the GPipe tick loop over a
  ``pipe`` axis, with gradients.
"""

from .mesh import (
    host_shard_info,
    make_fsdp_shardings,
    make_mesh,
    make_mesh_nd,
    shard_batch,
    shard_like_batch,
)
from .pipeline_parallel import pipeline_apply, pipeline_loss

__all__ = [
    "host_shard_info",
    "make_fsdp_shardings",
    "make_mesh",
    "make_mesh_nd",
    "pipeline_apply",
    "pipeline_loss",
    "shard_batch",
    "shard_like_batch",
]
