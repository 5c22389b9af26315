"""accvlab_tpu_torch.hostcopy — async packed multi-tensor copies between host
and card (port of ``accvlab_tpu.hostcopy``: pinned staging, one copy per
chunk, in both directions)."""

from .async_copy import AsyncCopyHandle, start_copy

__all__ = ["AsyncCopyHandle", "start_copy"]
