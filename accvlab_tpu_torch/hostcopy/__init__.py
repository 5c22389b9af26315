"""accvlab_tpu_torch.hostcopy — async packed multi-tensor host->device copy
(port of ``accvlab_tpu.hostcopy``: pinned staging, one copy per chunk)."""

from .async_copy import AsyncCopyHandle, start_copy

__all__ = ["AsyncCopyHandle", "start_copy"]
