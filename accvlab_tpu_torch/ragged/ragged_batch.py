"""Minimal ``RaggedBatch``: the padded tensor plus per-sample sizes.

PyTorch counterpart of the part of ``accvlab_tpu/ragged/ragged_batch.py``
that ``heatmap.draw_heatmap_batched`` takes: ``tensor``, ``sample_sizes``
and ``mask``, with the non-uniform dimension fixed at 1 (``(batch,
max_size, ...)``). The rest of the ragged API is later work (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _as_tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


class RaggedBatch:
    """A batch of variable-size samples stored padded to the batch maximum.

    Args:
        tensor: ``(batch, max_size, ...)`` padded data.
        mask: optional ``(batch, max_size)`` bool; ``True`` marks live entries.
        sample_sizes: optional ``(batch,)`` int live-entry counts.

    At least one of ``mask`` and ``sample_sizes`` is needed; the other is
    derived (live entries are the leading ``sample_sizes[b]`` of each row).
    """

    def __init__(
        self,
        tensor,
        mask: Optional[object] = None,
        sample_sizes: Optional[object] = None,
    ):
        assert mask is not None or sample_sizes is not None, (
            "At least one of `mask` or `sample_sizes` needs to be set"
        )
        self._tensor = _as_tensor(tensor)
        device = self._tensor.device
        if sample_sizes is None:
            sample_sizes = _as_tensor(mask, device).to(torch.bool).sum(dim=1)
        self._sample_sizes = _as_tensor(sample_sizes, device).to(torch.int32)
        self._mask = None if mask is None else _as_tensor(mask, device).to(torch.bool)
        assert self._tensor.shape[0] == self._sample_sizes.shape[0], (
            "tensor and sample_sizes must have the same batch size"
        )

    @property
    def tensor(self) -> torch.Tensor:
        return self._tensor

    @property
    def sample_sizes(self) -> torch.Tensor:
        return self._sample_sizes

    @property
    def mask(self) -> torch.Tensor:
        if self._mask is None:
            pos = torch.arange(self._tensor.shape[1], device=self._tensor.device)
            self._mask = pos[None, :] < self._sample_sizes[:, None]
        return self._mask

    @property
    def batch_size(self) -> int:
        return int(self._tensor.shape[0])

    @property
    def max_size(self) -> int:
        return int(self._tensor.shape[1])

    @property
    def device(self) -> torch.device:
        return self._tensor.device

    def to(self, device) -> "RaggedBatch":
        return RaggedBatch(self._tensor.to(device), sample_sizes=self._sample_sizes.to(device))
