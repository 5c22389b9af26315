"""Shared helpers for processing steps."""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

Name = Union[str, int]


def as_name_list(names: Union[Name, Sequence[Name], None]):
    if names is None:
        return None
    if isinstance(names, (str, int)):
        return [names]
    return list(names)


def batch_tensor(value, device) -> torch.Tensor:
    """A device step's per-batch draw or constant as a tensor on ``device``
    (scripted draws arrive as numpy values)."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.as_tensor(np.asarray(value), device=device)
