"""Device selection shared by every entry point of the port.

Entry points default to the CUDA device and raise when no card is present;
only an explicit ``device="cpu"`` (or a tensor that already lies on the CPU)
selects the CPU. Nothing falls back from the card to the CPU quietly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA device.

    Raises ``RuntimeError`` for a CUDA device when no card is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


IMPLEMENTATIONS = ("auto", "kernel", "torch")


def use_kernel(implementation: str, device: torch.device) -> bool:
    """Whether a wrapper with a hand kernel launches it on tensors of
    ``device``: ``"auto"`` for CUDA tensors, ``"kernel"`` always (a CPU
    tensor raises ``ValueError``), ``"torch"`` never."""
    if implementation not in IMPLEMENTATIONS:
        raise ValueError(
            f"implementation must be one of {IMPLEMENTATIONS}, got {implementation!r}"
        )
    if implementation == "torch":
        return False
    if device.type == "cuda":
        return True
    if implementation == "kernel":
        raise ValueError("implementation='kernel' needs CUDA tensors (the kernel has no CPU form)")
    return False


def device_of(value, device: DeviceLike = None) -> torch.device:
    """The device a call runs on: that of ``value`` when it is a tensor,
    else :func:`resolve_device` of ``device``."""
    if isinstance(value, torch.Tensor):
        if device is not None and torch.device(device).type != value.device.type:
            raise ValueError(
                f"tensor lies on {value.device} but device={device!r} was requested"
            )
        return value.device
    return resolve_device(device)


class F32MatmulScope:
    """Float32 matrix products in full precision (TF32 off), as the JAX
    package's ``Precision.HIGHEST``: the executor's device stage and the DCT
    wire's decode run under it. The caller's settings are restored
    afterwards."""

    def __enter__(self):
        self._tf32 = torch.backends.cuda.matmul.allow_tf32
        self._prec = torch.get_float32_matmul_precision()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self._tf32
        torch.set_float32_matmul_precision(self._prec)
