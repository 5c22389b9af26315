"""Device selection shared by every entry point of the port.

Entry points default to the CUDA device and raise when no card is present;
only an explicit ``device="cpu"`` (or a tensor that already lies on the CPU)
selects the CPU. Nothing falls back from the card to the CPU quietly.
"""

from __future__ import annotations

import threading
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
    package's ``Precision.HIGHEST``: the executor's device stage, the DCT
    wire's decode and loaded serving programs run under it.

    The settings are process-global, and scopes may be open on several
    threads at once (a pipeline's consumer thread and a serving thread).
    The scopes are therefore counted: the first to open saves the caller's
    settings and sets full precision, the last to close restores them, so
    no thread's scope is cut short by another's exit. Between the two, a
    thread outside every scope also computes in full precision.
    """

    _lock = threading.Lock()
    _depth = 0
    _saved = None

    def __enter__(self):
        cls = F32MatmulScope
        with cls._lock:
            if cls._depth == 0:
                cls._saved = (torch.backends.cuda.matmul.allow_tf32,
                              torch.get_float32_matmul_precision())
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.set_float32_matmul_precision("highest")
            cls._depth += 1

    def __exit__(self, *exc):
        cls = F32MatmulScope
        with cls._lock:
            cls._depth -= 1
            if cls._depth == 0:
                torch.backends.cuda.matmul.allow_tf32, prec = cls._saved
                torch.set_float32_matmul_precision(prec)
