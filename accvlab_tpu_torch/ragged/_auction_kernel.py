"""ctypes binding of the CUDA auction ``csrc/auction_matching.cu``.

The library is built with ``nvcc`` at first use (``_native_build``) and never
when this module is imported, so the CPU tests import it freely. Each launch
adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import torch

from .._native_build import build_cuda_lib
from ..tools import launch_counts

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "auction_matching.cu")
# -fmad=false with the source's __fadd_rn/__fsub_rn: the bid's roundings are
# the JAX round's
NVCC_EXTRA = ["-fmad=false"]

#: kernel launches (successful, non-empty batches)
LAUNCHES = launch_counts.register({"batched_auction_matching": 0})

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library_path() -> str:
    """Build (if needed) and return the path of the kernel library."""
    return build_cuda_lib(SRC, "libaccvlab_auction", NVCC_EXTRA)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(library_path())
                lib.accvlab_auction.restype = _I
                lib.accvlab_auction.argtypes = [_P] * 6 + [_I] * 5 + [_P]
                lib.accvlab_auction_smem_bytes.restype = ctypes.c_size_t
                lib.accvlab_auction_smem_bytes.argtypes = [_I, _I, _I]
                lib.accvlab_auction_smem_limit.restype = _I
                lib.accvlab_auction_smem_limit.argtypes = []
                _LIB = lib
    return _LIB


def launch_auction(cost: torch.Tensor, num_valid: torch.Tensor, eps: torch.Tensor,
                   max_iters: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the auction of every sample of ``cost (B, R, C)`` float32 on the
    card; ``num_valid`` and ``eps`` are ``(B,)`` int32 and float32 on the
    same card. Returns ``(col_of_row (B, R) int32, rounds (B,) int32,
    bids (B,) int32)``.
    Raises ``ValueError`` on inputs the kernel does not take (type, shape,
    device, or per-column state larger than a block's shared memory)."""
    if cost.dtype != torch.float32 or cost.ndim != 3 or not cost.is_cuda:
        raise ValueError(f"cost must be a float32 (B, R, C) CUDA tensor, got {cost.dtype} "
                         f"{tuple(cost.shape)} on {cost.device}")
    b, r, c = cost.shape
    for name, x, dtype in (("num_valid", num_valid, torch.int32), ("eps", eps, torch.float32)):
        if x.dtype != dtype or tuple(x.shape) != (b,) or x.device != cost.device \
                or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {dtype} tensor of shape ({b},) on "
                             f"{cost.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    cost = cost.contiguous()
    cols = torch.empty((b, r), dtype=torch.int32, device=cost.device)
    rounds = torch.empty((b,), dtype=torch.int32, device=cost.device)
    bids = torch.empty((b,), dtype=torch.int32, device=cost.device)
    if b == 0:
        return cols, rounds, bids
    lib = _lib()
    with torch.cuda.device(cost.device):
        limit = lib.accvlab_auction_smem_limit()
        in_smem = int(lib.accvlab_auction_smem_bytes(r, c, 1) <= limit)
        if lib.accvlab_auction_smem_bytes(r, c, in_smem) > limit:
            raise ValueError(f"the auction kernel keeps 8 bytes per column and 24 per row in "
                             f"shared memory: ({r}, {c}) exceeds the block's {limit} bytes")
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        err = lib.accvlab_auction(_P(cost.data_ptr()), _P(num_valid.data_ptr()),
                                  _P(eps.data_ptr()), _P(cols.data_ptr()),
                                  _P(rounds.data_ptr()), _P(bids.data_ptr()), b, r, c,
                                  int(max_iters), in_smem, _P(stream))
    if err != 0:
        raise RuntimeError(f"auction kernel launch failed: CUDA error {err}")
    LAUNCHES["batched_auction_matching"] += 1
    return cols, rounds, bids
