"""Async packed multi-tensor host->device copy (PyTorch/CUDA).

Port of ``accvlab_tpu/hostcopy/async_copy.py`` (the reference's
multi_tensor_copier). Per-transfer overhead dominates when a batch holds
many arrays, so small and medium arrays are packed into a few large
contiguous chunks:

* the tree is flattened (dict/list/tuple nesting preserved; opaque non-array
  leaves pass through; numpy scalars converted);
* packable arrays (``<= pack_candidate_max_bytes``) go into raw-byte chunks
  of ``<= max_packed_chunk_bytes`` at 16-byte aligned offsets — one chunk
  group per dtype, or ONE group for every dtype with
  ``merge_dtype_chunks=True``;
* each chunk is filled by the C++ packer (``csrc/pack.cpp``, GIL released)
  into pinned host memory and crosses with ONE ``non_blocking`` copy on a
  dedicated copy stream;
* typed views are carved with ``Tensor.view(dtype)`` (the JAX package's
  ``bitcast_convert_type``);
* completion is a CUDA event: :meth:`AsyncCopyHandle.ready` polls it and
  :meth:`AsyncCopyHandle.get` orders the caller's stream after it.

64-bit leaves become 32-bit (``canonical``), as JAX does without x64, so the
port's outputs have the JAX package's dtypes. Torch tensor leaves are moved
to ``device``. With ``device="cpu"`` the chunks are plain host tensors.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, List, Optional

import numpy as np
import torch

from .._device import resolve_device
from .native import parallel_pack

_PACK_CANDIDATE_MAX_BYTES = 256 * 1024  # reference: make_pack_candidate, :481
_DEFAULT_MAX_CHUNK = 32 * 1024 * 1024  # reference: max_packed_chunk_bytes
# packed offsets are multiples of 16 bytes, so every itemsize divides each
# view's offset (reference: :386, :510)
_ALIGN = 16

_background_pool: Optional[ThreadPoolExecutor] = None
_copy_streams: dict = {}
_lock = threading.Lock()

_CANONICAL = {
    np.dtype(np.float64): np.dtype(np.float32),
    np.dtype(np.int64): np.dtype(np.int32),
    np.dtype(np.uint64): np.dtype(np.uint32),
    np.dtype(np.complex128): np.dtype(np.complex64),
}
_TORCH_DTYPE = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.complex64): torch.complex64,
}


def canonical(arr: np.ndarray) -> np.ndarray:
    """64-bit leaves become 32-bit (JAX's default without x64)."""
    target = _CANONICAL.get(arr.dtype)
    return arr.astype(target) if target is not None else arr


def _get_background_pool() -> ThreadPoolExecutor:
    global _background_pool
    with _lock:
        if _background_pool is None:
            _background_pool = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="accvlab-hostcopy"
            )
    return _background_pool


def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    with _lock:
        s = _copy_streams.get(device.index)
        if s is None:
            s = torch.cuda.Stream(device=device)
            _copy_streams[device.index] = s
    return s


def _is_packable_array(x) -> bool:
    if isinstance(x, (str, bytes)):
        return False
    if isinstance(x, np.ndarray):
        return x.dtype.kind in "biufc"
    return isinstance(x, (int, float, bool, np.number, np.bool_))


def _flatten(data, leaves: list):
    """Flatten dict/list/tuple nesting; returns a rebuild function."""
    if isinstance(data, dict):
        keys = list(data.keys())
        subs = [_flatten(data[k], leaves) for k in keys]
        return lambda it: {k: s(it) for k, s in zip(keys, subs)}
    if isinstance(data, (list, tuple)):
        subs = [_flatten(v, leaves) for v in data]
        kind = type(data)
        return lambda it: kind(s(it) for s in subs)
    leaves.append(data)
    return lambda it: next(it)


class AsyncCopyHandle:
    """Handle for an in-flight copy (parity: ``async_copy.py:172``)."""

    def __init__(self, future: Future):
        self._future = future

    def ready(self) -> bool:
        """Non-blocking: host packing done and the copy event reached."""
        if not self._future.done():
            return False
        _, event, _ = self._future.result()
        return event is None or event.query()

    def get(self) -> Any:
        """The copied structure (same nesting as the input; array leaves are
        tensors on the target device). Waits for the host-side packing; the
        device copy is ordered before later work on the caller's current
        stream (no host synchronisation)."""
        result, event, chunks = self._future.result()
        if event is not None:
            stream = torch.cuda.current_stream(chunks[0].device)
            stream.wait_event(event)
            for c in chunks:
                c.record_stream(stream)
        return result


def _plan_and_copy(
    leaves: List[Any],
    device: torch.device,
    max_packed_chunk_bytes: int,
    pack_candidate_max_bytes: Optional[int],
    merge_dtype_chunks: bool,
):
    pmax = (
        _PACK_CANDIDATE_MAX_BYTES if pack_candidate_max_bytes is None else pack_candidate_max_bytes
    )
    cuda = device.type == "cuda"
    out: List[Any] = [None] * len(leaves)
    groups: dict = {}  # dtype (or "" for the merged byte group) -> [(idx, arr)]
    stream = _copy_stream(device) if cuda else None
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            out[i] = leaf.to(device, non_blocking=True)
            continue
        if not _is_packable_array(leaf):
            out[i] = leaf  # opaque pass-through (reference: :120-138)
            continue
        arr = canonical(np.asarray(leaf))
        if not arr.flags["C_CONTIGUOUS"]:  # (ascontiguousarray would make 0-d 1-d)
            arr = np.ascontiguousarray(arr)
        if arr.nbytes == 0:
            out[i] = torch.zeros(arr.shape, dtype=_TORCH_DTYPE[arr.dtype], device=device)
        elif arr.nbytes <= pmax:
            groups.setdefault("" if merge_dtype_chunks else arr.dtype, []).append((i, arr))
        else:
            out[i] = torch.from_numpy(arr).to(device)

    dev_chunks = []

    def flush(chunk):
        offsets, pos = [], 0
        for _, arr in chunk:
            offsets.append(pos)
            pos += -(-arr.nbytes // _ALIGN) * _ALIGN
        staging = torch.empty((pos,), dtype=torch.uint8, pin_memory=cuda)
        parallel_pack([a for _, a in chunk], offsets, staging.data_ptr())
        if cuda:
            with torch.cuda.stream(stream):
                dev = staging.to(device, non_blocking=True)
            dev_chunks.append(dev)
        else:
            dev = staging
        for (leaf_i, arr), off in zip(chunk, offsets):
            raw = dev[off:off + arr.nbytes]
            out[leaf_i] = raw.view(_TORCH_DTYPE[arr.dtype]).reshape(arr.shape)

    for items in groups.values():
        chunk: List = []
        chunk_bytes = 0
        for leaf_i, arr in items:
            n_aligned = -(-arr.nbytes // _ALIGN) * _ALIGN
            if chunk and chunk_bytes + n_aligned > max_packed_chunk_bytes:
                flush(chunk)
                chunk, chunk_bytes = [], 0
            chunk.append((leaf_i, arr))
            chunk_bytes += n_aligned
        if chunk:
            flush(chunk)

    event = None
    if cuda and dev_chunks:
        event = torch.cuda.Event()
        event.record(stream)
    return out, event, dev_chunks


def start_copy(
    data: Any,
    device=None,
    max_packed_chunk_bytes: int = _DEFAULT_MAX_CHUNK,
    use_background_thread: bool = True,
    pack_candidate_max_bytes: Optional[int] = None,
    merge_dtype_chunks: bool = False,
) -> AsyncCopyHandle:
    """Start an asynchronous packed copy of a nested structure to ``device``
    (default: the CUDA device; ``device="cpu"`` builds host tensors).

    Parity: ``accvlab_tpu.hostcopy.start_copy``. Staging is pinned for a
    CUDA target. Returns an :class:`AsyncCopyHandle` with ``ready()`` /
    ``get()``.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    leaves: list = []
    rebuild = _flatten(data, leaves)

    def run():
        out, event, chunks = _plan_and_copy(
            leaves, dev, max_packed_chunk_bytes, pack_candidate_max_bytes, merge_dtype_chunks,
        )
        return rebuild(iter(out)), event, chunks

    if use_background_thread:
        future = _get_background_pool().submit(run)
    else:
        future: Future = Future()
        try:
            future.set_result(run())
        except Exception as e:
            future.set_exception(e)
    return AsyncCopyHandle(future)
