"""Async packed multi-tensor copy between host and card (PyTorch/CUDA).

Port of ``accvlab_tpu/hostcopy/async_copy.py`` (the reference's
multi_tensor_copier). Per-transfer overhead dominates when a batch holds
many arrays, so small and medium arrays are packed into a few large
contiguous chunks:

* the tree is flattened (dict/list/tuple nesting preserved; opaque non-array
  leaves pass through; numpy scalars converted);
* packable arrays (``<= pack_candidate_max_bytes``) go into chunks of
  ``<= max_packed_chunk_bytes`` at aligned offsets (16 bytes by default),
  as the JAX package plans them: one chunk group per dtype, or with
  ``merge_dtype_chunks=True`` ONE raw-byte group for every integer and
  float dtype (bool and complex keep their own);
* each chunk is filled by the C++ packer (``csrc/pack.cpp``, GIL released)
  into pinned host memory and crosses with ONE ``non_blocking`` copy on a
  dedicated copy stream;
* typed views are carved with ``Tensor.view(dtype)`` (the JAX package's
  ``bitcast_convert_type``);
* completion is a CUDA event: :meth:`AsyncCopyHandle.ready` polls it and
  :meth:`AsyncCopyHandle.get` orders the caller's stream after it.

64-bit leaves become 32-bit (``canonical``), as JAX does without x64, so the
port's outputs have the JAX package's dtypes. Torch tensor leaves are moved
to ``device`` on the copy stream, after the work the caller's stream had
queued when the copy started, and under the event that ``get()`` orders the
caller's stream after. With ``device="cpu"`` and no CUDA leaf the chunks are
plain host tensors (the CPU stands in for the card).

Device to host (``device="cpu"`` with CUDA tensor leaves; the JAX package's
``_plan_and_copy_d2h``): CUDA leaves of ``0 < nbytes <= 256 KB`` are grouped
per (dtype, device), laid out on the card at aligned element offsets in
chunks of at most ``max_packed_chunk_bytes`` (``_layout_d2h``: flatten, zero
padding, ``torch.cat``), and each chunk crosses with ONE copy into pinned
host memory; a group or chunk of one leaf, a larger leaf, and every leaf
under ``pack_cpu_tensors=False`` cross alone. The layout and the copies run
on the source device's copy stream after the caller's stream, under one
event per device: ``ready()`` polls it and ``get()`` waits for it on the
host, since the caller asked for host data. The leaves come back as CPU
tensors (views of their chunk) in their own dtypes, where JAX returns numpy
arrays; host leaves (numpy arrays, scalars, CPU tensors, opaque values)
pass through unchanged.
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, List, Optional

import numpy as np
import torch

from .._device import resolve_device
from .native import parallel_pack

_PACK_CANDIDATE_MAX_BYTES = 256 * 1024  # reference: make_pack_candidate, :481
_DEFAULT_MAX_CHUNK = 32 * 1024 * 1024  # reference: max_packed_chunk_bytes
# packed offsets are multiples of 16 bytes by default, so every itemsize
# divides each view's offset (reference: :386, :510)
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


def _is_cuda_tensor(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_cuda


def _is_packable_array(x) -> bool:
    if isinstance(x, (str, bytes)):
        return False
    if isinstance(x, np.ndarray):
        return x.dtype.kind in "biufc"
    return isinstance(x, (int, float, bool, np.number, np.bool_))


def _flatten(data, leaves: list):
    """Flatten dict/list/tuple nesting, dict keys in sorted order as
    ``jax.tree_util`` does (the packing order); returns a rebuild function,
    which keeps each dict's own key order."""
    if isinstance(data, dict):
        keys = sorted(data.keys())
        subs = [_flatten(data[k], leaves) for k in keys]
        order = list(data.keys())

        def rebuild(it):
            values = {k: s(it) for k, s in zip(keys, subs)}
            return {k: values[k] for k in order}

        return rebuild
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
        """Non-blocking: host packing done and every copy event reached."""
        if not self._future.done():
            return False
        _, events, _, _ = self._future.result()
        return all(e.query() for e in events)

    def get(self) -> Any:
        """The copied structure (same nesting as the input; array leaves are
        tensors on the target device). Waits for the host-side packing. A
        copy to the card is ordered before later work on the caller's
        current stream (no host synchronisation); a copy from the card to
        the host is waited for, so the host tensors hold their data."""
        result, events, written, to_host = self._future.result()
        for event in events:
            if to_host:
                event.synchronize()
                continue
            stream = torch.cuda.current_stream(written[0].device)
            stream.wait_event(event)
            for t in written:
                t.record_stream(stream)
        return result


def _caller_events(leaves: List[Any]) -> dict:
    """An event on the caller's current stream of every CUDA device that a
    tensor leaf lies on, recorded before the copy starts: the copy stream
    waits for it before it reads those leaves."""
    events = {}
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda and leaf.device.index not in events:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(leaf.device))
            events[leaf.device.index] = event
    return events


def _plan(
    leaves: List[Any],
    pack_cpu_tensors: bool,
    min_packed_alignment_bytes: int,
    max_packed_chunk_bytes: int,
    pack_candidate_max_bytes: Optional[int],
    merge_dtype_chunks: bool,
):
    """The JAX package's packing plan (``async_copy.py:334-445``).

    Returns ``(kinds, chunks)``: per leaf ``("tensor" | "opaque" | "zeros" |
    "single" | "packed", array)``, and the chunks in the order JAX fills
    them: the merged raw-byte chunks first (``dtype`` None), then one group
    of chunks per dtype, each ``(dtype, [(leaf_index, array, byte_offset)],
    total_bytes)``.
    """
    pmax = (
        _PACK_CANDIDATE_MAX_BYTES if pack_candidate_max_bytes is None else pack_candidate_max_bytes
    )
    kinds: List[Any] = []
    groups: dict = {}  # dtype (or "" for the merged byte group) -> [(idx, arr)]
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            kinds.append(("tensor", leaf))
            continue
        if not _is_packable_array(leaf):
            kinds.append(("opaque", leaf))  # pass-through (reference: :120-138)
            continue
        arr = canonical(np.asarray(leaf))
        if not arr.flags["C_CONTIGUOUS"]:  # (ascontiguousarray would make 0-d 1-d)
            arr = np.ascontiguousarray(arr)
        if arr.nbytes == 0 and pack_cpu_tensors:
            kinds.append(("zeros", arr))
        elif pack_cpu_tensors and arr.nbytes <= pmax:
            # merged mode: every int/uint/float leaf rides the raw-byte group;
            # bool and complex keep per-dtype chunks, as in JAX
            key = "" if merge_dtype_chunks and arr.dtype.kind in "iuf" else arr.dtype
            groups.setdefault(key, []).append((i, arr))
            kinds.append(("packed", arr))
        else:
            kinds.append(("single", arr))

    chunks = []
    byte_items = groups.pop("", None)
    ordered = ([(None, byte_items)] if byte_items else []) + list(groups.items())
    for dtype, items in ordered:
        # raw bytes align to the requested bytes; a dtype group aligns to
        # whole elements of at least that many bytes
        align = (max(1, min_packed_alignment_bytes) if dtype is None else
                 max(1, min_packed_alignment_bytes // dtype.itemsize) * dtype.itemsize)
        chunk: List = []
        pos = 0
        for leaf_i, arr in items:
            n_aligned = -(-arr.nbytes // align) * align
            if chunk and pos + n_aligned > max_packed_chunk_bytes:
                chunks.append((dtype, chunk, pos))
                chunk, pos = [], 0
            chunk.append((leaf_i, arr, pos))
            pos += n_aligned
        if chunk:
            chunks.append((dtype, chunk, pos))
    return kinds, chunks


def _copy(kinds: List[Any], chunks: list, device: torch.device, use_pinned_staging: bool,
          caller: dict):
    """Carry out :func:`_plan`'s plan: the leaves on ``device`` (packed
    leaves as views of their chunk), the copy stream's events and the device
    tensors that stream wrote. Torch tensor leaves are copied last, after
    the copy stream waited for the caller's ``caller`` events, so the
    chunks never wait for the caller's work."""
    cuda = device.type == "cuda"
    out: List[Any] = [None] * len(kinds)
    stream = _copy_stream(device) if cuda else None
    written = []
    with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
        for i, (kind, value) in enumerate(kinds):
            if kind == "opaque":
                out[i] = value
            elif kind == "zeros":
                out[i] = torch.zeros(value.shape, dtype=_TORCH_DTYPE[value.dtype], device=device)
            elif kind == "single":
                out[i] = torch.from_numpy(value).to(device)
            else:
                continue
            if cuda and kind != "opaque":
                written.append(out[i])

        for _, items, total in chunks:
            staging = torch.empty((total,), dtype=torch.uint8,
                                  pin_memory=cuda and use_pinned_staging)
            parallel_pack([arr for _, arr, _ in items], [off for _, _, off in items],
                          staging.data_ptr())
            # the re-aligning copies below follow the chunk's copy on the
            # copy stream, before the event that get() waits on
            dev = staging.to(device, non_blocking=True) if cuda else staging
            if cuda:
                written.append(dev)
            for leaf_i, arr, off in items:
                raw = dev[off:off + arr.nbytes]
                if off % arr.itemsize:  # an alignment below the itemsize: re-align by a copy
                    raw = raw.clone()
                    if cuda:
                        written.append(raw)
                out[leaf_i] = raw.view(_TORCH_DTYPE[arr.dtype]).reshape(arr.shape)

        if cuda:
            for event in caller.values():
                stream.wait_event(event)
        for i, (kind, value) in enumerate(kinds):
            if kind != "tensor":
                continue
            out[i] = value.to(device, non_blocking=True)
            if cuda:
                if value.is_cuda:  # read on the copy stream: keep it until the copy is done
                    value.record_stream(stream)
                written.append(out[i])

    events = []
    if written:
        event = torch.cuda.Event()
        event.record(stream)
        events.append(event)
    return out, events, written


def _plan_d2h(leaves: List[Any], is_source, pack_cpu_tensors: bool,
              min_packed_alignment_bytes: int, max_packed_chunk_bytes: int):
    """The JAX package's device-to-host plan (``_plan_and_copy_d2h``,
    ``async_copy.py:237-300``).

    ``is_source(leaf)`` picks the leaves to copy (CUDA tensors). Returns
    ``(kinds, chunks)``: per leaf ``("host", leaf)`` (passes through),
    ``("single", tensor)`` (copied alone) or ``("packed", tensor)``; the
    chunks in the order JAX fetches them, one group per (dtype, device) in
    the order of their first leaf, each ``(dtype, device, [(leaf_index,
    tensor, element_offset)], total_elements)``. Offsets are aligned to
    ``max(1, min_packed_alignment_bytes // itemsize)`` elements; a chunk is
    closed before a leaf would take it past ``max_packed_chunk_bytes``, and
    a chunk of one leaf is copied alone."""
    kinds: List[Any] = []
    groups: dict = {}  # (dtype, device) -> [(leaf_index, tensor)]
    for i, leaf in enumerate(leaves):
        if not is_source(leaf):
            kinds.append(("host", leaf))
            continue
        nbytes = leaf.numel() * leaf.element_size()
        if pack_cpu_tensors and 0 < nbytes <= _PACK_CANDIDATE_MAX_BYTES:
            groups.setdefault((leaf.dtype, leaf.device), []).append((i, leaf))
            kinds.append(("packed", leaf))
        else:
            kinds.append(("single", leaf))

    chunks = []

    def flush(dtype, device, chunk, total):
        if len(chunk) == 1:
            leaf_i, t, _ = chunk[0]
            kinds[leaf_i] = ("single", t)
        elif chunk:
            chunks.append((dtype, device, chunk, total))

    for (dtype, device), items in groups.items():
        itemsize = items[0][1].element_size()
        align_items = max(1, min_packed_alignment_bytes // itemsize)
        chunk: List = []
        pos = 0
        for leaf_i, t in items:
            n_aligned = -(-t.numel() // align_items) * align_items
            if chunk and (pos + n_aligned) * itemsize > max_packed_chunk_bytes:
                flush(dtype, device, chunk, pos)
                chunk, pos = [], 0
            chunk.append((leaf_i, t, pos))
            pos += n_aligned
        flush(dtype, device, chunk, pos)
    return kinds, chunks


def _layout_d2h(items: list, total: int) -> torch.Tensor:
    """One chunk of :func:`_plan_d2h` laid out on its leaves' device: each
    leaf flattened at its element offset, zeros up to the next offset (JAX's
    ``jnp.pad`` and ``jnp.concatenate``), ``total`` elements in all."""
    first = items[0][1]
    ends = [off for _, _, off in items[1:]] + [total]
    pads = [end - off - t.numel() for (_, t, off), end in zip(items, ends)]
    zeros = torch.zeros((max(pads),), dtype=first.dtype, device=first.device)
    pieces = []
    for (_, t, _), pad in zip(items, pads):
        pieces.append(t.reshape(-1))
        if pad:
            pieces.append(zeros[:pad])
    return torch.cat(pieces)


def _copy_d2h(kinds: List[Any], chunks: list, caller: dict, use_pinned_staging: bool):
    """Carry out :func:`_plan_d2h`'s plan: the leaves on the host (packed
    leaves as views of their chunk's host copy) and one event per source
    device. On the card the layout and the copies run on the device's copy
    stream after the caller's ``caller`` event; CPU sources (the tests) are
    laid out and copied the same way, in order."""
    out: List[Any] = [None] * len(kinds)
    streams: dict = {}

    def on(device: torch.device):
        if device.type != "cuda":
            return contextlib.nullcontext()
        stream = streams.get(device.index)
        if stream is None:
            stream = streams[device.index] = _copy_stream(device)
            stream.wait_event(caller[device.index])
        return torch.cuda.stream(stream)

    def to_host(t: torch.Tensor) -> torch.Tensor:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda and use_pinned_staging)
        host.copy_(t, non_blocking=True)
        return host

    def keep(t: torch.Tensor) -> None:  # read on the copy stream: keep it until the copy is done
        if t.is_cuda:
            t.record_stream(streams[t.device.index])

    for i, (kind, value) in enumerate(kinds):
        if kind == "host":
            out[i] = value
        elif kind == "single":
            with on(value.device):
                out[i] = to_host(value)
                keep(value)
    for _, device, items, total in chunks:
        with on(device):
            host = to_host(_layout_d2h(items, total))
            for leaf_i, t, off in items:
                keep(t)
                out[leaf_i] = host[off:off + t.numel()].view(t.shape)

    events = []
    for stream in streams.values():
        event = torch.cuda.Event()
        event.record(stream)
        events.append(event)
    return out, events


def start_copy(
    data: Any,
    device=None,
    use_pinned_staging: bool = True,
    pack_cpu_tensors: bool = True,
    min_packed_alignment_bytes: int = _ALIGN,
    max_packed_chunk_bytes: int = _DEFAULT_MAX_CHUNK,
    use_background_thread: bool = True,
    pack_candidate_max_bytes: Optional[int] = None,
    merge_dtype_chunks: bool = False,
) -> AsyncCopyHandle:
    """Start an asynchronous packed copy of a nested structure to ``device``
    (default: the CUDA device; ``device="cpu"`` builds host tensors, and
    copies the CUDA tensor leaves of the tree to the host, packed).

    Parity: ``accvlab_tpu.hostcopy.start_copy``, the same packing plan.
    ``use_pinned_staging=False`` stages a CUDA copy from pageable memory;
    ``pack_cpu_tensors=False`` copies every host array on its own;
    ``min_packed_alignment_bytes`` aligns the packed offsets (raw bytes in
    the merged chunk, whole elements of at least that many bytes in a dtype
    chunk). Returns an :class:`AsyncCopyHandle` with ``ready()`` /
    ``get()``.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    leaves: list = []
    rebuild = _flatten(data, leaves)
    caller = _caller_events(leaves)  # before the background thread runs
    to_host = dev.type == "cpu" and bool(caller)

    def run():
        if to_host:
            kinds, plan = _plan_d2h(leaves, _is_cuda_tensor, pack_cpu_tensors,
                                    min_packed_alignment_bytes, max_packed_chunk_bytes)
            out, events = _copy_d2h(kinds, plan, caller, use_pinned_staging)
            return rebuild(iter(out)), events, [], True
        kinds, plan = _plan(leaves, pack_cpu_tensors, min_packed_alignment_bytes,
                            max_packed_chunk_bytes, pack_candidate_max_bytes, merge_dtype_chunks)
        out, events, written = _copy(kinds, plan, dev, use_pinned_staging, caller)
        return rebuild(iter(out)), events, written, False

    if use_background_thread:
        future = _get_background_pool().submit(run)
    else:
        future: Future = Future()
        try:
            future.set_result(run())
        except Exception as e:
            future.set_exception(e)
    return AsyncCopyHandle(future)
