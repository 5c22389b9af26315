"""Training-state checkpoint and resume.

PyTorch port of ``accvlab_tpu/models/checkpoint.py``, with files of its own
(``torch.save``; orbax is not available to the port) and the JAX package's
contract:

* a checkpoint of ``step`` is the directory ``step_NNNNNNNN`` under the
  checkpoint directory, plus the sidecar ``step_NNNNNNNN.meta.json``
  holding ``{"step", "pipeline"}`` (``pipeline``: ``TorchPipeline.get_state()``
  or any JSON-able dict, restored verbatim for ``pipe.set_state``);
* a save is written under a temporary name in the same directory and
  renamed on commit, so an in-flight or orphaned save is never listed,
  resumed from nor collected (only names matching ``step_NNNNNNNN`` count);
* ``asynchronous=True`` copies the tensors to (pinned) host memory before it
  returns, so the train loop may update its parameters in place at once,
  and serialises on one background thread (saves queue behind each other);
  :func:`wait_for_checkpoints` waits for them and raises a failed save's
  error;
* ``keep=N`` keeps the newest ``N`` committed checkpoints, the one being
  written included: collection runs after that save commits.

``params`` and ``opt_state`` are trees of tensors and plain values (a
module's ``state_dict()``, an optimizer's ``state_dict()``, a dict of
:class:`~.quantize.QuantizedTensor`\\ s); the file holds their leaves and
their tree structure. :func:`restore_checkpoint` places each tensor where
the template's tensor lies.

Sharded state (:mod:`..parallel`): a ``DTensor`` leaf is saved as its full
tensor, so a checkpoint is one file whatever the mesh that wrote it, and a
``DTensor`` template leaf restores onto its own mesh and placements, as JAX
restores onto a template's sharding (the saving layout does not constrain
the restoring one). In a process group of several ranks a save is
collective: every rank calls :func:`save_checkpoint` (each ``DTensor``
gathers its full tensor on every rank), rank 0 alone writes, and every
rank then waits for the commit: at the end of a synchronous save, in
:func:`wait_for_checkpoints` (which every rank calls) for an asynchronous one.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor, distribute_tensor

from ..parallel.mesh import mesh_device

_STATE_FILE = "state.pt"
_STEP_DIR = re.compile(r"^step_\d{8}$")
_TMP_SUFFIX = ".accvlab-checkpoint-tmp"

_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
_pending: list = []
_lock = threading.Lock()


def _executor() -> concurrent.futures.ThreadPoolExecutor:
    """One process-wide background writer (saves queue behind each other)."""
    global _pool
    if _pool is None:
        _pool = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="accvlab-ckpt")
    return _pool


def _ranks() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def wait_for_checkpoints() -> None:
    """Block until every in-flight asynchronous save has committed; raises
    the error of a save that failed. In a group of several ranks every rank
    calls it and returns once rank 0's saves have committed."""
    with _lock:
        pending = list(_pending)
        _pending.clear()
    try:
        for fut in pending:
            fut.result()
    finally:
        if _ranks() > 1:
            dist.barrier()


def _committed_steps(directory: str):
    """Sorted names of COMMITTED checkpoint directories (exactly
    ``step_NNNNNNNN``: an in-flight save's temporary directory never
    matches)."""
    return sorted(d for d in os.listdir(directory)
                  if _STEP_DIR.match(d) and os.path.isdir(os.path.join(directory, d)))


def _gc_old(directory: str, keep: int) -> None:
    """Delete committed checkpoints beyond the newest ``keep``."""
    steps = _committed_steps(directory)
    for d in steps[:-keep] if keep > 0 else []:
        path = os.path.join(directory, d)
        shutil.rmtree(path, ignore_errors=True)
        try:
            os.remove(path + ".meta.json")
        except OSError:
            pass


def _schema():
    from . import quantize  # noqa: F401 (registers QuantizedTensor for the tree spec)


def _snapshot(tree, asynchronous: bool):
    """Leaves and structure of ``tree``, tensors copied off the caller's
    storage: to pinned host memory (CUDA tensors) or as CPU clones, the copies
    complete when this returns."""
    _schema()
    leaves, spec = pytree.tree_flatten(tree)
    out, streams = [], set()
    for leaf in leaves:
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()  # a collective: every rank takes part
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            if leaf.is_cuda:
                host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
                host.copy_(leaf, non_blocking=True)
                streams.add(leaf.device)
                leaf = host
            elif asynchronous:
                leaf = leaf.clone()
        out.append(leaf)
    for dev in streams:
        torch.cuda.current_stream(dev).synchronize()
    return out, pytree.treespec_dumps(spec)


def _write(directory: str, path: str, payload: dict, keep: Optional[int]) -> None:
    tmp = path + _TMP_SUFFIX
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, _STATE_FILE))
    if os.path.isdir(path):  # an earlier save of the same step
        shutil.rmtree(path)
    os.replace(tmp, path)
    if keep is not None:
        _gc_old(directory, int(keep))


def save_checkpoint(
    directory: str,
    step: int,
    params: Any,
    opt_state: Any,
    pipeline_state: Optional[Dict] = None,
    *,
    asynchronous: bool = False,
    keep: Optional[int] = None,
) -> str:
    """Write a checkpoint for ``step`` under ``directory``; returns its path.

    ``asynchronous=True`` returns once the tensors are copied to host
    memory; the file is written on the background thread. ``keep=N`` keeps
    the newest ``N`` committed checkpoints, this one included. In a group of
    several ranks every rank calls it and rank 0 writes (module docstring).
    """
    directory = os.path.abspath(directory)
    path = os.path.join(directory, f"step_{step:08d}")
    payload = {"params": _snapshot(params, asynchronous),
               "opt_state": _snapshot(opt_state, asynchronous)}
    if dist.is_initialized() and dist.get_rank() != 0:
        if not asynchronous:
            dist.barrier()
        return path
    os.makedirs(directory, exist_ok=True)
    # the sidecar is written at once: a stale one of a failed asynchronous
    # save is harmless, since only committed directories are listed
    with open(path + ".meta.json", "w") as f:
        json.dump({"step": step, "pipeline": pipeline_state or {}}, f)
    if asynchronous:
        with _lock:
            _pending.append(_executor().submit(_write, directory, path, payload, keep))
    else:
        try:
            _write(directory, path, payload, keep)
        finally:
            if _ranks() > 1:
                dist.barrier()
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    """Path of the newest COMMITTED checkpoint under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = _committed_steps(directory)
    return os.path.join(directory, steps[-1]) if steps else None


def _place(saved, template, what: str):
    """The saved tree with each tensor moved where the template's lies."""
    leaves, spec = saved
    tree = pytree.tree_unflatten(leaves, pytree.treespec_loads(spec))
    if template is None:
        return tree
    t_leaves, t_spec = pytree.tree_flatten(template)
    if pytree.treespec_dumps(t_spec) != spec:
        raise ValueError(f"the checkpoint's {what} do not have the template's structure")
    placed = []
    for leaf, t in zip(leaves, t_leaves):
        if isinstance(t, torch.Tensor):
            if not isinstance(leaf, torch.Tensor) or tuple(leaf.shape) != tuple(t.shape):
                raise ValueError(f"{what}: saved {getattr(leaf, 'shape', leaf)} does not "
                                 f"fit the template's {tuple(t.shape)}")
            if isinstance(t, DTensor):
                # every rank read the whole file: each keeps its own shard
                # of the full tensor, no collective
                leaf = distribute_tensor(leaf.to(mesh_device(t.device_mesh)), t.device_mesh,
                                         t.placements, src_data_rank=None)
            else:
                leaf = leaf.to(t.device)
        placed.append(leaf)
    return pytree.tree_unflatten(placed, t_spec)


def restore_checkpoint(path: str, template: Any) -> Tuple[Any, Any, Dict]:
    """Restore ``(params, opt_state, meta)`` from a checkpoint directory.

    ``template``: ``{"params": ..., "opt_state": ...}`` of the structure that
    was saved; each restored tensor lies where the template's tensor lies
    (a template of ``None`` restores that part as saved, on the CPU). A
    ``DTensor`` template leaf (its values unused: ``torch.empty`` or the
    meta device will do) restores onto its mesh and placements, whatever
    the layout that saved it.
    """
    _schema()
    path = os.path.abspath(path)
    payload = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu",
                         weights_only=True)
    template = template or {}
    params = _place(payload["params"], template.get("params"), "params")
    opt_state = _place(payload["opt_state"], template.get("opt_state"), "opt_state")
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    return params, opt_state, meta
