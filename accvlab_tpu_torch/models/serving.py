"""Self-contained serving artifacts: one file holds the program and its weights.

PyTorch port of ``accvlab_tpu/models/serving.py``. A serving host needs
neither the model class nor the pipeline to run inference: it loads one
file with :func:`load_inference` and calls it.

* **The program** is a ``torch.export`` ``ExportedProgram`` (``torch.export.save``
  bytes): the traced graph with the weights as its constants. It is saved
  with its constants on the CPU, and :func:`load_inference` moves them to
  the serving device, so an artifact made on the card or on the CPU serves
  on either.
* **The container** is the JAX package's: a magic, ``<II`` header and payload
  lengths, a JSON header, then the payload. ``read_artifact_info`` audits an
  artifact without loading the program.
* **Batch polymorphism**: ``batch_polymorphic=True`` exports with one shared
  symbolic leading dimension over every input, so one artifact serves every
  batch size. ``torch.export`` specializes a dimension traced at size 1, so
  the example batch must hold 2 or more.
* **Registered operators**: a program that draws heatmaps calls
  ``accvlab_tpu_torch::draw_gaussians``; the header's ``custom_ops`` names
  it and the loader imports the module that registers it
  (``heatmap._ops``). Output types that are not plain containers (a
  :class:`~accvlab_tpu_torch.ragged.RaggedBatch` of detections) are named
  under ``pytree_types`` and imported the same way.
* **float32 matmul precision** is process state that ``torch.export`` does
  not record: the header keeps the exporter's (``"highest"`` for full
  float32, as the pipeline's device stage runs), and the loaded program
  runs under it (``_device.F32MatmulScope``).
* **Pipeline device programs** (``TorchPipeline.export_device_program``)
  take ``(leaves, key)``: the header's ``draw_schedule`` says which random
  draws the stage makes, and the loader makes them from ``key`` on the host
  (:mod:`accvlab_tpu_torch._draws`).

The loader imports ``_device`` and ``_draws`` (torch and numpy alone) and,
where the header names them, the modules of registered operators and pytree
types; never ``models.centernet`` nor ``pipeline``. Sharded artifacts
(``mesh=``) wait for the sharded serving side of ``parallel`` (ROADMAP.md
§1 item 2). An artifact of the JAX
package (StableHLO, ``jax_version`` in its header) is refused.

Typical flow::

    save_inference(path, model, example_images, batch_polymorphic=True)
    ...
    serve = load_inference(path)                     # no model code
    out = serve(images)                              # the fn's output tree
"""

from __future__ import annotations

import copy
import importlib
import io
import json
import os
import struct
from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from .._device import F32MatmulScope, resolve_device

_MAGIC = b"ACCVLAB-SERVE\x00"
_FORMAT_VERSION = 1
PROGRAM_FORMAT = "torch.export"

#: registered operator namespace::name -> the module that registers it
CUSTOM_OP_MODULES = {"accvlab_tpu_torch::draw_gaussians": "accvlab_tpu_torch.heatmap._ops"}
#: pytree serialized_type_name -> the module that registers it
PYTREE_TYPE_MODULES = {"accvlab_tpu_torch.ragged.RaggedBatch": "accvlab_tpu_torch.ragged.ragged_batch"}


# --------------------------------------------------------------------------- #
# artifact container
# --------------------------------------------------------------------------- #


def _spec_text(val) -> str:
    """``float32[b, 3, 32, 32]`` for a traced tensor, ``repr`` otherwise."""
    if isinstance(val, torch.Tensor):
        return f"{str(val.dtype).replace('torch.', '')}[{', '.join(map(str, val.shape))}]"
    return repr(val)


def _user_io(ep) -> Tuple[list, list]:
    """The traced values of the program's user inputs and outputs."""
    from torch.export.graph_signature import InputKind, OutputKind

    nodes = {n.name: n for n in ep.graph.nodes}
    ins = [nodes[s.arg.name].meta.get("val") for s in ep.graph_signature.input_specs
           if s.kind == InputKind.USER_INPUT]
    outs = []
    for s in ep.graph_signature.output_specs:
        if s.kind == OutputKind.USER_OUTPUT:
            name = getattr(s.arg, "name", None)
            outs.append(nodes[name].meta.get("val") if name in nodes else s.arg.value)
    return ins, outs


def custom_ops_of(ep) -> list:
    """``namespace::name`` of every operator outside ``aten``/``prims`` the
    program calls, sorted."""
    ops = set()
    for gm in ep.graph_module.modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        for node in gm.graph.nodes:
            target = node.target
            if node.op == "call_function" and isinstance(target, torch._ops.OpOverload):
                ns = target.namespace
                if ns not in ("aten", "prims", "_operator", "higher_order"):
                    ops.add(f"{ns}::{target._schema.name.split('::')[-1]}")
    return sorted(ops)


def _pytree_types(spec) -> list:
    """serialized_type_name of every registered non-builtin type in a TreeSpec."""
    names = set()

    def walk(s):
        node = pytree.SUPPORTED_SERIALIZED_TYPES.get(s.type)
        name = getattr(node, "serialized_type_name", None)
        if name in PYTREE_TYPE_MODULES:
            names.add(name)
        for child in (s.children() if hasattr(s, "children") else s.children_specs):
            walk(child)

    walk(spec)
    return sorted(names)


def _matmul_precision() -> str:
    """The float32 matmul precision in effect: ``"highest"`` is full float32
    (TF32 off)."""
    if torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return torch.get_float32_matmul_precision()


def _header(ep, batch_polymorphic: bool, fn_name: str, float32_matmul: str) -> dict:
    from .. import __version__

    ins, outs = _user_io(ep)
    return {
        "format_version": _FORMAT_VERSION,
        "accvlab_tpu_torch_version": __version__,
        "torch_version": torch.__version__,
        "program_format": PROGRAM_FORMAT,
        "fn_name": fn_name,
        "platforms": ["cuda", "cpu"],
        "batch_polymorphic": bool(batch_polymorphic),
        "in_specs": [_spec_text(v) for v in ins],
        "out_specs": [_spec_text(v) for v in outs],
        "custom_ops": custom_ops_of(ep),
        "pytree_types": _pytree_types(ep.call_spec.out_spec),
        "float32_matmul": float32_matmul,
        "nr_devices": 1,
    }


def _pack(header: dict, payload: bytes) -> bytes:
    hj = json.dumps(header, sort_keys=True).encode("utf-8")
    if len(payload) >= 1 << 32 or len(hj) >= 1 << 32:
        # the <II length fields cap each section at 4 GiB
        raise ValueError(
            f"serving artifact section too large for the v{_FORMAT_VERSION} format (payload "
            f"{len(payload)} bytes, limit 4 GiB); use models.quantize or ship params separately"
        )
    return _MAGIC + struct.pack("<II", len(hj), len(payload)) + hj + payload


def _unpack(data: bytes) -> Tuple[dict, bytes]:
    if not data.startswith(_MAGIC):
        raise ValueError("not an accvlab_tpu serving artifact (bad magic); did you pass a "
                         "checkpoint or a raw torch.export file?")
    off = len(_MAGIC)
    if len(data) < off + 8:
        raise ValueError("truncated serving artifact")
    hlen, plen = struct.unpack_from("<II", data, off)
    off += 8
    header = json.loads(data[off: off + hlen].decode("utf-8"))
    if header.get("format_version", 0) > _FORMAT_VERSION:
        raise ValueError(f"serving artifact format {header['format_version']} is newer than "
                         f"this accvlab_tpu_torch understands ({_FORMAT_VERSION})")
    payload = data[off + hlen: off + hlen + plen]
    if len(payload) != plen:
        raise ValueError("truncated serving artifact")
    return header, payload


def _read_bytes(path_or_bytes) -> bytes:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return bytes(path_or_bytes)
    with open(path_or_bytes, "rb") as f:
        return f.read()


def read_artifact_info(path_or_bytes) -> dict:
    """The JSON header of an artifact, without loading its program."""
    header, _ = _unpack(_read_bytes(path_or_bytes))
    return header


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


# --------------------------------------------------------------------------- #
# export
# --------------------------------------------------------------------------- #


class _Closed(torch.nn.Module):
    """``fn`` as the module ``torch.export`` traces. ``fn`` is kept outside
    the module's attributes, so a model it closes over is not registered:
    its tensors become the program's constants (and the float weights of a
    quantized model, which the call never reads, are not saved)."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.__dict__["_fn"] = fn

    def forward(self, *args):
        return self.__dict__["_fn"](*args)


def _batch_dims(example_args):
    """dynamic_shapes with one shared ``Dim`` over every leaf's leading size."""
    leaves, spec = pytree.tree_flatten(example_args)
    sizes = set()
    for leaf in leaves:
        if getattr(leaf, "ndim", 0) < 1:
            raise ValueError(
                "batch_polymorphic=True needs every input leaf to have a leading batch "
                f"dimension; got shape {tuple(getattr(leaf, 'shape', ()))}"
            )
        sizes.add(int(leaf.shape[0]))
    if len(sizes) > 1:
        raise ValueError(f"batch_polymorphic=True needs one leading size; got {sorted(sizes)}")
    if sizes and sizes.pop() < 2:
        raise ValueError("batch_polymorphic=True needs an example batch of 2 or more: "
                         "torch.export specializes a dimension traced at size 1")
    b = torch.export.Dim("b", min=1)
    # one entry: _Closed.forward packs the arguments into *args
    return (pytree.tree_unflatten([{0: b} for _ in leaves], spec),)


def _as_tensors(args, device=None):
    def conv(x):
        if isinstance(x, torch.Tensor):
            return x if device is None else x.to(device, non_blocking=True)
        return torch.as_tensor(np.asarray(x), device=device)

    return pytree.tree_map(conv, args)


def export_program(fn: Callable, example_args: Tuple, *, batch_polymorphic: bool = False,
                   mesh=None):
    """``fn`` traced at ``example_args`` as an ``ExportedProgram`` (see
    :func:`export_inference`)."""
    if mesh is not None:
        raise NotImplementedError("sharded export (mesh=) waits for the sharded serving side "
                                  "of parallel (ROADMAP.md §1 item 2)")
    args = tuple(_as_tensors(tuple(example_args)))
    dynamic = _batch_dims(args) if batch_polymorphic else None
    with torch.no_grad():
        return torch.export.export(_Closed(fn), args, dynamic_shapes=dynamic, strict=False)


def program_bytes(ep) -> bytes:
    """``torch.export.save`` bytes of (a copy of) ``ep`` with its constants
    on the CPU, without its example inputs."""
    from torch.export.passes import move_to_device_pass

    ep = copy.deepcopy(ep)
    ep._example_inputs = None  # the tracing inputs are not part of the artifact
    buf = io.BytesIO()
    torch.export.save(move_to_device_pass(ep, "cpu"), buf)
    return buf.getvalue()


def export_inference(fn: Callable, example_args: Tuple, *, batch_polymorphic: bool = False,
                     mesh=None) -> bytes:
    """Export ``fn(*example_args)`` as a self-contained serving artifact and
    return its bytes.

    ``fn`` is a closed inference function (weights captured; see
    :func:`freeze_params`), or a module. Inputs may be tensors on either
    device or numpy arrays; the weights and inputs must lie on one device.
    ``batch_polymorphic=True`` gives every input leaf one shared symbolic
    leading dimension (the example's leading sizes must agree and be at least
    2). ``mesh=`` (a sharded export) raises ``NotImplementedError`` until
    the sharded serving side of ``parallel`` (ROADMAP.md §1 item 2).
    """
    ep = export_program(fn, example_args, batch_polymorphic=batch_polymorphic, mesh=mesh)
    name = getattr(fn, "__qualname__", type(fn).__name__)
    return _pack(_header(ep, batch_polymorphic, name, _matmul_precision()), program_bytes(ep))


def freeze_params(model: Callable, params=None) -> Callable:
    """``fn(*args)``: ``model`` with ``params`` (name -> tensor, default its
    own parameters) closed over, so that the weights trace as constants."""
    if params is None:
        return lambda *args: model(*args)
    return lambda *args: torch.func.functional_call(model, params, args)


def save_inference(path: str, model: Callable, *example_args, params=None,
                   **export_kwargs) -> dict:
    """Bake ``params`` (default the model's own) into ``model`` (a module, or
    any closed inference function when ``params`` is None) and write the
    artifact to ``path`` atomically (a temporary file, then a rename).
    Returns the header."""
    data = export_inference(freeze_params(model, params), example_args, **export_kwargs)
    _atomic_write(path, data)
    return read_artifact_info(data)


# --------------------------------------------------------------------------- #
# load / serve
# --------------------------------------------------------------------------- #


class LoadedInference:
    """A loaded serving artifact: call it like the exported function.

    ``info`` is the header; ``device`` the serving device. Inputs that are
    numpy arrays or tensors on another device are copied to ``device`` (an
    asynchronous copy from pinned host memory). An artifact of a pipeline's
    device program takes ``(leaves, key)``, where ``key`` is the batch key
    (a tuple of ints, e.g. ``(seed, batch_idx)``) its draws are made from.
    """

    def __init__(self, program, info: dict, device: torch.device):
        self.info = dict(info)
        self.device = device
        self._program = program
        self._module = program.module()
        self._schedule = info.get("draw_schedule")
        self._highest = info.get("float32_matmul") == "highest"

    def __call__(self, *args):
        if self._schedule is not None:
            if len(args) != 2:
                raise TypeError("a pipeline device program takes (leaves, key)")
            leaves, key = args
            from .. import _draws

            # the program takes uint32 leaves as their int32 bits
            leaves = [x.view(torch.int32) if isinstance(x, torch.Tensor) and
                      x.dtype == torch.uint32 else x for x in leaves]

            draws = [d.pin_memory() if self.device.type == "cuda" else d
                     for d in _draws.make_draws(self._schedule, key)]
            args = (tuple(leaves), tuple(draws))
        args = _as_tensors(args, self.device)
        if self._highest:
            with F32MatmulScope():
                return self._module(*args)
        return self._module(*args)


def _import_for(names: Sequence[str], table: dict, what: str) -> None:
    for name in names:
        if name not in table:
            raise ValueError(f"the artifact needs the {what} {name!r}, which this "
                             "accvlab_tpu_torch does not provide")
        importlib.import_module(table[name])


def load_inference(path_or_bytes, *, device=None, mesh=None) -> LoadedInference:
    """Load a serving artifact onto ``device`` (default the card; raises
    without one unless ``device="cpu"``). No model or pipeline code is
    imported. A JAX package artifact raises ``ValueError``; ``mesh=`` raises
    ``NotImplementedError`` until the sharded serving side of ``parallel``."""
    from torch.export.passes import move_to_device_pass

    if mesh is not None:
        raise NotImplementedError("sharded serving (mesh=) waits for the sharded serving side "
                                  "of parallel (ROADMAP.md §1 item 2)")
    dev = resolve_device(device)
    header, payload = _unpack(_read_bytes(path_or_bytes))
    if header.get("program_format") != PROGRAM_FORMAT:
        if "jax_version" in header:
            raise ValueError(
                "this is a JAX serving artifact (StableHLO, jax "
                f"{header['jax_version']}): load it with accvlab_tpu.models.serving; the "
                "PyTorch port serves torch.export artifacts only"
            )
        raise ValueError(f"unknown program format {header.get('program_format')!r}")
    if int(header.get("nr_devices", 1)) > 1:
        raise NotImplementedError("sharded artifacts wait for the sharded serving side of "
                                  "parallel (ROADMAP.md §1 item 2)")
    _import_for(header.get("custom_ops", []), CUSTOM_OP_MODULES, "operator")
    _import_for(header.get("pytree_types", []), PYTREE_TYPE_MODULES, "pytree type")
    program = torch.export.load(io.BytesIO(payload))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    program = move_to_device_pass(program, dev)
    return LoadedInference(program, header, dev)
