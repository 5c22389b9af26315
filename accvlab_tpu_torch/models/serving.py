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

* **Sharded artifacts** (``mesh=`` with ``in_shardings=``): the program is
  the rank-local one, traced on this rank's shards of the inputs and of the
  ``DTensor`` constants ``fn`` closes over, with no collective in it. One
  file serves every rank: it holds the full constants, and each rank of the
  serving mesh slices its own shard by its mesh coordinate. The header
  records ``nr_devices``, the mesh's axis names and sizes, and the placements
  of every input, sharded constant and output by axis name, with their
  global shapes. Export checks on the exporting mesh that the rank-local
  program is ``fn``: each output's placements are the ones under which
  this rank's output is its shard of ``fn`` on the full inputs, and that
  shard must not change, bit for bit, when every other rank's shard of the
  inputs and constants changes. A function that needs a collective across
  the mesh (a reduction over a sharded dim, a contraction of a split one)
  raises ``ValueError`` and is never served. ``load_inference(mesh=)``
  rebinds the artifact onto any mesh of the same axes and sizes (over
  other ranks, in another order), places host inputs per the recorded
  placements and returns DTensors.

The loader imports ``_device``, ``_draws`` and ``parallel`` (torch and numpy
alone) and, where the header names them, the modules of registered operators
and pytree types; never ``models.centernet`` nor ``pipeline``. An artifact
of the JAX package (StableHLO, ``jax_version`` in its header) is refused.

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
from typing import Callable, Optional, Sequence, Tuple

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


def export_program(fn: Callable, example_args: Tuple, *, batch_polymorphic: bool = False):
    """``fn`` traced at ``example_args`` as an ``ExportedProgram`` (see
    :func:`export_inference`)."""
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


#: the backends an artifact's program runs on (``torch.export`` programs of
#: ATen and the registered operators run on either)
PLATFORMS = ("cuda", "cpu")


def _check_platforms(platforms) -> list:
    if platforms is None:
        return list(PLATFORMS)
    names = [str(p).lower() for p in platforms]
    bad = [p for p in names if p not in PLATFORMS]
    if not names or bad:
        raise ValueError(f"platforms {list(platforms)!r}: this port's artifacts run on "
                         f"{list(PLATFORMS)} only")
    return names


# --------------------------------------------------------------------------- #
# sharded export: the rank-local program                                      #
# --------------------------------------------------------------------------- #


def _placement_text(p) -> str:
    from torch.distributed.tensor import Replicate, Shard

    if isinstance(p, Shard):
        return f"Shard({p.dim})"
    if isinstance(p, Replicate):
        return "Replicate()"
    raise ValueError(f"a serving artifact records Shard and Replicate placements, not {p}")


def placements_by_axis(mesh, placements) -> dict:
    """``{axis name: "Shard(d)" | "Replicate()"}`` of one placement tuple."""
    return {name: _placement_text(p) for name, p in zip(mesh.mesh_dim_names, placements)}


def placements_on(mesh, by_axis: dict) -> tuple:
    """The placement tuple on ``mesh`` of a record of
    :func:`placements_by_axis` (matched by axis name)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        text = by_axis[name]
        out.append(Replicate() if text == "Replicate()" else Shard(int(text[6:-1])))
    return tuple(out)


def mesh_record(mesh) -> dict:
    return {"axis_names": list(mesh.mesh_dim_names), "shape": list(mesh.shape)}


class _SwapDTensors(torch.overrides.TorchFunctionMode):
    """Every ``DTensor`` argument of a torch call replaced by ``swap(d)``:
    ``fn`` then runs on plain tensors (this rank's shards, the full tensors,
    or a traced program's inputs)."""

    def __init__(self, swap):
        super().__init__()
        self._swap = swap

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        def sub(a):
            return self._swap(a) if isinstance(a, DTensor) else a

        args, kwargs = pytree.tree_map(sub, (args, kwargs or {}))
        return func(*args, **kwargs)


class _LocalProgram(torch.nn.Module):
    """``fn`` with its ``DTensor`` constants taken as the second argument
    (this rank's shards, in the order ``fn`` first reads them)."""

    def __init__(self, fn: Callable, constants: list):
        super().__init__()
        self.__dict__["_fn"] = fn
        self.__dict__["_index"] = {id(c): i for i, c in enumerate(constants)}

    def forward(self, args, consts):
        index = self.__dict__["_index"]

        def swap(d):
            if id(d) not in index:
                raise ValueError("fn made a DTensor while it was traced; a sharded export "
                                 "takes DTensors only as constants fn closes over")
            return consts[index[id(d)]]

        with _SwapDTensors(swap):
            return self.__dict__["_fn"](*args)


def _run_swapped(fn: Callable, args, swap):
    with torch.no_grad(), _SwapDTensors(swap):
        return fn(*args)


def _leaf_placements(in_shardings, spec, mesh) -> list:
    """One placement tuple per input leaf: ``in_shardings`` holds one per
    argument, for all of that argument's leaves."""
    from torch.distributed.tensor import Placement

    def is_spec(x):
        return isinstance(x, tuple) and len(x) == mesh.ndim and all(
            isinstance(p, Placement) for p in x)

    flat = list(in_shardings)
    if not all(is_spec(f) for f in flat):
        raise ValueError("in_shardings holds placement tuples, one placement per mesh dim")
    children = spec.children() if hasattr(spec, "children") else spec.children_specs
    if len(flat) != len(children):
        raise ValueError(f"in_shardings gives {len(flat)} placement tuples for "
                         f"{len(children)} arguments")
    out = []
    for f, child in zip(flat, children):
        out += [tuple(f)] * child.num_leaves
    return out


def _full_on(x, dev) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.full_tensor().to(dev)
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.as_tensor(np.asarray(x), device=dev)


def _shape_of_shard(shape, mesh, placements):
    from torch.distributed.tensor import Shard

    shape = list(shape)
    for d, p in enumerate(placements):
        if isinstance(p, Shard):
            if p.dim >= len(shape) or shape[p.dim] % mesh.size(d):
                return None
            shape[p.dim] //= mesh.size(d)
    return tuple(shape)


def _others_changed(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """``full`` with every element outside this rank's shard changed."""
    from ..parallel import _collectives as col

    if full.dtype == torch.bool:
        changed = ~full
    elif full.is_floating_point() or full.is_complex():
        changed = full + 1.0
    else:
        changed = full + 1
    mask = torch.zeros(full.shape, dtype=torch.bool, device=full.device)
    col.local_shard(mask, mesh, placements).fill_(True)
    return torch.where(mask, full, changed)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


def _all_ranks(flags: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise minimum of ``flags`` over every rank of ``mesh``."""
    import torch.distributed as dist

    for d in range(mesh.ndim):
        if mesh.size(d) > 1:
            dist.all_reduce(flags, op=dist.ReduceOp.MIN, group=mesh.get_group(d))
    return flags


#: an output's placements are those whose shard of ``fn`` on the full inputs
#: this rank's output matches within this share of its largest magnitude
#: (per-shard shapes may round bf16 work differently, as JAX's test allows);
#: the exact test is the one of the other ranks' shards
PLACEMENT_RTOL = 5e-2


def _candidates(ref: torch.Tensor, local: torch.Tensor, mesh, input_axes) -> list:
    """Placement tuples under which ``local`` has this rank's shape of
    ``ref``. An axis of one rank is ``Shard(0)`` where it splits an input's
    leading dim and the output keeps that dim's size, else ``Replicate()``."""
    import itertools

    from torch.distributed.tensor import Replicate, Shard

    options = []
    for d, name in enumerate(mesh.mesh_dim_names):
        if mesh.size(d) == 1:
            lead = input_axes.get(name)
            keep = lead is not None and ref.ndim >= 1 and int(ref.shape[0]) in lead
            options.append([Shard(0) if keep else Replicate()])
        else:
            options.append([Shard(k) for k in range(ref.ndim)] + [Replicate()])
    return [c for c in itertools.product(*options)
            if _shape_of_shard(ref.shape, mesh, c) == tuple(local.shape)]


def _output_placements(refs, locals_, mesh, input_axes) -> list:
    from ..parallel import _collectives as col

    cands = [_candidates(r, l, mesh, input_axes) for r, l in zip(refs, locals_)]
    sizes = [len(c) for c in cands]
    flags = []
    for ref, local, cs in zip(refs, locals_, cands):
        for c in cs:
            want = col.local_shard(ref, mesh, c).double()
            got = local.double()
            scale = max(float(want.abs().max()) if want.numel() else 0.0, 1e-30)
            flags.append(bool(torch.isfinite(got).eq(torch.isfinite(want)).all()) and float(
                (got - want).nan_to_num(0.0, 0.0, 0.0).abs().max() if got.numel() else 0.0)
                <= PLACEMENT_RTOL * scale)
    agreed = _all_ranks(torch.tensor(flags or [True], dtype=torch.int32,
                                     device=_mesh_device(mesh)), mesh).tolist()
    out, i = [], 0
    for k, cs in enumerate(cands):
        ok = [c for c, f in zip(cs, agreed[i: i + sizes[k]]) if f]
        i += sizes[k]
        if not ok:
            raise ValueError(
                f"output {k} of fn (local shape {tuple(locals_[k].shape)}, global "
                f"{tuple(refs[k].shape)}) is no shard of fn on the full inputs: fn needs "
                "a collective across the mesh, which a sharded artifact does not hold")
        out.append(ok[0])
    return out


def _mesh_device(mesh) -> torch.device:
    from ..parallel.mesh import mesh_device

    return mesh_device(mesh)


def _export_sharded(fn: Callable, example_args: Tuple, mesh, in_shardings):
    """The rank-local program of ``fn`` on ``mesh``: ``(ExportedProgram,
    header fields, the full constants' bytes)``. See the module's
    docstring."""
    from torch.distributed.tensor import Partial, Shard

    from ..parallel import _collectives as col

    dev = _mesh_device(mesh)
    args = tuple(example_args)
    leaves, spec = pytree.tree_flatten(args)
    in_pl = _leaf_placements(in_shardings, spec, mesh)
    full_in = [_full_on(x, dev) for x in leaves]
    local_in = [col.local_shard(f, mesh, p).contiguous() for f, p in zip(full_in, in_pl)]
    local_args = pytree.tree_unflatten(local_in, spec)

    # 1. this rank's run: the DTensor constants in the order fn reads them
    consts: list = []
    seen = set()

    def collect(d):
        if any(isinstance(p, Partial) for p in d.placements):
            raise ValueError("fn closes over a DTensor with a Partial placement")
        if id(d) not in seen:
            seen.add(id(d))
            consts.append(d)
        return d.to_local()

    local_out = _run_swapped(fn, local_args, collect)
    const_pl = [tuple(c.placements) for c in consts]
    full_consts = [c.full_tensor() for c in consts]
    index = {id(c): i for i, c in enumerate(consts)}

    # 2. fn on the full inputs and constants, then with every other rank's
    # shards changed
    ref = _run_swapped(fn, pytree.tree_unflatten(full_in, spec),
                       lambda d: full_consts[index[id(d)]])
    changed_in = [_others_changed(f, mesh, p) for f, p in zip(full_in, in_pl)]
    changed_consts = [_others_changed(f, mesh, p) for f, p in zip(full_consts, const_pl)]
    other = _run_swapped(fn, pytree.tree_unflatten(changed_in, spec),
                         lambda d: changed_consts[index[id(d)]])

    out_local, out_spec = pytree.tree_flatten(local_out)
    out_ref, ref_spec = pytree.tree_flatten(ref)
    out_other = pytree.tree_leaves(other)
    if out_spec != ref_spec or not all(isinstance(x, torch.Tensor) for x in out_local):
        raise ValueError("fn's output tree on this rank's shards differs from its output on "
                         "the full inputs")
    input_axes: dict = {}
    for f, p in zip(full_in, in_pl):
        for name, pl in zip(mesh.mesh_dim_names, p):
            if pl == Shard(0) and f.ndim >= 1:
                input_axes.setdefault(name, set()).add(int(f.shape[0]))
    out_pl = _output_placements(out_ref, out_local, mesh, input_axes)
    moved = [not _same_bits(col.local_shard(r, mesh, p), col.local_shard(o, mesh, p))
             for r, o, p in zip(out_ref, out_other, out_pl)]
    moved = _all_ranks(torch.tensor([int(not m) for m in moved] or [1], dtype=torch.int32,
                                    device=dev), mesh).tolist()
    if not all(moved):
        k = moved.index(0)
        raise ValueError(
            f"output {k} of fn changes on this rank's shard when other ranks' shards of the "
            "inputs change: fn needs a collective across the mesh, which a sharded artifact "
            "does not hold")

    # 3. the rank-local program, its constants' shards as its inputs
    local_consts = tuple(c.to_local() for c in consts)
    with torch.no_grad():
        ep = torch.export.export(_LocalProgram(fn, consts), (local_args, local_consts),
                                 strict=False)
    buf = io.BytesIO()
    torch.save([f.detach().cpu() for f in full_consts], buf)
    fields = {
        "nr_devices": int(mesh.size()),
        "mesh": mesh_record(mesh),
        "in_placements": [placements_by_axis(mesh, p) for p in in_pl],
        "in_shapes": [list(f.shape) for f in full_in],
        "constant_placements": [placements_by_axis(mesh, p) for p in const_pl],
        "out_placements": [placements_by_axis(mesh, p) for p in out_pl],
        "out_shapes": [list(r.shape) for r in out_ref],
    }
    return ep, fields, buf.getvalue()


def export_inference(fn: Callable, example_args: Tuple, *, batch_polymorphic: bool = False,
                     platforms: Optional[Sequence[str]] = None, mesh=None,
                     in_shardings=None) -> bytes:
    """Export ``fn(*example_args)`` as a self-contained serving artifact and
    return its bytes.

    ``fn`` is a closed inference function (weights captured; see
    :func:`freeze_params`), or a module. Inputs may be tensors on either
    device or numpy arrays; the weights and inputs must lie on one device.

    Args:
        batch_polymorphic: one shared symbolic leading dimension over every
            input leaf (the example's leading sizes must agree and be at
            least 2).
        platforms: the backends the artifact may serve on, from ``("cuda",
            "cpu")`` (default both); another name raises ``ValueError``, and
            loading onto a device of an unlisted backend raises too.
        mesh / in_shardings: a sharded export, given together: ``mesh`` is
            the ``DeviceMesh`` every rank of it calls this on with the same
            arguments, ``in_shardings`` a placement tuple per argument (for all
            of its leaves); ``example_args`` are the global inputs (or
            DTensors), and ``fn`` may close over ``DTensor`` constants.
            Not with ``batch_polymorphic``. See the module's docstring.
    """
    if (mesh is None) != (in_shardings is None):
        raise ValueError("mesh and in_shardings must be given together")
    if mesh is not None and batch_polymorphic:
        raise ValueError("batch_polymorphic sharded export is not supported: the symbolic "
                         "batch dimension cannot be validated against the mesh axis size at "
                         "export time")
    names = _check_platforms(platforms)
    fn_name = getattr(fn, "__qualname__", type(fn).__name__)
    if mesh is None:
        ep = export_program(fn, example_args, batch_polymorphic=batch_polymorphic)
        header = _header(ep, batch_polymorphic, fn_name, _matmul_precision())
        header["platforms"] = names
        return _pack(header, program_bytes(ep))
    ep, fields, consts = _export_sharded(fn, example_args, mesh, in_shardings)
    header = _header(ep, False, fn_name, _matmul_precision())
    header.update(fields, platforms=names)
    program = program_bytes(ep)
    header["program_bytes"] = len(program)
    return _pack(header, program + consts)


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

    On a ``mesh`` (a sharded artifact): each input leaf is placed per its
    recorded placements (a host or local tensor is the global input and
    this rank keeps its shard; a ``DTensor`` is redistributed to them), the
    rank-local program runs with this rank's shards of the constants, and
    each output is a ``DTensor`` with its recorded placements.
    """

    def __init__(self, exported, info: dict, mesh=None, device=None, constants=()):
        self.info = dict(info)
        self.device = (_mesh_device(mesh) if mesh is not None else resolve_device(device)
                       ) if device is None else torch.device(device)
        self.mesh = mesh
        self._program = exported
        self._module = exported.module()
        self._schedule = info.get("draw_schedule")
        self._highest = info.get("float32_matmul") == "highest"
        self._constants = tuple(constants)
        if mesh is not None:
            self._in_pl = [placements_on(mesh, r) for r in info["in_placements"]]
            self._out_pl = [placements_on(mesh, r) for r in info["out_placements"]]

    @property
    def input_shapes(self) -> list:
        """The global shapes of the user inputs (without a pipeline
        program's draws), or ``None`` for a batch-polymorphic artifact."""
        if "in_shapes" in self.info:
            return [tuple(s) for s in self.info["in_shapes"]]
        if self.info.get("batch_polymorphic"):
            return None
        ins = _user_io(self._program)[0]
        if self._schedule is not None:
            ins = ins[:len(ins) - len(self._schedule)]
        return [tuple(v.shape) for v in ins if isinstance(v, torch.Tensor)]

    def _place(self, leaves: list) -> list:
        """This rank's shard of each input leaf."""
        from torch.distributed.tensor import DTensor

        from ..parallel import _collectives as col

        out = []
        for x, pl in zip(leaves, self._in_pl):
            if isinstance(x, DTensor):
                if tuple(x.placements) != pl:
                    x = x.redistribute(self.mesh, pl)
                out.append(x.to_local())
                continue
            if not isinstance(x, torch.Tensor):
                x = torch.as_tensor(np.asarray(x))
            out.append(col.local_shard(x, self.mesh, pl))
        return out

    def _wrap(self, out):
        from torch.distributed.tensor import DTensor

        leaves, spec = pytree.tree_flatten(out)
        wrapped = []
        for x, pl, shape in zip(leaves, self._out_pl, self.info["out_shapes"]):
            shape = torch.Size(shape)
            wrapped.append(DTensor.from_local(x, self.mesh, pl, run_check=False, shape=shape,
                                              stride=torch.empty(shape, device="meta").stride()))
        return pytree.tree_unflatten(wrapped, spec)

    def __call__(self, *args):
        if self._schedule is not None:
            if len(args) != 2:
                raise TypeError("a pipeline device program takes (leaves, key)")
            leaves, key = args
            from .. import _draws

            leaves = list(leaves)
            if self.mesh is not None:
                leaves = self._place(leaves)
            # the program takes uint32 leaves as their int32 bits
            leaves = [x.view(torch.int32) if isinstance(x, torch.Tensor) and
                      x.dtype == torch.uint32 else x for x in leaves]

            draws = [d.pin_memory() if self.device.type == "cuda" else d
                     for d in _draws.make_draws(self._schedule, key)]
            args = (tuple(leaves), tuple(draws))
        elif self.mesh is not None:
            leaves, spec = pytree.tree_flatten(tuple(args))
            args = (pytree.tree_unflatten(self._place(leaves), spec), self._constants)
        elif "constant_placements" in self.info:
            args = (tuple(args), self._constants)
        args = _as_tensors(args, self.device)
        if self._highest:
            with F32MatmulScope():
                out = self._module(*args)
        else:
            out = self._module(*args)
        return out if self.mesh is None else self._wrap(out)


def _import_for(names: Sequence[str], table: dict, what: str) -> None:
    for name in names:
        if name not in table:
            raise ValueError(f"the artifact needs the {what} {name!r}, which this "
                             "accvlab_tpu_torch does not provide")
        importlib.import_module(table[name])


def _check_mesh(header: dict, mesh) -> None:
    """JAX's contracts: a sharded artifact needs a mesh of its size, and the
    mesh's axes must be the recorded ones."""
    nr = int(header.get("nr_devices", 1))
    if nr > 1 and mesh is None:
        raise ValueError(f"artifact was exported for {nr} devices; pass mesh= with that many "
                         "devices to load_inference")
    if mesh is None:
        return
    if mesh.size() != nr:
        raise ValueError(f"artifact was exported for {nr} devices but the serving mesh has "
                         f"{mesh.size()}; shapes and shardings re-bind only onto a same-size "
                         "mesh")
    rec = header.get("mesh")
    if rec is not None and sorted(zip(rec["axis_names"], rec["shape"])) != sorted(
            zip(mesh.mesh_dim_names, mesh.shape)):
        raise ValueError(f"the artifact's mesh axes are {dict(zip(rec['axis_names'], rec['shape']))}"
                         f", the serving mesh's {dict(zip(mesh.mesh_dim_names, mesh.shape))}")


def load_inference(path_or_bytes, *, device=None, mesh=None) -> LoadedInference:
    """Load a serving artifact onto ``device`` (default the card; raises
    without one unless ``device="cpu"``). No model or pipeline code is
    imported. A JAX package artifact raises ``ValueError``.

    ``mesh``: required for a sharded artifact of more than one rank, and
    any ``DeviceMesh`` with the exporting mesh's axis names and sizes (over
    any ranks, in any order); the artifact rebinds onto it by axis name and
    serves on this rank's device of it (``device`` is then ignored). An
    artifact of one rank loads with or without a mesh.
    """
    from torch.export.passes import move_to_device_pass

    header, payload = _unpack(_read_bytes(path_or_bytes))
    if header.get("program_format") != PROGRAM_FORMAT:
        if "jax_version" in header:
            raise ValueError(
                "this is a JAX serving artifact (StableHLO, jax "
                f"{header['jax_version']}): load it with accvlab_tpu.models.serving; the "
                "PyTorch port serves torch.export artifacts only"
            )
        raise ValueError(f"unknown program format {header.get('program_format')!r}")
    _check_mesh(header, mesh)
    if mesh is not None and "in_placements" not in header:
        mesh = None  # an unsharded artifact on a mesh of one rank: plain tensors
    dev = _mesh_device(mesh) if mesh is not None else resolve_device(device)
    if dev.type not in header.get("platforms", PLATFORMS):
        raise ValueError(f"the artifact was exported for {header['platforms']}, not {dev.type}")
    _import_for(header.get("custom_ops", []), CUSTOM_OP_MODULES, "operator")
    _import_for(header.get("pytree_types", []), PYTREE_TYPE_MODULES, "pytree type")
    n_program = int(header.get("program_bytes", len(payload)))
    program = torch.export.load(io.BytesIO(payload[:n_program]))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    program = move_to_device_pass(program, dev)
    constants = ()
    if "constant_placements" in header:
        from ..parallel import _collectives as col

        full = torch.load(io.BytesIO(payload[n_program:]), weights_only=True)
        if mesh is None:  # one rank: each constant is its own shard
            constants = tuple(f.to(dev) for f in full)
        else:
            constants = tuple(
                col.local_shard(f, mesh, placements_on(mesh, r)).contiguous().to(dev)
                for f, r in zip(full, header["constant_placements"]))
    return LoadedInference(program, header, mesh, dev, constants)
