"""Process-global sharing of traced device programs (``shared_jit``).

Port of ``accvlab_tpu/tools/program_cache.py``. JAX compiles one program per
jitted function object, so a rebuilt pipeline or train step (a checkpoint
resume, a preemption restart) pays the compile again; the JAX module keys
one compiled executable on the program's structure instead. Eager PyTorch
compiles nothing, but it dispatches every operator from the host on every
call. Its counterpart of a compiled program is the function traced once into
an FX graph and, on the card, captured once as a CUDA graph that every
later call replays: a few copies and one graph launch instead of a host
dispatch per operator. This module keys those traced programs and their
graphs on structure, so two structurally identical builds share one
executable, and each still computes with its own constants.

* **Trace.** ``make_fx(tracing_mode="fake")`` over the flattened leaves
  (``torch.utils._pytree``): one tracer for a forward function and for a
  functional train step that calls ``torch.func.grad`` or
  ``torch.autograd.grad`` (the backward's ATen operators are recorded).
  Nothing runs on real data while tracing: a host read (``.item()``,
  ``.tolist()``), an output shape that depends on the data, or a kernel
  launched through ``ctypes`` that is not a registered operator (it asks a
  fake tensor for its data pointer) makes the trace fail. So does a program
  that writes into one of its arguments or copies host memory to the card.
* **Constants.** Tensors the function captures become the traced graph's
  constants. Operators whose inputs are all constants (the move of a host
  table to the card, a dtype cast) are evaluated once at build, and every
  constant left becomes a runtime input, copied (``clone``) at build: each
  caller keeps its own constants, and changing the captured tensor later
  changes nothing. A graph that writes into a constant gets a copy of it.
  More than 64 KB of constants declines sharing.
* **Key.** The graph's code with the constants as numbered inputs, the
  constants' shapes, dtypes and devices, the leaves' shapes and dtypes, the
  input and output pytree specs, and the donated leaf positions.
* **Executable.** One per key. On the CPU it runs the ``GraphModule``. On a
  CUDA device it holds one ``torch.cuda.CUDAGraph`` per (device, dispatch
  context), captured at the first call there: a warm-up run on a side
  stream, whose outputs that call returns, then the capture
  (``capture_error_mode="thread_local"``) into a private memory pool. A
  later call copies its leaves (and another caller's constants) into the
  graph's static buffers on the caller's current stream, replays the graph
  and returns copies of its outputs: the caller owns them, the next replay
  overwrites the graph's own. The dispatch context is the float32 matmul
  precision, ``torch.backends.cuda.matmul.allow_tf32``,
  ``torch.backends.cudnn.allow_tf32`` and deterministic algorithms: a graph
  keeps the kernels chosen at its capture, so another context gets its own
  graph. A lock per executable orders copy-in, replay and copy-out, and an
  event orders two callers on two streams. The hand kernels' launch
  counters (:mod:`.launch_counts`) count the launches a replay makes. The
  graphs' pools are bounded (:data:`_GRAPH_BYTES_MAX`): the least recently
  captured graphs are dropped first, and captured again at their next call.
* **Donation.** After the call each donated leaf's storage is released
  (``untyped_storage().resize_(0)``, for every view of it) and the leaf is
  left with no elements, so a read of its old shape raises (JAX raises on
  every use of a deleted array). A storage that an output shares (JAX's
  donation into an output), or that does not own its memory (a numpy
  array's), is kept.

Declined (``ACCVLAB_SHARE_PROGRAMS=0``, or constants over 64 KB): the caller
gets a private executable, traced and captured the same way, not cached.
A trace that fails gives the function as written, with one warning that
names the function and the tracer's error. Both count as ``declined``.

The key is read from the trace, and a trace with ``make_fx`` costs seconds
for a program of a few thousand operators, where JAX's ``make_jaxpr`` costs
milliseconds. A caller that can name its program by value without tracing
it keeps the program under that name (:func:`keep_program`) and finds it
there before a later build (:func:`find_program`): a find is a hit that
skips the trace. The executor names its device stage by its steps' types and
state, the leaf specs and the device.

Used by the pipeline executor for its device stage
(``pipeline/pipeline.py``), and directly for a functional train step::

    step = shared_jit(train_step, (params, opt_state, batch))
    params, opt_state, loss = step(params, opt_state, batch)

A program's outputs carry no autograd history: a train step takes its
gradients inside the program.
"""

from __future__ import annotations

import hashlib
import operator
import os
import re
import threading
import time
import warnings
import weakref
from collections import OrderedDict
from typing import List

import torch
import torch.utils._pytree as pytree

from . import launch_counts

__all__ = ["shared_jit", "program_cache_stats", "clear_program_cache"]

_CACHE: "OrderedDict[tuple, _Executable]" = OrderedDict()
_LOCK = threading.Lock()
# make_fx keeps its tracer in module state: one trace at a time per process
_TRACE_LOCK = threading.Lock()
# LRU-bounded so that a long-lived process cycling through many batch specs
# does not keep every program
_CACHE_MAX = 64
# constants are runtime inputs, copied into the graph whenever another
# caller replays it: more than this declines sharing (JAX's bound)
_CONST_BYTES_MAX = 64 << 10
# the CUDA graphs' private pools together: past this the least recently
# captured graphs are dropped (the newest is always kept), so that many
# specs passing through one process do not pin their intermediates
_GRAPH_BYTES_MAX = 4 << 30

_stats = {"hits": 0, "misses": 0, "declined": 0}
# a caller's name for a program (keep_program) -> (the shared program, the
# caller's payload), LRU-bounded as the cache is
_BY_NAME: "OrderedDict[tuple, tuple]" = OrderedDict()
# (id(executable), device index, context) -> (weakref to the executable,
# pool bytes), oldest capture first
_GRAPHS: "OrderedDict[tuple, tuple]" = OrderedDict()


def program_cache_stats() -> dict:
    """Counters and current size of the shared-program cache."""
    with _LOCK:
        return {**_stats, "size": len(_CACHE)}


def clear_program_cache() -> None:
    """Drop every shared program, and every CUDA graph with its pool."""
    with _LOCK:
        _CACHE.clear()
        _BY_NAME.clear()
        graphs = list(_GRAPHS.items())
        _GRAPHS.clear()
    for (_, index, ctx), (ref, _) in graphs:
        exe = ref()
        if exe is not None:
            exe.graphs.pop((index, ctx), None)


def _dispatch_context() -> tuple:
    return (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, torch.are_deterministic_algorithms_enabled())


def _scalar_dtype(x) -> torch.dtype:
    """A Python scalar leaf's dtype, as ``torch.tensor`` gives it: ``bool``,
    ``int64``, or the default float dtype (JAX: int32 and float32 without
    x64, weakly typed)."""
    if isinstance(x, bool):
        return torch.bool
    if isinstance(x, int):
        return torch.int64
    if isinstance(x, float):
        return torch.get_default_dtype()
    raise TypeError(f"shared_jit takes tensors and Python scalars as leaves, got "
                    f"{type(x).__name__}")


def _leaf_spec(x) -> tuple:
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), str(x.dtype)
    return (), str(_scalar_dtype(x))


class _Lowered:
    """The traced program's text (``lower(...).as_text()``)."""

    def __init__(self, text: str):
        self._text = text

    def as_text(self) -> str:
        return self._text


def _step_of(node) -> str:
    """The module (a pipeline's device step) a node was traced in."""
    stack = node.meta.get("nn_module_stack") or {}
    names = [path.split(".")[-1] for path, _ in stack.values()]
    return next((n for n in reversed(names) if n), "")


def program_text(program) -> str:
    """One line per node of a traced or exported program (``.graph``): its
    name, dtype and shape, the call, and the module that made it."""
    lines = []
    for node in program.graph.nodes:
        val = node.meta.get("val")
        spec = ""
        if isinstance(val, torch.Tensor):
            spec = f" : {str(val.dtype).replace('torch.', '')}{list(val.shape)}"
        step = _step_of(node)
        lines.append(f"{node.format_node()}{spec}" + (f"  # {step}" if step else ""))
    return "\n".join(lines)


class _Graph:
    """One capture of an executable on one device in one dispatch context."""

    __slots__ = ("graph", "static_in", "static_out", "launches", "owner", "done", "pool_bytes",
                 "capture_s")

    def __init__(self):
        self.owner = None  # the constants last copied in (a caller's list)
        self.done = None  # recorded after the last copy-out


class _Executable:
    """The program of one key: its ``GraphModule``, and on the card one
    CUDA graph per (device, dispatch context)."""

    def __init__(self, gm: torch.fx.GraphModule, n_consts: int):
        self.gm = gm
        self.n_consts = n_consts
        self.lock = threading.Lock()
        self.graphs: dict = {}

    def __call__(self, consts: list, flat: list, owner) -> list:
        dev = next((x.device for x in flat if isinstance(x, torch.Tensor) and x.dim() > 0),
                   None)
        on_card = dev is not None and dev.type == "cuda" and all(
            x.device == dev for x in flat if isinstance(x, torch.Tensor) and x.dim() > 0)
        if not on_card:
            return list(self.gm(*consts, *[_as_tensor(x) for x in flat]))
        key = (dev.index, _dispatch_context())
        with self.lock:
            g = self.graphs.get(key)
            if g is None:
                return self._capture(dev, key, _consts_on(owner, dev), flat, owner)
            return self._replay(g, dev, _consts_on(owner, dev), flat, owner)

    def _capture(self, dev, key, consts, flat, owner) -> list:
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        with torch.cuda.device(dev):
            g = _Graph()
            g.static_in = [torch.empty(x.shape, dtype=x.dtype, device=dev) for x in consts] + [
                torch.empty(_leaf_spec(x)[0], dtype=x.dtype if isinstance(x, torch.Tensor)
                            else _scalar_dtype(x), device=dev) for x in flat]
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                _copy_in(g.static_in, consts, flat)
                warm = list(self.gm(*g.static_in))  # this call's outputs
            cur.wait_stream(side)
            inputs = {s.untyped_storage().data_ptr() for s in g.static_in}
            outs = []
            for o in warm:
                if isinstance(o, torch.Tensor):
                    if o.untyped_storage().data_ptr() in inputs:
                        o = o.clone()  # an input passed through: the buffer is the graph's
                    else:
                        o.record_stream(cur)
                outs.append(o)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            before = launch_counts.snapshot()
            t0 = time.perf_counter()
            g.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g.graph, stream=side, capture_error_mode="thread_local"):
                g.static_out = list(self.gm(*g.static_in))
            g.capture_s = time.perf_counter() - t0
            # the capture launched nothing: its counts belong to the replays
            g.launches = launch_counts.since(before)
            launch_counts.add(g.launches, -1)
            g.pool_bytes = torch.cuda.memory_reserved(dev) - reserved + sum(
                s.nbytes for s in g.static_in)
            g.owner = owner
        self.graphs[key] = g
        _register_graph(self, key, g.pool_bytes)
        return outs

    def _replay(self, g: _Graph, dev, consts, flat, owner) -> list:
        cur = torch.cuda.current_stream(dev)
        with torch.cuda.device(dev):
            if g.done is not None:
                cur.wait_event(g.done)  # the last caller's copy-out, maybe on another stream
            if g.owner is owner:  # these constants are in place already
                _copy_in(g.static_in[self.n_consts:], [], flat)
            else:
                _copy_in(g.static_in, consts, flat)
                g.owner = owner
            g.graph.replay()
            outs = [o.clone() if isinstance(o, torch.Tensor) else o for o in g.static_out]
            g.done = torch.cuda.Event()
            g.done.record(cur)
        launch_counts.add(g.launches)
        return outs


def _as_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=_scalar_dtype(x))


def _copy_in(static: list, consts: list, flat: list) -> None:
    for s, x in zip(static, list(consts) + list(flat)):
        if isinstance(x, torch.Tensor) and x.device == s.device:
            s.copy_(x)
        else:  # a Python scalar or a 0-d host tensor: read on the host, no copy
            s.fill_(x)


def _consts_on(owner, dev) -> list:
    """A caller's constants on ``dev``, moved there once."""
    got = owner.on_device.get(dev)
    if got is None:
        got = [c.to(dev) for c in owner.consts]
        owner.on_device[dev] = got
    return got


def _register_graph(exe: _Executable, key: tuple, nbytes: int) -> None:
    """Record a new graph; drop the least recently captured ones while the
    pools together exceed the bound. A dropped graph's pool is released
    when its last replay is done (the caller of a replay in flight holds
    it)."""
    drop = []
    with _LOCK:
        for k in [k for k, (ref, _) in _GRAPHS.items() if ref() is None]:
            del _GRAPHS[k]  # an executable nobody holds took its graphs along
        _GRAPHS[(id(exe),) + key] = (weakref.ref(exe), nbytes)
        total = sum(b for _, b in _GRAPHS.values())
        while total > _GRAPH_BYTES_MAX and len(_GRAPHS) > 1:
            (_, index, ctx), (ref, b) = _GRAPHS.popitem(last=False)
            total -= b
            drop.append((ref, (index, ctx)))
    for ref, k in drop:
        other = ref()
        if other is not None:
            other.graphs.pop(k, None)


class _Constants:
    """One caller's constants: as built, and moved to each card once."""

    __slots__ = ("consts", "on_device", "__weakref__")

    def __init__(self, consts: List[torch.Tensor]):
        self.consts = consts
        self.on_device: dict = {}


class _SharedProgram:
    """One caller's handle on a shared executable: the executable plus this
    caller's constants."""

    __slots__ = ("_exe", "_key", "_consts", "_in_tree", "_out_tree", "_in_specs", "_donate",
                 "_text")

    def __init__(self, exe, key, consts, in_tree, out_tree, in_specs, donate, text):
        self._exe = exe
        self._key = key  # the cache's key, None for a private executable
        self._consts = _Constants(consts)
        self._in_tree = in_tree
        self._out_tree = out_tree
        self._in_specs = in_specs
        self._donate = donate
        self._text = text

    def _check_leaves(self, flat):
        # running a graph on leaves it was not traced for is at best a shape
        # error deep inside it and at worst a silent dtype divergence: fail
        # at the boundary (devices are not part of the spec)
        if len(flat) != len(self._in_specs):
            raise TypeError(f"shared program called with {len(flat)} array leaves, traced "
                            f"with {len(self._in_specs)}")
        for x, want in zip(flat, self._in_specs):
            got = _leaf_spec(x)
            if got != want:
                raise TypeError(f"shared program called with leaf {got}, traced with {want} "
                                "— build a new shared_jit for new shapes/dtypes")

    def __call__(self, *args):
        flat, tree = pytree.tree_flatten(args)
        self._check_leaves(flat)
        if tree != self._in_tree:
            raise TypeError(f"shared program called with the structure {tree}, traced with "
                            f"{self._in_tree}")
        outs = self._exe(self._consts.consts,
                         [x.contiguous() if isinstance(x, torch.Tensor) else x for x in flat],
                         self._consts)
        if self._donate:
            kept = {o.untyped_storage().data_ptr() for o in outs if isinstance(o, torch.Tensor)}
            for i in self._donate:
                s = flat[i].untyped_storage()
                if s.resizable() and s.data_ptr() not in kept:
                    s.resize_(0)
                    flat[i].set_()  # no elements: a read of the old shape raises
        return pytree.tree_unflatten(outs, self._out_tree)

    def lower(self, *args):
        """The traced program for these leaf specs (tensors of the traced
        shapes and dtypes, on any device, ``meta`` included): ``as_text()``
        gives one line per node."""
        self._check_leaves(pytree.tree_leaves(args))
        return _Lowered(self._text)


class _Untraceable(Exception):
    """The program cannot run as a traced graph (the reason is the text)."""


def _trace(fn, example_args: tuple):
    """``(GraphModule, input tree, output tree)`` of ``fn`` traced on fake
    tensors shaped as ``example_args``' leaves (contiguous)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    flat, in_tree = pytree.tree_flatten(example_args)
    for x in flat:
        _leaf_spec(x)  # raises on an unsupported leaf
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        fakes = [mode.from_tensor(x).contiguous() if isinstance(x, torch.Tensor)
                 else mode.from_tensor(_as_tensor(x)) for x in flat]
    out_tree = []

    def flat_fn(*leaves):
        # a Python scalar leaf enters as a 0-d tensor, as JAX traces it
        out = fn(*pytree.tree_unflatten(list(leaves), in_tree))
        outs, tree = pytree.tree_flatten(out)
        out_tree.append(tree)
        return outs

    gm = make_fx(flat_fn, tracing_mode="fake", _allow_non_fake_inputs=True,
                 record_module_stack=True)(*fakes)
    return gm, in_tree, out_tree[0]


def _base(node):
    """The node whose storage ``node`` views (through view operators)."""
    while isinstance(node.target, torch._ops.OpOverload) and node.args and \
            isinstance(node.args[0], torch.fx.Node) and \
            node.target._schema.returns and node.target._schema.returns[0].alias_info:
        node = node.args[0]
    return node


def _written(node) -> list:
    """The argument nodes an operator writes into."""
    if not isinstance(node.target, torch._ops.OpOverload) or not node.target._schema.is_mutable:
        return []
    out = []
    for arg, a in zip(node.target._schema.arguments, node.args):
        if arg.alias_info is not None and arg.alias_info.is_write and isinstance(a, torch.fx.Node):
            out.append(a)
    for name, a in node.kwargs.items():
        arg = next((x for x in node.target._schema.arguments if x.name == name), None)
        if arg is not None and arg.alias_info is not None and arg.alias_info.is_write \
                and isinstance(a, torch.fx.Node):
            out.append(a)
    return out


def _foldable(node, consts: dict) -> bool:
    """A functional operator (no write, no view, no randomness) of
    constants only."""
    if node.op != "call_function":
        return False
    ins = node.all_input_nodes
    if not ins or any(n not in consts for n in ins):
        return False
    if node.target is operator.getitem:
        return True
    if not isinstance(node.target, torch._ops.OpOverload):
        return False
    schema = node.target._schema
    if schema.is_mutable or any(r.alias_info for r in schema.returns):
        return False
    return torch.Tag.nondeterministic_seeded not in node.target.tags


def _hoist(gm: torch.fx.GraphModule):
    """Fold the operators of constants only, make every constant left an
    input ahead of the leaves (``c0``, ``c1``, ...), and give a constant the
    graph writes into a copy. Returns the constants (copies, by value).
    Raises :class:`_Untraceable` for a graph that writes into a leaf or, on
    the card, copies host memory."""
    g = gm.graph
    values: dict = {}  # constant node -> its real tensor
    for node in list(g.nodes):
        if node.op == "get_attr":
            values[node] = getattr(gm, node.target)
        elif _foldable(node, values):
            args, kwargs = torch.fx.node.map_arg((node.args, node.kwargs), lambda n: values[n])
            values[node] = node.target(*args, **kwargs)
    live = [n for n in values if any(u not in values for u in n.users)]
    first = next(n for n in g.nodes if n.op == "placeholder")
    consts, slot = [], {}
    for n in live:
        v = values[n]
        if not isinstance(v, torch.Tensor):
            raise _Untraceable(f"a constant of type {type(v).__name__} feeds the program")
        k = id(v)  # one input per tensor, however many nodes read it
        if k not in slot:
            with g.inserting_before(first):
                slot[k] = g.placeholder(f"c{len(consts)}")
            slot[k].meta["val"] = n.meta.get("val")
            consts.append(v.detach().clone())
        n.replace_all_uses_with(slot[k])
    attrs = {n.target for n in values if n.op == "get_attr"}
    for n in reversed(list(values)):
        g.erase_node(n)
    for name in attrs:
        if hasattr(gm, name):
            delattr(gm, name)
    const_nodes = set(slot.values())
    for node in list(g.nodes):
        for a in _written(node):
            base = _base(a)
            if base.op != "placeholder":
                continue
            if base not in const_nodes:
                raise _Untraceable(f"the program writes into its argument leaf {base.name} "
                                   f"({node.target})")
            with g.inserting_after(base):  # later nodes read the copy
                copy = g.call_function(torch.ops.aten.clone.default, (base,))
            copy.meta["val"] = base.meta.get("val")
            base.replace_all_uses_with(copy, delete_user_cb=lambda u: u is not copy)
            const_nodes.discard(base)
    for node in g.nodes:
        val = node.meta.get("val")
        if isinstance(val, torch.Tensor) and val.device.type == "cuda":
            for a in node.all_input_nodes:
                av = a.meta.get("val")
                if isinstance(av, torch.Tensor) and av.device.type == "cpu" and av.dim() > 0 \
                        and a.op != "placeholder":
                    raise _Untraceable(f"{node.target} copies host memory to the card inside "
                                       "the program")
    g.lint()
    gm.recompile()
    return consts


def _build(fn, example_args: tuple, donate_argnums: tuple):
    """``(executable, constants, input tree, output tree, leaf specs,
    donated positions, text, key)``; raises :class:`_Untraceable` or the
    tracer's error."""
    with _TRACE_LOCK:
        gm, in_tree, out_tree = _trace(fn, example_args)
    consts = _hoist(gm)
    # argument positions -> flat leaf positions (every leaf of a donated
    # argument is donated, as jax.jit does)
    donate, pos = [], 0
    for i, a in enumerate(example_args):
        n = len(pytree.tree_leaves(a))
        if i in donate_argnums:
            donate.extend(range(pos, pos + n))
        pos += n
    in_specs = tuple(_leaf_spec(x) for x in pytree.tree_leaves(example_args))
    code = re.sub(r"\s+#.*", "", gm.code)
    key = (
        hashlib.sha256(code.encode()).hexdigest(),
        tuple((tuple(c.shape), str(c.dtype), str(c.device)) for c in consts),
        in_specs,
        str(in_tree),
        str(out_tree),
        tuple(donate),
    )
    return gm, consts, in_tree, out_tree, in_specs, tuple(donate), program_text(gm), key


def shared_jit(fn, example_args, donate_argnums=()):
    """Trace ``fn`` once, with process-global sharing of its program.

    Args:
        fn: a function of positional pytree arguments whose leaves are
            tensors and Python scalars, traceable by ``make_fx`` (no host
            read, no output shape that depends on the data, no kernel that
            is not a registered operator).
        example_args: a tuple of example arguments of the shapes, dtypes and
            devices of the calls; they are not read (the trace is fake).
        donate_argnums: argument positions whose buffers the caller hands
            over (every leaf of the argument is released after the call).

    Returns a callable with ``fn``'s call signature (plus ``.lower``, the
    audit surface). When a structurally identical program was built
    already in this process, its executable, and on the card its CUDA
    graphs, are reused and nothing is captured again. Outside the cache
    (``ACCVLAB_SHARE_PROGRAMS=0``, or constants over 64 KB) the program is
    the caller's own; when the trace fails, ``fn`` itself is returned, with
    a warning.
    """
    example_args = tuple(example_args)
    donate_argnums = tuple(donate_argnums)
    # out-of-range positions are refused, as jax.jit does, never dropped
    if any(not 0 <= i < len(example_args) for i in donate_argnums):
        raise ValueError(
            f"shared_jit got donate_argnums={donate_argnums}, but the "
            f"function only accepts {len(example_args)} positional arguments"
        )
    try:
        gm, consts, in_tree, out_tree, in_specs, donate, text, key = _build(
            fn, example_args, donate_argnums)
    except Exception as e:  # the tracer refuses: fn runs as written
        return _declined(fn, e)
    share = _sharing() and sum(c.nbytes for c in consts) <= _CONST_BYTES_MAX
    with _LOCK:
        if not share:
            _stats["declined"] += 1
            exe, key = _Executable(gm, len(consts)), None
        else:
            exe = _CACHE.get(key)
            if exe is not None:
                _CACHE.move_to_end(key)
                _stats["hits"] += 1
            else:
                _stats["misses"] += 1
                exe = _Executable(gm, len(consts))
                _CACHE[key] = exe
                while len(_CACHE) > _CACHE_MAX:
                    _CACHE.popitem(last=False)
    return _SharedProgram(exe, key, consts, in_tree, out_tree, in_specs, donate, text)


def _sharing() -> bool:
    return os.environ.get("ACCVLAB_SHARE_PROGRAMS", "1") != "0"


def keep_program(name: tuple, program, payload=None) -> None:
    """Keep a shared program under ``name``, a hashable key the caller
    vouches for: a later build with an equal name would trace to the same
    program with equal constants. ``payload`` is returned with it. A program
    outside the cache (declined, or ``fn`` itself after a failed trace) is
    not kept."""
    if not isinstance(program, _SharedProgram) or program._key is None:
        return
    with _LOCK:
        _BY_NAME[name] = (program, payload)
        _BY_NAME.move_to_end(name)
        while len(_BY_NAME) > _CACHE_MAX:
            _BY_NAME.popitem(last=False)


def find_program(name: tuple):
    """``(program, payload)`` kept under ``name`` (:func:`keep_program`),
    counted as a hit, or ``None``: never kept, dropped from the cache since,
    or sharing is off. Nothing is traced."""
    if not _sharing():
        return None
    with _LOCK:
        got = _BY_NAME.get(name)
        if got is None:
            return None
        if _CACHE.get(got[0]._key) is not got[0]._exe:  # the LRU dropped it
            del _BY_NAME[name]
            return None
        _BY_NAME.move_to_end(name)
        _CACHE.move_to_end(got[0]._key)
        _stats["hits"] += 1
        return got


def _declined(fn, err: Exception):
    with _LOCK:
        _stats["declined"] += 1
    name = getattr(fn, "__qualname__", None) or type(fn).__name__
    warnings.warn(f"shared_jit: {name} runs as written, not as a traced program: "
                  f"{type(err).__name__}: {err}", stacklevel=3)
    return fn

