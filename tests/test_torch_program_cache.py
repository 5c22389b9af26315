"""``accvlab_tpu_torch.tools.program_cache`` (``shared_jit``) against the
JAX package's ``tests/test_program_cache.py``: one case here for each of its
18, named after it, in torch terms, then the executor's device stage through
the shared program.

The property: two structurally identical programs built from distinct
function objects share one executable (a traced ``GraphModule``; on the card
its CUDA graphs, ``tests/test_torch_program_cache_cuda.py``), while every
caller computes with its own captured constants; structurally different
programs never share. The executor runs each leaf spec's device stage
through it after the spec's first EAGER_BATCHES_PER_SPEC batches: bitwise
its eager stage, within the slice's tolerances of JAX's pipeline, and a
rebuilt pipeline hits without a trace.
"""

import io
import os
import sys
import threading
import warnings
from collections import OrderedDict

import numpy as np
import pytest
import torch

import accvlab_tpu.pipeline as jpipe
from accvlab_tpu.pipeline.inputs import DataProvider as JDataProvider
from accvlab_tpu.pipeline.inputs import ShuffledShardedInputCallable as JInput
from accvlab_tpu.pipeline.processing_steps import ImageRange01Normalizer as JRange01
from accvlab_tpu_torch.bench_pipeline import build_pipeline
from accvlab_tpu_torch.pipeline import DType, PipelineDefinition, SampleDataGroup
from accvlab_tpu_torch.pipeline.inputs import DataProvider, ShuffledShardedInputCallable
from accvlab_tpu_torch.pipeline.processing_steps import (
    ImageMeanStdDevNormalizer,
    ImageRange01Normalizer,
    PhotoMetricDistorter,
)
from accvlab_tpu_torch.pipeline.processing_steps.pipeline_step_base import PipelineStepBase
from accvlab_tpu_torch.pipeline import pipeline as executor
from accvlab_tpu_torch.tools import clear_program_cache, program_cache_stats, shared_jit
from accvlab_tpu_torch.tools import program_cache as pc
from accvlab_tpu_torch.tools.program_cache import _SharedProgram

import test_torch_slice as slice_case


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _stats_delta(before, after):
    return {k: after[k] - before[k] for k in ("hits", "misses", "declined")}


def make_fn(table):
    # a fresh closure per call: each is a new function object
    def fn(x, y):
        return (x @ table).sum(dim=1) + y, x * 2.0

    return fn


def test_structurally_identical_builds_share():
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    ex = (torch.ones(5, 3), torch.zeros(5))
    before = program_cache_stats()
    f1 = shared_jit(make_fn(t.clone()), ex)
    f2 = shared_jit(make_fn(t.clone()), ex)
    d = _stats_delta(before, program_cache_stats())
    assert d["misses"] == 1 and d["hits"] == 1 and d["declined"] == 0
    assert isinstance(f1, _SharedProgram) and isinstance(f2, _SharedProgram)
    # both share ONE executable (one traced program, one set of graphs)
    assert f1._exe is f2._exe

    x = torch.from_numpy(np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32))
    y = torch.arange(5, dtype=torch.float32)
    a, b = f1(x, y)
    ea, eb = make_fn(t)(x, y)
    assert torch.equal(a, ea) and torch.equal(b, eb)  # the same operators, bitwise


def test_shared_program_uses_each_callers_own_consts():
    """Sharing is keyed on the constants' STRUCTURE, not their values."""
    ex = (torch.ones(2, 3), torch.zeros(2))
    f1 = shared_jit(make_fn(torch.full((3, 4), 2.0)), ex)
    f2 = shared_jit(make_fn(torch.full((3, 4), -5.0)), ex)
    assert f1._exe is f2._exe
    x, y = torch.ones(2, 3), torch.zeros(2)
    assert torch.equal(f1(x, y)[0], torch.full((2,), 3 * 2.0 * 4))
    assert torch.equal(f2(x, y)[0], torch.full((2,), 3 * -5.0 * 4))
    assert torch.equal(f1(x, y)[0], torch.full((2,), 3 * 2.0 * 4))  # still its own


def test_threads_build_and_call_one_executable():
    """More threads than cores build structurally identical programs with
    their own constants at once and call them, under a short switch
    interval: one executable, every build counted once, each caller its
    own results."""
    n = (os.cpu_count() or 1) + 4
    ex = (torch.ones(2, 3), torch.zeros(2))
    x, y = torch.ones(2, 3), torch.zeros(2)
    start = threading.Barrier(n)
    results, errors = {}, []

    def worker(k):
        try:
            start.wait(timeout=60)
            f = shared_jit(make_fn(torch.full((3, 4), float(k))), ex)
            results[k] = (f._exe, [f(x, y)[0] for _ in range(3)])
        except Exception as e:  # reported below: a thread's failure fails the test
            errors.append((k, repr(e)))

    before = program_cache_stats()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and errors == []
    d = _stats_delta(before, program_cache_stats())
    assert d["hits"] + d["misses"] == n and d["misses"] <= 1 and d["declined"] == 0
    assert len({id(exe) for exe, _ in results.values()}) == 1
    for k, (_, outs) in results.items():
        assert all(torch.equal(o, torch.full((2,), 3 * float(k) * 4)) for o in outs)


def test_different_structure_does_not_share():
    ex = (torch.ones(4, 3),)

    def f(x):
        return torch.tanh(x).sum()

    def g(x):
        return torch.exp(x).sum()

    before = program_cache_stats()
    shared_jit(f, ex)
    shared_jit(g, ex)
    d = _stats_delta(before, program_cache_stats())
    assert d["misses"] == 2 and d["hits"] == 0


def test_different_shapes_do_not_share():
    def f(x):
        return x * 3.0

    before = program_cache_stats()
    shared_jit(f, (torch.ones(4),))
    shared_jit(f, (torch.ones(8),))
    d = _stats_delta(before, program_cache_stats())
    assert d["misses"] == 2 and d["hits"] == 0


def test_donation_consumes_input_buffers():
    def f(x, y):
        return x + 1.0, y

    fn = shared_jit(f, (torch.ones(16, 16), torch.zeros(2)), donate_argnums=(0,))
    x = torch.full((16, 16), 3.0)
    y = torch.zeros(2)
    out, y_out = fn(x, y)
    assert torch.equal(out, torch.full((16, 16), 4.0))
    # the donated buffer was released: no memory, no elements
    assert x.untyped_storage().nbytes() == 0 and x.numel() == 0
    with pytest.raises(RuntimeError):
        x.view(16, 16)
    assert y.untyped_storage().nbytes() == 8 and torch.equal(y, torch.zeros(2))
    # an output that shares a donated storage takes it over (y passes through)
    fy = shared_jit(lambda x, y: (x + 1.0, y), (torch.ones(16, 16), torch.zeros(2)),
                    donate_argnums=(1,))
    y = torch.arange(2.0)
    _, got = fy(torch.ones(16, 16), y)
    assert torch.equal(got, torch.arange(2.0)) and y.untyped_storage().nbytes() == 8


def test_env_kill_switch(monkeypatch):
    monkeypatch.setenv("ACCVLAB_SHARE_PROGRAMS", "0")

    def f(x):
        return x + 1

    before = program_cache_stats()
    fn = shared_jit(f, (torch.ones(3),))
    fn2 = shared_jit(f, (torch.ones(3),))
    d = _stats_delta(before, program_cache_stats())
    assert d["declined"] == 2 and d["misses"] == 0 and d["hits"] == 0
    # declined: each caller's own traced program (JAX: a plain jax.jit), not cached
    assert isinstance(fn, _SharedProgram) and fn._exe is not fn2._exe
    assert program_cache_stats()["size"] == before["size"]
    assert torch.equal(fn(torch.ones(3)), torch.full((3,), 2.0))


def test_large_consts_fall_back_to_plain_jit():
    big = torch.ones(300, 300)  # 360 KB > the 64 KB bound

    def f(x):
        return x + big[: x.shape[0], : x.shape[1]]

    before = program_cache_stats()
    fn = shared_jit(f, (torch.ones(2, 2),))
    d = _stats_delta(before, program_cache_stats())
    assert d["declined"] == 1 and d["misses"] == 0
    assert fn._exe not in pc._CACHE.values()
    assert torch.equal(fn(torch.ones(2, 2)), torch.full((2, 2), 2.0))


def test_lru_bound_holds():
    for i in range(pc._CACHE_MAX + 8):
        n = i + 1

        def f(x, n=n):
            return x * float(n)

        shared_jit(f, (torch.ones(2),))
    assert program_cache_stats()["size"] <= pc._CACHE_MAX


def test_graph_pools_are_bounded(monkeypatch):
    """The CUDA graphs' pools together stay within ``_GRAPH_BYTES_MAX``: the
    least recently captured graphs are dropped first and the newest is
    always kept (the bookkeeping, on stand-in graphs)."""
    monkeypatch.setattr(pc, "_GRAPH_BYTES_MAX", 100)
    monkeypatch.setattr(pc, "_GRAPHS", OrderedDict())
    key = (0, pc._dispatch_context())
    exes = [pc._Executable(None, 0) for _ in range(4)]
    for exe, nbytes in zip(exes, (60, 60, 60, 500)):
        exe.graphs[key] = object()
        pc._register_graph(exe, key, nbytes)
        assert sum(b for _, b in pc._GRAPHS.values()) <= 100 or len(pc._GRAPHS) == 1
    assert [bool(e.graphs) for e in exes] == [False, False, False, True]


def test_lower_audit_surface():
    def f(x):
        return torch.sin(x) * 2.0

    fn = shared_jit(f, (torch.ones(4),))
    txt = fn.lower(torch.empty(4, device="meta")).as_text()
    assert "sin" in txt and "float32[4]" in txt
    with pytest.raises(TypeError, match="traced with"):
        fn.lower(torch.empty(5, device="meta"))


def _build_step():
    """A functional SGD step over parameter dicts (JAX: optax.sgd)."""
    lr = 0.1

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return ((pred - batch["y"]) ** 2).mean()

    def train_step(params, opt_state, batch):
        grads, loss = torch.func.grad_and_value(loss_fn)(params, batch)
        new = {k: params[k] - lr * grads[k] for k in params}
        return new, {"count": opt_state["count"] + 1}, loss

    return train_step


def test_train_step_restart_shares():
    """A restarted trainer's freshly built train step (same model, same
    shapes) reuses the first build's executable."""
    rng = np.random.default_rng(0)
    params = {"w": torch.ones(3, 2)}
    batch = {"x": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)),
             "y": torch.zeros(4, 2)}
    ex = (params, {"count": torch.zeros((), dtype=torch.int64)}, batch)
    before = program_cache_stats()
    s1 = shared_jit(_build_step(), ex)
    p1, o1, l1 = s1(*ex)
    s2 = shared_jit(_build_step(), ex)  # the "restarted process" rebuild
    d = _stats_delta(before, program_cache_stats())
    assert d["misses"] == 1 and d["hits"] == 1 and s1._exe is s2._exe
    p2, o2, l2 = s2(*ex)
    assert torch.equal(l1, l2) and torch.equal(p1["w"], p2["w"])
    want_p, _, want_l = _build_step()(*ex)  # the step run eagerly
    assert torch.equal(l1, want_l) and torch.equal(p1["w"], want_p["w"])
    # and the step actually trains
    for _ in range(20):
        p2, o2, loss = s2(p2, o2, batch)
    assert float(loss) < float(l2) and int(o2["count"]) == 21


class _UInt8Images(DataProvider):
    def __init__(self, n=8, hw=(6, 6)):
        self._n, self._hw = n, hw

    @property
    def sample_data_structure(self):
        s = SampleDataGroup()
        s.add_data_field("image", DType.UINT8)
        return s

    def get_data(self, i):
        s = self.sample_data_structure
        s["image"] = np.full(self._hw + (3,), i * 7 % 255, np.uint8)
        return s

    def get_number_of_samples(self):
        return self._n


class _DeviceNorm(ImageRange01Normalizer):
    placement = "device"


def _pipeline(steps, n=8, batch=4, echo=1):
    inp = ShuffledShardedInputCallable(_UInt8Images(n), batch_size=batch, shuffle=False)
    defn = PipelineDefinition(inp, steps, copy_external_source_passthrough_outputs=False)
    return defn.get_pipeline(batch_size=batch, num_threads=1, device="cpu", seed=0,
                             echo_factor=echo)


def _run(pipe, n):
    outs = []
    try:
        for _ in range(n):
            outs.append({k: v.clone() for k, v in pipe.run().items()})
    finally:
        pipe.stop()
    return outs


def test_pipeline_rebuild_reuses_fused_program():
    """Re-creating the same pipeline (the checkpoint-resume pattern) registers
    a hit for its device program and delivers bit-identical output. The
    first EAGER_BATCHES_PER_SPEC batches of a spec run eagerly and record
    their draws, the next builds the program; the rebuilt pipeline finds it
    by its steps' value and runs it from its first batch, with no trace."""
    clear_program_cache()
    n = executor.EAGER_BATCHES_PER_SPEC + 3
    before = program_cache_stats()
    pipe = _pipeline([_DeviceNorm("image")], n=4 * n)
    first = _run(pipe, n)
    mid = program_cache_stats()
    assert _stats_delta(before, mid) == {"hits": 0, "misses": 1, "declined": 0}
    traces = []
    real = pc._trace

    def counted(*args):
        traces.append(args)
        return real(*args)

    pc._trace = counted
    try:
        again_pipe = _pipeline([_DeviceNorm("image")], n=4 * n)
        again = _run(again_pipe, n)
    finally:
        pc._trace = real
    d = _stats_delta(mid, program_cache_stats())
    assert d == {"hits": 1, "misses": 0, "declined": 0} and not traces
    (program,) = [e[2] for e in again_pipe._stage_specs.values()]
    assert program is [e[2] for e in pipe._stage_specs.values()][0]
    for a, b in zip(first, again):
        assert torch.equal(a["image"], b["image"])


def test_program_waits_for_repeated_specs():
    """A spec's first EAGER_BATCHES_PER_SPEC batches run eagerly and build
    nothing; the next builds the program (a miss), and later ones replay it."""
    clear_program_cache()
    k = executor.EAGER_BATCHES_PER_SPEC
    pipe = _pipeline([_DeviceNorm("image"), _DeviceNorm("image")], n=4 * (k + 2))
    before = program_cache_stats()
    try:
        for i in range(k + 2):
            pipe.run()
            d = _stats_delta(before, program_cache_stats())
            assert d["misses"] == (i >= k) and d["hits"] == 0
        (entry,) = pipe._stage_specs.values()
        assert entry[0] == k + 2 and isinstance(entry[2], _SharedProgram)
    finally:
        pipe.stop()


def test_specs_a_pipeline_keeps_are_bounded(monkeypatch):
    """A pipeline remembers at most _SPECS_MAX leaf specs (with their
    programs), the least recently seen dropped first: a stream of ever-new
    specs pins nothing without bound."""
    monkeypatch.setattr(executor, "_SPECS_MAX", 3)
    pipe = _pipeline([_DeviceNorm("image")])
    try:
        for h in range(2, 8):
            leaves = (torch.zeros(4, h, 6, 3, dtype=torch.uint8),)
            pipe.run_device_stage(leaves, 0)
        assert [s[0][0][1] for s in pipe._stage_specs] == [5, 6, 7]
    finally:
        pipe.stop()


class _Scaled(_DeviceNorm):
    """A device step holding a closure: its state cannot be keyed by value."""

    def __init__(self, name, factor):
        super().__init__(name)
        self._scale = lambda x: x * factor

    def _process(self, data):
        data = super()._process(data)
        data[self._image_name] = self._scale(data[self._image_name])
        return data


def test_unkeyable_steps_are_found_by_their_trace():
    """A pipeline whose steps hold state that cannot be keyed by value (a
    closure) has no name: a rebuild traces its stage again, and the trace's
    key still finds the shared executable."""
    assert executor._value_key((1, "a", torch.ones(2))) == executor._value_key(
        (1, "a", torch.ones(2)))
    with pytest.raises(TypeError):
        executor._value_key(_Scaled("image", 2.0))
    clear_program_cache()
    n = executor.EAGER_BATCHES_PER_SPEC + 2
    pipes = [_pipeline([_Scaled("image", 2.0)], n=4 * n) for _ in range(2)]
    before = program_cache_stats()
    outs = [_run(p, n) for p in pipes]
    d = _stats_delta(before, program_cache_stats())
    assert d == {"hits": 1, "misses": 1, "declined": 0}
    progs = [[e[2] for e in p._stage_specs.values()][0] for p in pipes]
    assert progs[0]._exe is progs[1]._exe and progs[0] is not progs[1]
    for a, b in zip(*outs):
        assert torch.equal(a["image"], b["image"])


def test_mismatched_call_fails_loudly():
    def f(x):
        return x * 2

    fn = shared_jit(f, (torch.ones(4, dtype=torch.float32),))
    with pytest.raises(TypeError, match="traced with"):
        fn(torch.ones(8, dtype=torch.float32))
    with pytest.raises(TypeError, match="traced with"):
        fn(torch.ones(4, dtype=torch.int32))
    with pytest.raises(TypeError, match="leaves"):
        fn(torch.ones(4), torch.ones(4))


def _noise(x, key):
    # a counter-based hash of (key, position): randomness as data, the
    # counterpart of a typed PRNG key leaf
    idx = torch.arange(x.numel(), dtype=torch.int64).reshape(x.shape)
    h = (key * 6364136223846793005 + idx * 1442695040888963407) & 0xFFFFFFFF
    h = (h ^ (h >> 16)) * 0x45D9F3B & 0xFFFFFFFF
    return x + (h & 0xFFFFFF).to(torch.float32) / float(1 << 24)


def test_typed_prng_key_args_share():
    ex = (torch.ones(3), torch.tensor(0, dtype=torch.int64))
    before = program_cache_stats()
    f1 = shared_jit(_noise, ex)
    f2 = shared_jit(lambda x, key: _noise(x, key), ex)
    d = _stats_delta(before, program_cache_stats())
    assert d["misses"] == 1 and d["hits"] == 1
    key = torch.tensor(7, dtype=torch.int64)
    got = f1(torch.ones(3), key)
    assert torch.equal(got, f2(torch.ones(3), key))
    assert torch.equal(got, _noise(torch.ones(3), key))
    assert not torch.equal(got, f1(torch.ones(3), torch.tensor(8, dtype=torch.int64)))


def test_consts_are_captured_by_value():
    """Mutating a captured table after the build changes nothing (a plain
    trace bakes the trace-time value; the shared path must match)."""
    table = torch.full((2, 2), 1.0)

    def f(x):
        return x + table

    fn = shared_jit(f, (torch.zeros(2, 2),))
    table[:] = 100.0
    assert torch.equal(fn(torch.zeros(2, 2)), torch.ones(2, 2))


def test_out_of_range_donate_argnums_raises():
    def f(x, y):
        return x + y

    with pytest.raises(ValueError, match="donate_argnums"):
        shared_jit(f, (torch.ones(2), torch.ones(2)), donate_argnums=(5,))


def test_scalar_leaf_dtype_guard():
    """Python-scalar leaves are checked by their canonical dtype (torch's:
    float -> the default float dtype, int -> int64), so an int where a float
    was traced fails at the boundary."""
    def f(x, s):
        return x * s

    fn = shared_jit(f, (torch.ones(3), 0.5))
    assert torch.equal(fn(torch.ones(3), 2.0), torch.full((3,), 2.0))
    with pytest.raises(TypeError, match="traced with"):
        fn(torch.ones(3), 7)


class _Zeros(DataProvider):
    @property
    def sample_data_structure(self):
        s = SampleDataGroup()
        s.add_data_field("x", DType.FLOAT)
        return s

    def get_data(self, i):
        s = self.sample_data_structure
        s["x"] = np.zeros((2,), np.float32)
        return s

    def get_number_of_samples(self):
        return 4


class _JZeros(JDataProvider):
    @property
    def sample_data_structure(self):
        s = jpipe.SampleDataGroup()
        s.add_data_field("x", jpipe.DType.FLOAT)
        return s

    def get_data(self, i):
        s = self.sample_data_structure
        s["x"] = np.zeros((2,), np.float32)
        return s

    def get_number_of_samples(self):
        return 4


def test_stats_surface_in_pipeline_stats():
    """pipe.stats() exposes the global program-cache counters, and every key
    of the JAX executor's stats."""
    inp = ShuffledShardedInputCallable(_Zeros(), batch_size=2, shuffle=False)
    pipe = PipelineDefinition(inp, [], copy_external_source_passthrough_outputs=False
                              ).get_pipeline(batch_size=2, num_threads=1, device="cpu", seed=0)
    jp = jpipe.PipelineDefinition(JInput(_JZeros(), batch_size=2, shuffle=False), [],
                                  copy_external_source_passthrough_outputs=False
                                  ).get_pipeline(batch_size=2, num_threads=1, seed=0)
    try:
        pipe.run()
        jp.run()
        pc_stats = pipe.stats()["program_cache"]
        assert set(pc_stats) == {"hits", "misses", "declined", "size"}
        assert set(pc_stats) == set(jp.stats()["program_cache"])
        assert set(jp.stats()) <= set(pipe.stats())
    finally:
        pipe.stop()
        jp.stop()


def test_dispatch_context_still_keys_compiles_on_shared_wrapper():
    """The matmul precision is not part of a torch trace (JAX bakes a
    trace-time precision into the jaxpr's dots), so builds under two
    precisions share ONE executable; the precision keys what the executable
    makes per call instead: one CUDA graph per dispatch context (the card
    test holds the graphs; here the context the key reads)."""
    def f(x, y):
        return x @ y

    ex = (torch.ones(4, 4), torch.ones(4, 4))
    prec = torch.get_float32_matmul_precision()
    before = program_cache_stats()
    s1 = shared_jit(f, ex)
    ctx1 = pc._dispatch_context()
    try:
        torch.set_float32_matmul_precision("medium")
        s2 = shared_jit(f, ex)
        ctx2 = pc._dispatch_context()
    finally:
        torch.set_float32_matmul_precision(prec)
    d = _stats_delta(before, program_cache_stats())
    assert d["misses"] == 1 and d["hits"] == 1 and s1._exe is s2._exe
    assert ctx1 != ctx2 and pc._dispatch_context() == ctx1
    assert torch.equal(s1(*ex), s2(*ex))


# --------------------------------------------------------------------------- #
# The executor's device stage through the shared program                      #
# --------------------------------------------------------------------------- #


def _small(wire, num_samples=16, **kw):
    return build_pipeline(batch_size=2, device="cpu", num_threads=2, hw=(96, 256), num_cams=2,
                          out_hw=(64, 176), heatmap_hw=(16, 44), num_samples=num_samples,
                          wire=wire, **kw)


def _kept_leaves(pipe):
    """Clones of every batch's leaves before its device stage, with the
    batch's indices."""
    kept = []
    stage = pipe.run_device_stage

    def keep(leaves, batch_idx, echo_i=0):
        kept.append(([x.clone() for x in leaves], batch_idx, echo_i))
        return stage(leaves, batch_idx, echo_i)

    pipe.run_device_stage = keep
    return kept


@pytest.mark.parametrize("wire,echo", [("frames", 1), ("yuv", 1), ("dct", 1), ("frames", 2),
                                       ("dct", 2)])
def test_pipeline_shared_program_is_bitwise_eager(wire, echo):
    """Every batch delivered through the shared program equals the eager
    stage on the same leaves and key, bit for bit, on the three wires, with
    an echo factor of 2, and with the DCT wire's uint32 leaves."""
    # the DCT wire's leaf shapes follow the content: at this size a spec
    # comes back about once in three batches
    n = 16 if wire == "dct" else 8
    pipe = _small(wire, num_samples=2 * n, echo_factor=echo)
    kept = _kept_leaves(pipe)
    before = program_cache_stats()
    outs = _run(pipe, n)
    d = _stats_delta(before, program_cache_stats())
    assert d["declined"] == 0 and d["misses"] + d["hits"] >= 1
    # a spec repeated: its later batches ran the program
    assert any(e[2] for e in pipe._stage_specs.values())
    if wire == "dct":
        assert any(x.dtype == torch.uint32 for x in kept[0][0])
    for (leaves, batch_idx, echo_i), out in zip(kept, outs):
        want, _ = pipe._run_eager(leaves, batch_idx, echo_i)
        assert tuple(out) == tuple(pipe.output_names)
        for name, a, b in zip(out, out.values(), want):
            assert a.dtype == b.dtype and torch.equal(a, b), name


def test_pipeline_shared_program_matches_jax():
    """The slice's pipeline (raw frames, augmentation off) delivered through
    the shared program against JAX's, within test_torch_slice.py's
    tolerances."""
    before = program_cache_stats()
    n = executor.EAGER_BATCHES_PER_SPEC + 1  # the epoch's 4 batches, the last one a replay
    jax_out = slice_case._outputs(slice_case.jax_pipeline(0.0), n)
    torch_out = slice_case._outputs(slice_case.torch_pipeline(0.0), n)
    d = _stats_delta(before, program_cache_stats())
    assert d["declined"] == 0 and d["misses"] + d["hits"] == 1
    for j, t in zip(jax_out, torch_out):
        assert set(j) == set(t)
        for name in j:
            g, w = t[name], j[name]
            assert g.shape == w.shape and g.dtype == w.dtype, name
            if name.endswith(".image"):
                np.testing.assert_allclose(g, w, rtol=0, atol=1 / 57 + 1e-5, err_msg=name)
                assert float(np.mean(g != w)) < 0.01, name
            elif name.endswith("heatmap"):
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=name)
            else:
                np.testing.assert_array_equal(g, w, err_msg=name)


def _photometric(lo=-16.0, hi=16.0):
    return PhotoMetricDistorter("image", min_max_brightness=[lo, hi], min_max_hue=[-10.0, 10.0],
                                min_max_contrast=[0.8, 1.2], min_max_saturation=[0.8, 1.2])


def test_export_after_a_found_program_keeps_the_eager_stage_real():
    """A rebuilt pipeline that finds its program runs none of its steps
    eagerly, so the first time its steps run at all may be under a trace
    (``device_program_text``'s export): the DCT unpacker must not keep the
    fake constants it makes there, and the eager stage afterwards computes
    real outputs, bitwise the program's."""
    from torch._subclasses.fake_tensor import is_fake

    first = _small("dct", num_samples=32)
    _run(first, 16)
    pipe = _small("dct", num_samples=32)
    try:
        for _ in range(16):
            batch_idx, _, _, host = pipe._produce_host_batch()
            leaves = pipe._transfer(host)
            want = pipe.run_device_stage(leaves, batch_idx)
            if pipe._stage_specs[pipe._last_device_spec[0]][2]:
                break
        (entry,) = pipe._stage_specs.values()
        assert entry[0] == 1 and entry[2]  # found: the steps never ran eagerly
        pipe.device_program_text()
        got, _ = pipe._run_eager(leaves, batch_idx)
        for a, b in zip(want, got):
            assert not is_fake(b) and torch.equal(a, b)
    finally:
        pipe.stop()


@pytest.mark.parametrize("differ", ["constants", "static_range"])
def test_pipelines_differing_in_constants_share_one_executable(differ):
    """Two pipelines that differ only in a step's constants (the normalizer's
    mean and std) or in a static random range (the brightness range, applied
    to the draws on the host) share one executable, each with its own
    results: its own eager stage's, bitwise."""
    def steps(k):
        if differ == "constants":
            return [_photometric(), ImageMeanStdDevNormalizer(
                "image", mean=[100.0 + k, 110.0, 120.0], std_dev=[50.0, 55.0 + k, 60.0])]
        return [_photometric(-16.0 - 8 * k, 16.0 + 8 * k),
                ImageMeanStdDevNormalizer("image", mean=[100.0, 110.0, 120.0],
                                          std_dev=[50.0, 55.0, 60.0])]

    n = executor.EAGER_BATCHES_PER_SPEC + 1
    pipes = [_pipeline(steps(k), n=4 * n) for k in range(2)]
    kept = [_kept_leaves(p) for p in pipes]
    outs = [_run(p, n) for p in pipes]
    programs = [next(iter(p._stage_specs.values()))[2] for p in pipes]
    assert programs[0]._exe is programs[1]._exe and programs[0] is not programs[1]
    assert not torch.equal(outs[0][-1]["image"], outs[1][-1]["image"])
    for p, k, o in zip(pipes, kept, outs):
        leaves, batch_idx, echo_i = k[-1]
        want, _ = p._run_eager(leaves, batch_idx, echo_i)
        assert torch.equal(o[-1]["image"], want[0])


class _ReadsBack(PipelineStepBase):
    """A custom device step with a host read: it cannot be traced."""

    placement = "device"

    def __init__(self, name):
        super().__init__()
        self._name = name

    def _check_and_adjust_data_format_input_to_output(self, data_empty):
        return data_empty

    def _process(self, data):
        img = data[self._name]
        data[self._name] = img + int(img.min().item())
        return data


def test_trace_failure_declines_with_warning():
    """A device step that calls ``.item()`` makes the trace fail: the stage
    declines with one warning naming the function and the tracer's error,
    and runs as written, with the eager result."""
    n = executor.EAGER_BATCHES_PER_SPEC + 2
    pipe = _pipeline([_ReadsBack("image")], n=4 * n)
    kept = _kept_leaves(pipe)
    before = program_cache_stats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        outs = _run(pipe, n)
    d = _stats_delta(before, program_cache_stats())
    assert d["declined"] == 1 and d["misses"] == 0 and d["hits"] == 0
    msgs = [str(w.message) for w in caught if "shared_jit" in str(w.message)]
    assert len(msgs) == 1 and "device stage (_ReadsBack)" in msgs[0]
    assert "_local_scalar_dense" in msgs[0]
    for (leaves, batch_idx, echo_i), out in zip(kept, outs):
        want, _ = pipe._run_eager(leaves, batch_idx, echo_i)
        assert torch.equal(out["image"], want[0])


def test_jax_range01_matches_the_shared_program():
    """A device normalizer delivered through the shared program equals the
    JAX package's device normalizer on the same provider."""

    class JImages(JDataProvider):
        @property
        def sample_data_structure(self):
            s = jpipe.SampleDataGroup()
            s.add_data_field("image", jpipe.DType.UINT8)
            return s

        def get_data(self, i):
            s = self.sample_data_structure
            s["image"] = np.full((6, 6, 3), i * 7 % 255, np.uint8)
            return s

        def get_number_of_samples(self):
            return 8

    class JDeviceNorm(JRange01):
        placement = "device"

    jp = jpipe.PipelineDefinition(JInput(JImages(), batch_size=4, shuffle=False),
                                  [JDeviceNorm("image")],
                                  copy_external_source_passthrough_outputs=False
                                  ).get_pipeline(batch_size=4, num_threads=1, seed=0)
    try:
        want = [np.asarray(jp.run()["image"]) for _ in range(2)]
    finally:
        jp.stop()
    got = _run(_pipeline([_DeviceNorm("image")]), 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"].numpy(), w)
