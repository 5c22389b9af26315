"""The port's phases as ``torch.profiler`` ranges (``tools/trace_range.py``
``_profiled``): the executor's ``accvlab.pipeline.*`` and the training
step's ``accvlab.train_step.*`` ranges, opened only while a profiler
records, and ``stats()["transfer_s"]``. CPU only, no JAX."""

from __future__ import annotations

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from accvlab_tpu_torch.models.centernet import CenterNetDetector, make_train_step
from accvlab_tpu_torch.pipeline import pipeline as executor
from accvlab_tpu_torch.tools import clear_program_cache, program_cache_stats
from accvlab_tpu_torch.train_centernet_e2e import batch_to_train_inputs, build_train_pipeline

#: enough batches that the stage's program is built and then replayed
BATCHES = executor.EAGER_BATCHES_PER_SPEC + 2
PIPELINE_RANGES = {"consumer_wait", "device_dispatch", "transfer", "draws", "stage",
                   "program_build"}
STEP_RANGES = {"forward", "loss", "backward", "optimizer"}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pipeline(echo=1, samples=16):
    return build_train_pipeline(batch_size=2, device="cpu", num_threads=2, hw=(96, 256),
                                num_cams=2, out_hw=(64, 176), heatmap_hw=(16, 44),
                                num_samples=samples, echo_factor=echo)


def _model_and_step():
    init, step = make_train_step(CenterNetDetector(10, width=8))
    model, opt = init(0, torch.zeros(4, 64, 176, 3), device="cpu")
    return model, opt, step


def _ranges(prof, prefix="accvlab."):
    return [e for e in prof.events() if e.name.startswith(prefix)]


def test_every_phase_is_a_range_with_its_args():
    """Under the profiler, each of the executor's consumer phases and the
    step's phases is a range with its arguments; the transfer, the draws and
    the stage nest in the dispatch; the batches are the phase recorder's."""
    clear_program_cache()  # this pipeline's stage builds its program
    pipe = _pipeline()
    model, opt, step = _model_and_step()
    trace = pipe.start_trace()
    try:
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
            for _ in range(BATCHES):
                batch = pipe.run()
            step(model, opt, batch_to_train_inputs(batch, cam=[0, 1]))
    finally:
        pipe.stop_trace()
        pipe.stop()
    ranges = _ranges(prof)
    names = {e.name for e in ranges}
    assert names == ({f"accvlab.pipeline.{n}" for n in PIPELINE_RANGES}
                     | {f"accvlab.train_step.{n}" for n in STEP_RANGES}
                     | {"accvlab.batch_to_train_inputs"})

    def named(name):
        return [e for e in ranges if e.name == "accvlab." + name]

    recorded = [ev["args"]["batch"] for ev in trace.to_dict()["traceEvents"]
                if ev.get("name") == "device_dispatch"]
    assert recorded == list(range(BATCHES))
    dispatch = named("pipeline.device_dispatch")
    assert [e.kwinputs["batch"] for e in dispatch] == recorded
    assert [e.kwinputs["batch"] for e in named("pipeline.consumer_wait")] == recorded
    assert all(e.kwinputs["echo"] == 0 and e.kwinputs["bytes"] > 0 for e in dispatch)
    assert [e.kwinputs["bytes"] for e in named("pipeline.transfer")] == [
        e.kwinputs["bytes"] for e in dispatch]
    modes = [e.kwinputs["mode"] for e in named("pipeline.stage")]
    eager = executor.EAGER_BATCHES_PER_SPEC
    assert modes == ["eager"] * eager + ["program"] * (BATCHES - eager)
    # on CPU tensors no stage sends the image chain through its kernel
    assert [e.kwinputs["fused"] for e in named("pipeline.stage")] == [0] * BATCHES
    assert len(named("pipeline.draws")) == BATCHES - eager
    assert [e.kwinputs["specs"] for e in named("pipeline.program_build")] == [1]
    for name in ("transfer", "draws", "stage", "program_build"):
        for e in named("pipeline." + name):
            assert e.cpu_parent is not None and e.cpu_parent.name == (
                "accvlab.pipeline.device_dispatch"), name
            if "batch" in e.kwinputs:
                assert e.kwinputs["batch"] == e.cpu_parent.kwinputs["batch"], name
    # one step: one range per phase, the optimizer's twice (zero_grad, step)
    assert [len(named("train_step." + n)) for n in ("forward", "loss", "backward",
                                                    "optimizer")] == [1, 1, 1, 2]


def test_no_range_opens_while_no_profiler_records(monkeypatch):
    """Without a profiler the port enters no record function, by either
    route; with one, the same code enters them. (``torch.optim`` enters its
    own ``Optimizer.*`` ones either way.)"""
    entered = []
    fast = torch._C._profiler._RecordFunctionFast
    enter_new = torch.ops.profiler._record_function_enter_new

    def counting_fast(*args):
        if args[0].startswith("accvlab."):
            entered.append(args[0])
        return fast(*args)

    def counting_enter_new(*args):
        if args[0].startswith("accvlab."):
            entered.append(args[0])
        return enter_new(*args)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counting_fast)
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", counting_enter_new)
    pipe = _pipeline()
    model, opt, step = _model_and_step()
    try:
        for _ in range(BATCHES):
            batch = pipe.run()
        step(model, opt, batch_to_train_inputs(batch, cam=[0, 1]))
        assert entered == []
        with profile(activities=[ProfilerActivity.CPU]):
            batch = pipe.run()
            step(model, opt, batch_to_train_inputs(batch, cam=[0, 1]))
    finally:
        pipe.stop()
    assert "accvlab.pipeline.stage" in entered and "accvlab.train_step.loss" in entered


def test_a_profiled_step_is_bitwise_the_unprofiled_one():
    """The ranges split the step's lines; the results keep every bit."""
    pipe = _pipeline(samples=4)
    try:
        batch = batch_to_train_inputs(pipe.run(), cam=[0, 1])
    finally:
        pipe.stop()
    out = []
    for profiled in (False, True):
        model, opt, step = _model_and_step()
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                _, _, metrics = step(model, opt, batch)
        else:
            _, _, metrics = step(model, opt, batch)
        out.append(([p.detach().clone() for p in model.parameters()], metrics))
    (p0, m0), (p1, m1) = out
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert all(torch.equal(m0[k], m1[k]) for k in m0)


def test_transfer_seconds_count_once_per_transfer():
    """With echo 2 each host batch is transferred once and delivered twice:
    ``transfer_s`` grows with the transfers only, inside ``device_stage_s``."""
    pipe = _pipeline(echo=2)
    try:
        seen = []
        for _ in range(6):
            pipe.run()
            s = pipe.stats()
            seen.append((s["transfers"], s["transfer_s"], s["device_stage_s"]))
    finally:
        pipe.stop()
    assert [t for t, _, _ in seen] == [1, 1, 2, 2, 3, 3]
    for (t0, s0, _), (t1, s1, _) in zip(seen, seen[1:]):
        assert (s1 > s0) == (t1 > t0) and s1 >= s0
    assert all(0.0 < s <= d for _, s, d in seen)


@pytest.mark.parametrize("profiled_first", [False, True])
def test_a_program_built_under_the_profiler_is_the_cached_one(profiled_first):
    """The ranges stay outside the traced stage: a spec's program traced
    while the profiler records and one traced without are one cache entry,
    whichever comes first."""
    clear_program_cache()
    n = executor.EAGER_BATCHES_PER_SPEC + 1
    builds = []
    for profiled in (profiled_first, not profiled_first):
        pipe = _pipeline()
        pipe._steps_value = None  # not found by value: the stage is traced
        before = program_cache_stats()
        try:
            with profile(activities=[ProfilerActivity.CPU]) if profiled else (
                    contextlib.nullcontext()) as prof:
                for _ in range(n):
                    pipe.run()
        finally:
            pipe.stop()
        after = program_cache_stats()
        builds.append({k: after[k] - before[k] for k in ("hits", "misses", "declined")})
        if profiled:
            assert len(_ranges(prof, "accvlab.pipeline.program_build")) == 1
    assert builds == [{"hits": 0, "misses": 1, "declined": 0},
                      {"hits": 1, "misses": 0, "declined": 0}]
