"""``accvlab_tpu_torch.tools``: ``Stopwatch`` and ``ChromeTraceRecorder``
against the JAX package's on the cases of tests/test_tools.py and
tests/test_pipeline_trace.py that concern them: the same surface, the same
counts, the same events (timestamps aside)."""

import json
import threading
import time

import numpy as np
import pytest
import torch

import accvlab_tpu.tools as jtools
import accvlab_tpu_torch.tools as ttools
from accvlab_tpu_torch.tools import stopwatch as tstopwatch


@pytest.fixture(autouse=True)
def fresh_singletons():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    jtools.Stopwatch._reset_singleton()
    ttools.Stopwatch._reset_singleton()
    yield
    ttools.Stopwatch._reset_singleton()
    jtools.Stopwatch._reset_singleton()
    torch.set_num_threads(prev)


@pytest.mark.parametrize("tools", [jtools, ttools], ids=["jax", "torch"])
def test_stopwatch_disabled_noop_and_singleton(tools):
    sw = tools.Stopwatch()
    sw.start_meas("x")
    sw.end_meas("x")
    sw.finish_iter()
    sw.print_eval_times()
    assert not sw.is_enabled
    assert tools.Stopwatch() is sw
    assert np.isnan(sw.get_mean_time("x"))


def _drive(sw, iters=3, sleep=0.01):
    sw.enable(num_warmup_iters=1, print_every_n_iters=2)
    sw.set_cpu_usage_meas_name("cpu")
    for _ in range(iters):
        sw.start_meas("work")
        sw.start_meas("cpu")
        time.sleep(sleep)
        sw.end_meas("cpu")
        sw.end_meas("work")
        sw.finish_iter()
    sw.start_one_time_measurement("setup")
    sw.end_one_time_measurement("setup")
    sw.print_eval_times()


def test_stopwatch_measures_as_in_jax(capsys):
    j, t = jtools.Stopwatch(), ttools.Stopwatch()
    _drive(j)
    j_out = capsys.readouterr().out
    _drive(t)
    t_out = capsys.readouterr().out
    assert t.get_num_nonwarmup_iters_measured() == j.get_num_nonwarmup_iters_measured() == 2
    assert 0.005 < t.get_mean_time("work") < 0.1
    assert 0.01 < t.get_total_time("work") < 0.2
    # the same printed lines, numbers aside
    strip = lambda s: [line.split(":")[0] for line in s.splitlines()]  # noqa: E731
    assert strip(t_out) == strip(j_out)
    assert "mean CPU" in t_out and "one-time 'setup'" in t_out


def test_stopwatch_warmup_skipped_and_unmatched_end():
    for tools in (jtools, ttools):
        tools.Stopwatch._reset_singleton()
        sw = tools.Stopwatch()
        sw.enable(num_warmup_iters=2, print_every_n_iters=None)
        sw.start_meas("a")
        sw.end_meas("a")
        sw.finish_iter()
        assert np.isnan(sw.get_mean_time("a"))
        sw.finish_iter()
        with pytest.raises(AssertionError):
            sw.end_meas("never_started")
        with pytest.raises(AssertionError):
            sw.end_one_time_measurement("never_started")
        sw.disable()
        assert not sw.is_enabled


def test_stopwatch_without_psutil_says_so(monkeypatch, capsys):
    monkeypatch.setattr(tstopwatch, "_PSUTIL", False)
    sw = ttools.Stopwatch()
    _drive(sw, iters=2, sleep=0.0)
    out = capsys.readouterr().out
    assert "CPU usage not measured (psutil is not importable)" in out
    assert sw.get_num_nonwarmup_iters_measured() == 1


def test_stopwatch_device_sync_is_a_noop_on_the_cpu(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    sw = ttools.Stopwatch()
    sw.enable(num_warmup_iters=0, do_device_sync=True)
    sw.start_meas("x")
    sw.end_meas("x")
    assert calls == []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    sw.start_meas("x")
    sw.end_meas("x")
    assert len(calls) == 2  # around the measurement, as the JAX stopwatch drains its queue
    sw.enable(num_warmup_iters=0, do_cuda_sync=False)
    sw.start_meas("y")
    sw.end_meas("y")
    assert len(calls) == 2


def _recorder_events(mod):
    rec = mod.ChromeTraceRecorder(max_events=3)
    for i in range(5):
        rec.complete("x", "t", 0.0, 0.001, i=i)
    rec2 = mod.ChromeTraceRecorder()
    rec2.complete("y", "producer", rec2.t0 + 0.5, -1.0, batch=0)
    rec2.instant("epoch_end", "consumer", epoch=3)
    rec3 = mod.ChromeTraceRecorder()
    rec3.complete("z", "t", rec3.t0 - 0.1, 0.3)
    return rec, rec2, rec3


def _shape(doc):
    """Events without their clock readings."""
    out = []
    for e in doc["traceEvents"]:
        e = dict(e)
        for k in ("ts", "dur"):
            if k in e:
                e[k] = round(e[k], -4)  # 10 ms buckets: the clock differs, the value not
        if e.get("ph") == "M" and e["name"] == "process_name":
            e["args"] = {}
        out.append(e)
    return out, {k: v for k, v in doc.items() if k != "traceEvents"}


def test_recorder_events_match_jax():
    with pytest.raises(ValueError):
        ttools.ChromeTraceRecorder(max_events=0)
    for j, t in zip(_recorder_events(jtools), _recorder_events(ttools)):
        assert len(t) == len(j) and t.dropped == j.dropped
        assert _shape(t.to_dict()) == _shape(j.to_dict())
        json.loads(json.dumps(t.to_dict()))
    rec, rec2, rec3 = _recorder_events(ttools)
    assert rec.to_dict()["accvlab_dropped_events"] == 2
    (ev,) = [e for e in rec2.to_dict()["traceEvents"] if e["ph"] == "X"]
    assert ev["dur"] == 0.0 and ev["ts"] == pytest.approx(5e5, rel=0.01)
    (ev,) = [e for e in rec3.to_dict()["traceEvents"] if e["ph"] == "X"]
    assert ev["ts"] == 0.0 and ev["dur"] == pytest.approx(2e5, rel=0.01)


def test_recorder_tid_assignment_is_race_free():
    for _ in range(20):
        rec = ttools.ChromeTraceRecorder()
        barrier = threading.Barrier(2)

        def emit(name):
            barrier.wait()
            rec.complete("e", name, rec.t0, 0.001)

        ts = [threading.Thread(target=emit, args=(f"t{i}",)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert len({e["tid"] for e in rec.to_dict()["traceEvents"] if e["ph"] == "X"}) == 2


def test_recorder_save(tmp_path):
    rec = ttools.ChromeTraceRecorder()
    rec.complete("host_build", "producer", rec.t0, 0.002, batch=0)
    path = tmp_path / "t.json"
    rec.save(str(path))
    with open(path) as f:
        doc = json.load(f)
    names = {e["args"]["name"] for e in doc["traceEvents"] if e["name"] == "thread_name"}
    assert names == {"producer"}
