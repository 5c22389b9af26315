"""The readers of the program's phases (``portbench/phases.py`` and its six
metrics) on synthetic spans, on a program that opens no range, and on the
tiny cell on the CPU."""

from __future__ import annotations

import pytest
import torch

from portbench import phases
from portbench import trace as tracing
from portbench.spec import load_reader
from portbench.tests.tiny import SEED, tiny_cell

#: the cell's per-layer metrics that read the program's spans and counters
READERS = ("dispatch_ms.frames", "transfer_host_ms.frames", "stage_device_ms.frames",
           "loss_device_ms.centernet", "optimizer_device_ms.centernet", "host_blocked_ms")
#: the cell's others that read the window's counters, which the phases take too
WINDOW_COUNTERS = ("input_wait_ms.frames", "host_busy_ms.frames", "program_builds")


def _ctx():
    ranges = [
        {"name": "pipeline.device_dispatch", "start": 0.000, "dur": 0.010, "args": {"batch": 7},
         "device_s": 0.0060},
        {"name": "pipeline.transfer", "start": 0.001, "dur": 0.004, "args": {"batch": 7},
         "device_s": 0.0010},
        {"name": "pipeline.stage", "start": 0.006, "dur": 0.003, "args": {"batch": 7},
         "device_s": 0.0050},
        {"name": "pipeline.device_dispatch", "start": 0.100, "dur": 0.010, "args": {"batch": 8},
         "device_s": 0.0070},
        {"name": "pipeline.stage", "start": 0.106, "dur": 0.003, "args": {"batch": 8},
         "device_s": 0.0070},
        {"name": "train_step.loss", "start": 0.020, "dur": 0.002, "args": {}, "device_s": 0.004},
        {"name": "train_step.loss", "start": 0.120, "dur": 0.002, "args": {}, "device_s": 0.006},
        {"name": "train_step.optimizer", "start": 0.030, "dur": 0.001, "args": {},
         "device_s": 0.0},
        {"name": "train_step.optimizer", "start": 0.040, "dur": 0.002, "args": {},
         "device_s": 0.003},
        {"name": "train_step.optimizer", "start": 0.140, "dur": 0.002, "args": {},
         "device_s": 0.005},
    ]
    blocking = [{"name": "cudaStreamSynchronize", "start": 0.002, "dur": 0.003,
                 "range": "pipeline.transfer"},
                {"name": "cudaFree", "start": 0.050, "dur": 0.001, "range": "train_step"},
                {"name": "cudaDeviceSynchronize", "start": 0.190, "dur": 0.080, "range": "window"},
                {"name": "cudaDeviceSynchronize", "start": 0.300, "dur": 0.010, "range": None}]
    return {"steps": 2,
            "pipeline_unprofiled": {"consumed": 4, "device_stage_s": 0.040, "transfers": 2,
                                    "transfer_s": 0.010},
            "spans": {"steps": 2, "ranges": ranges, "blocking": blocking}}


@pytest.mark.parametrize("name,want", [
    ("dispatch_ms.frames", 10.0),
    ("transfer_host_ms.frames", 5.0),
    ("stage_device_ms.frames", 6.0),
    ("loss_device_ms.centernet", 5.0),
    ("optimizer_device_ms.centernet", 4.0),
    ("host_blocked_ms", 2.0),
])
def test_each_reader_on_synthetic_spans(name, want):
    assert load_reader(name)(_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_ranges_or_the_counter_reads_nothing(name):
    """What a program that opens no range and counts no ``transfer_s`` gives:
    the readers of them return ``None``; none raises."""
    ctx = _ctx()
    ctx["pipeline_unprofiled"] = {k: v for k, v in ctx["pipeline_unprofiled"].items()
                                  if k != "transfer_s"}
    ctx["spans"]["ranges"] = []
    ctx["spans"]["blocking"] = []
    got = load_reader(name)(ctx)
    assert got == {"dispatch_ms.frames": 10.0, "host_blocked_ms": 0.0}.get(name)
    assert load_reader(name)({"pipeline_unprofiled": {"consumed": 0}}) is None


def test_gaps_take_the_innermost_program_range_and_keep_their_lengths():
    device = [("k", 0.000, 0.010), ("k", 0.020, 0.010), ("k", 0.050, 0.010), ("k", 0.090, 0.005)]
    host = [("window", 0.0, 0.1), ("feed", 0.005, 0.030), ("train_step", 0.035, 0.030)]
    ranges = [{"name": "pipeline.device_dispatch", "start": 0.008, "dur": 0.020},
              {"name": "pipeline.transfer", "start": 0.009, "dur": 0.005}]
    old = tracing.summarize(device, host, 0.0, 0.1)["idle_gaps"]
    new = tracing.summarize(device, host, 0.0, 0.1, ranges)["idle_gaps"]
    assert [g[1] for g in new] == [g[1] for g in old]
    # a gap takes the range open at its start: the transfer inside the
    # dispatch inside the feed; the feed alone once the dispatch closed
    assert dict((round(g[1], 6), g[0]) for g in new) == {
        0.03: "train_step", 0.02: "feed", 0.01: "pipeline.transfer", 0.005: "outside_steps"}
    assert dict((round(g[1], 6), g[0]) for g in old)[0.01] == "feed"


def test_blocking_names_and_innermost():
    assert phases.blocking_name("cudaStreamSynchronize") == "cudaStreamSynchronize"
    assert phases.blocking_name("cudaMemcpy_v2") == "cudaMemcpy"
    assert phases.blocking_name("cudaMemcpyAsync") is None
    assert phases.blocking_name("cudaLaunchKernel") is None
    assert tracing.innermost([("a", 0.0, 1.0), ("b", 0.2, 0.1)], 0.25) == "b"
    assert tracing.innermost([("a", 0.0, 1.0)], 1.0) is None


def test_the_phases_run_on_the_tiny_cell():
    """The whole run on the CPU: every consumer and step range of the
    profiled stretch is read, none lands among the device rows."""
    cell = tiny_cell("centernet_6cam.fed_frames")
    line = phases.run_phases(cell, SEED, torch.device("cpu"), 1)
    n = int(cell.traffic["breakdown_steps"])
    assert line["range_counts"] == {
        "batch_to_train_inputs": n, "pipeline.consumer_wait": n, "pipeline.device_dispatch": n,
        "pipeline.draws": n, "pipeline.stage": n, "pipeline.transfer": n,
        "train_step.backward": n, "train_step.forward": n, "train_step.loss": n,
        "train_step.optimizer": 2 * n}
    assert line["device_rows_named_accvlab"] == 0
    assert set(line["readings"]) == set(READERS + WINDOW_COUNTERS)
    assert line["readings"]["transfer_host_ms.frames"] <= line["readings"]["dispatch_ms.frames"]
    assert len(line["untraced_ms_per_step"]) == 2 and line["traced_ms_per_step"] > 0
