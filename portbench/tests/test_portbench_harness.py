"""The harness without a card: data-driven lookup, the result line, the
faults and the control coming out not correct, and what it imports."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import run
from portbench.spec import ROOT, load_cell, load_family
from portbench.tests.tiny import CELLS, SEED, tiny_cell

CPU = torch.device("cpu")
#: the numbers of which each planted fault has to push one over its limit
FAULT_NUMBERS = {"frozen": ("grad_median_gap", "update_gap"), "half_batch": ("first_loss_gap", "grad_median_gap"),
                 "altered_image": ("image_off_share",), "altered_heatmap": ("heatmap_max_diff",),
                 "altered_target": ("targets_off",)}


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = json.load(open(os.path.join(ROOT, bench["configs"][0]["file"])))
    cfg["head_conv"] = 32
    (tmp_path / "portbench/configs/narrow.json").write_text(json.dumps(cfg))
    (tmp_path / "portbench/traffic/slow_feed.json").write_text(json.dumps(
        {**json.load(open(os.path.join(ROOT, "portbench/traffic/fed_frames.json"))),
         "num_threads": 2}))
    (tmp_path / "portbench/metrics/steps_seen.py").write_text(
        "def read(ctx):\n    return float(ctx['steps'])\n")
    bench["configs"].append({**bench["configs"][0], "name": "narrow",
                             "file": "portbench/configs/narrow.json"})
    bench["workloads"].append({"name": "narrow.slow_feed", "config": "narrow",
                               "traffic": "slow_feed", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "executor",
                               "moves": "train_step_ms", "workloads": ["narrow.slow_feed"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("narrow.slow_feed", root=str(tmp_path))
    assert cell.config["head_conv"] == 32 and cell.traffic["num_threads"] == 2
    assert cell.readers["steps_seen"]({"steps": 7}) == 7.0
    assert "steps_seen" not in load_cell("centernet_6cam.fed_frames", root=str(tmp_path)).readers


def test_a_second_family_is_taken_by_files_alone(tmp_path):
    """A network that is not CenterNet's (``tests/toy``), with its own plain
    reference, operation count and a step that carries state, added to a
    copy of the benchmark as new files and entries only: the cell is found
    by name, a run on the CPU is correct, and a step that drops its state
    is not."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(os.path.join(ROOT, "portbench"), bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    toy = os.path.join(ROOT, "portbench", "tests", "toy")
    for src, dst in (("family.py", "families/toy.py"), ("reference.py", "reference/toy.py"),
                     ("toy_2cam.json", "configs/toy_2cam.json")):
        assert not (bench_dir / dst).exists()
        shutil.copy(os.path.join(toy, src), bench_dir / dst)
    traffic = json.load(open(os.path.join(ROOT, "portbench/traffic/fed_frames.json")))
    (bench_dir / "traffic/toy_frames.json").write_text(json.dumps({**traffic, "num_threads": 2}))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["configs"].append({"name": "toy_2cam", "source": "a test", "reduced": [],
                             "file": "portbench/configs/toy_2cam.json", "why": "a test"})
    bench["workloads"].append({"name": "toy_2cam.toy_frames", "config": "toy_2cam",
                               "traffic": "toy_frames", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = tiny_cell("toy_2cam.toy_frames", root=str(tmp_path))
    assert cell.family.FAULTS == ("stateless",) and cell.config["family"] == "toy"
    res, _ = run.run_cell(cell, SEED, 0.2, False, CPU, time.perf_counter())
    assert res["correct"] is True, res["check"]
    res, _ = run.run_cell(tiny_cell("toy_2cam.toy_frames", root=str(tmp_path)), SEED, 0.2, False,
                          CPU, time.perf_counter(), fault="stateless")
    assert res["correct"] is False
    assert res["check"]["loss_gap"][0] > res["check"]["loss_gap"][1]
    assert res["check"]["first_loss_gap"][0] <= res["check"]["first_loss_gap"][1]
    assert all(p.read_bytes() == b for p, b in before.items())


def test_an_unknown_family_is_refused_with_the_families_there():
    with pytest.raises(KeyError, match=r"no families module 'detr'.*'centernet'"):
        load_family("detr")
    assert load_family(None).FAULTS == load_family("centernet").FAULTS


def test_a_traced_run_reads_the_program_spans_and_counters():
    """The host-traced stretch's ranges (``ctx["spans"]``) and the
    executor's counters reach the readers of the cell that read them."""
    cell = tiny_cell("centernet_6cam.fed_frames")
    res, _ = run.run_cell(cell, SEED, 0.5, True, CPU, time.perf_counter())
    assert {"dispatch_ms.frames", "transfer_host_ms.frames", "stage_device_ms.frames",
            "loss_device_ms.centernet", "optimizer_device_ms.centernet",
            "host_blocked_ms"} <= set(res["metrics"])
    assert (res["metrics"]["transfer_host_ms.frames"]["value"]
            <= res["metrics"]["dispatch_ms.frames"]["value"])


def test_the_counters_after_the_profiled_stretches_are_read_apart():
    """A traced run takes the program's counters over the window and, apart,
    from the profiled stretches' close to the window's: the readers of the
    latter see only the steps after the profiler; an untraced run takes no
    such snapshot."""
    cell = tiny_cell("centernet_6cam.fed_frames")
    seen = {}
    read = cell.readers["dispatch_ms.frames"]
    cell.readers["dispatch_ms.frames"] = lambda ctx: seen.update(ctx) or read(ctx)
    res, _ = run.run_cell(cell, SEED, 1.0, True, CPU, time.perf_counter())
    profiled = int(cell.traffic["breakdown_steps"]) + int(cell.traffic["profile_steps"])
    assert seen["pipeline_unprofiled"]["consumed"] == res["attempted"] - profiled > 0
    assert seen["pipeline"]["consumed"] == res["attempted"]
    assert 0 < seen["pipeline_unprofiled"]["device_stage_s"] < seen["pipeline"]["device_stage_s"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_has_the_contract_keys(trace):
    cell = tiny_cell("centernet_6cam.fed_frames")
    res, notes = run.run_cell(cell, SEED, 0.5, trace, CPU, time.perf_counter())
    assert notes["forbidden"] == [] and notes["worst"]
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res) == keys + (["breakdown"] if trace else []) + ["check"]
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, (value, limit) in res["check"].items():
        assert isinstance(value, float) and isinstance(limit, (int, float)), name
    shown = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(res["metrics"]) <= shown
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_comes_out_correct(name):
    res, _ = run.run_cell(tiny_cell(name), SEED, 0.2, False, CPU, time.perf_counter())
    assert res["correct"] is True, res["check"]


@pytest.mark.parametrize("fault", sorted(FAULT_NUMBERS))
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_comes_out_not_correct(name, fault):
    cell = tiny_cell(name)
    res, _ = run.run_cell(cell, SEED, 0.2, False, CPU, time.perf_counter(), fault=fault)
    assert any(res["check"][k][0] > res["check"][k][1] for k in FAULT_NUMBERS[fault]
               if k in res["check"])
    assert res["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_the_control_comes_out_not_correct(name):
    res, _ = run.control(tiny_cell(name), SEED, CPU)
    assert res["correct"] is False
    assert any(v > lim for v, lim in res["check"].values())


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    base = os.path.join(ROOT, "portbench", sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "accvlab_tpu"}, path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "accvlab_tpu_torch" not in tops, path
    code = ("import sys; import portbench.reference.pipeline, portbench.reference.centernet, "
            "portbench.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'accvlab_tpu_torch', 'accvlab_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_jax():
    code = ("import sys, time, torch; from portbench import run; "
            "from portbench.tests.tiny import tiny_cell, SEED; "
            "_, n = run.run_cell(tiny_cell('centernet_6cam.fed_frames'), SEED, 0.2, False, "
            "torch.device('cpu'), time.perf_counter()); "
            "print(sorted(set(n['forbidden']) | set(run.forbidden_modules())))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_run_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "centernet_6cam.fed_frames",
                          "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_the_harness_weights_load_into_the_program():
    for name in CELLS:
        cell = tiny_cell(name)
        leaves = {n: torch.zeros(s) for n, s, _ in cell.family.leaf_specs(cell.config)}
        cell.family.Step(cell.config, leaves, CPU, None).close()
