"""What a run measures, found by name from ``BENCHMARK.json``.

A cell (``workloads[i]``) names a configuration and a traffic mix. The
configuration's file is the one ``BENCHMARK.json`` gives, and it names the
network's family (``families/<family>.py``, see ``families``); the traffic
mix is ``traffic/<traffic>.json``; each per-layer metric is read by
``metrics/<name>.py``. Adding a network, a configuration, a mix or a metric
adds files and entries here, and edits no code.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass
from types import ModuleType
from typing import Callable, Dict, List, Optional

from . import families

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic
    mix, the metrics it reports and its network's family module."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable]
    family: ModuleType


def metric_applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def names(kind: str, bench_dir: str = HERE) -> List[str]:
    """The modules of ``<bench_dir>/<kind>/``, by name."""
    return sorted(f[:-3] for f in os.listdir(os.path.join(bench_dir, kind))
                  if f.endswith(".py") and not f.startswith("_"))


def load_file(kind: str, name: str, bench_dir: str = HERE) -> ModuleType:
    """``<bench_dir>/<kind>/<name>.py`` as a module; ``KeyError`` naming
    the modules there when it has none."""
    if name not in names(kind, bench_dir):
        raise KeyError(f"no {kind} module {name!r} (has {names(kind, bench_dir)})")
    path = os.path.join(bench_dir, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # dataclasses look their module up there
    spec.loader.exec_module(module)
    return module


def load_reader(name: str, bench_dir: str = HERE) -> Callable:
    """``metrics/<name>.py``'s ``read(ctx)``."""
    return load_file("metrics", name, bench_dir).read


def load_family(name: Optional[str], bench_dir: str = HERE) -> ModuleType:
    """``families/<name>.py``, ``families.DEFAULT``'s for ``None``."""
    return load_file("families", name or families.DEFAULT, bench_dir)


def load_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json``, its files under
    ``<root>/portbench``; ``KeyError`` when there is none."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (has {sorted(cells)})")
    return build_cell(bench, cells[workload], root)


def build_cell(bench: dict, w: dict, root: str = ROOT) -> Cell:
    """The cell of workload entry ``w`` under the entries of ``bench``."""
    workload = w["name"]
    bench_dir = os.path.join(root, "portbench")
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if metric_applies(m, workload)]
    per_layer = [m for m in bench["per_layer"] if metric_applies(m, workload)]
    readers = {m["name"]: load_reader(m["name"], bench_dir) for m in per_layer}
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer, readers,
                load_family(config.get("family"), bench_dir))
