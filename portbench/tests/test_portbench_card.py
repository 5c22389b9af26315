"""One short run of each cell on the card, through the command that the
benchmark's checks run. Skips without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.spec import ROOT, load_json

CELLS = [w["name"] for w in load_json(f"{ROOT}/BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card_is_correct(card, name):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", name, "--seed",
                          "2147483999", "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["check"]
    assert result["device"]["platform"] == "gpu"
