"""One short run of each cell of the benchmark on the card (marked
``cuda``; skips without a card).  On a GPU host:

    python -m pytest -p no:cacheprovider -o addopts="" -m cuda portbench/tests
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [
    w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())[
        "workloads"]])
def test_cell_runs_correct_on_the_card(card, workload):
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
