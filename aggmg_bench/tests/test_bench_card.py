"""On the card: each cell, run as the driver runs it, for 10 seconds."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench_helpers import CELLS  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_ten_seconds(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "aggmg_bench/run.py", "--workload", cell, "--seed", "2147483777",
                          "--seconds", "10", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    solve = line["metrics"].get("solve_s") or line["metrics"]["solve_s.host_bound"]
    assert line["device"]["platform"] == "gpu" and solve["value"] > 0
