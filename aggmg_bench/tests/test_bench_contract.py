"""BENCHMARK.json keeps to the benchmark contract's shapes, every cell
resolves to its files, and a configuration, a reference, a mix or a metric
added as a file (and an entry) is found with no edit to an existing
file."""

import json
import re
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from aggmg_bench import harness  # noqa: E402
sys.path.insert(0, str(Path(__file__).resolve().parent))
from bench_helpers import CELLS, SEED, SMALL  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["aggmg_bench"]
    assert BENCH["command"] == ["python3", "aggmg_bench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("aggmg_bench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(("config", c["name"]))
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        names.append(("cell", w["name"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(("metric", m["name"]))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"]) and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves(cell):
    c = harness.resolve(cell)
    assert c.builder.FORM == c.entry.FORM
    e2e = {m["name"] for m in c.end_to_end}
    assert e2e >= {"setup_s", "peak_mem_gib"} and len(e2e & {"solve_s", "solve_s.host_bound"}) == 1
    assert c.per_layer and all(hasattr(reader, "read") for _, reader in c.per_layer)
    assert all(m["moves"] in e2e for m, _ in c.per_layer)


def test_each_per_layer_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= cells
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells)), m["name"]


def test_new_files_are_found_with_no_edit(tmp_path):
    """Drop a configuration, a reference module, a mix and a per-layer metric
    into a copy of the benchmark, add their entries, and run the new cell on
    the CPU."""
    shutil.copytree(ROOT / "aggmg_bench", tmp_path / "aggmg_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / "aggmg_bench/configs/dg_slice.json").read_text())
    cfg = harness.merged(cfg, {**SMALL["dg_slice"], "name": "tiny_slice", "reference": "tiny_ref"})
    (tmp_path / "aggmg_bench/configs/tiny_slice.json").write_text(json.dumps(cfg))
    shutil.copy(ROOT / "aggmg_bench/references/dg_block_tridiag.py", tmp_path / "aggmg_bench/references/tiny_ref.py")
    mix = json.loads((ROOT / "aggmg_bench/traffic/f64.json").read_text())
    mix["rhs"]["problems"].append({"source": "sin", "left": 0.25, "right": 1.0})
    (tmp_path / "aggmg_bench/traffic/two_rhs.json").write_text(json.dumps(mix))
    (tmp_path / "aggmg_bench/metrics/traced_solves_cycles.py").write_text(
        "def read(rec):\n    return rec.traced_cycles or None\n")
    bench["configs"].append({"name": "tiny_slice", "source": "a test", "file": "aggmg_bench/configs/tiny_slice.json",
                             "reduced": ["n_elements"], "why": "a test"})
    bench["workloads"].append({"name": "tiny_slice.two_rhs", "config": "tiny_slice", "traffic": "two_rhs",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "traced_solves_cycles", "unit": "cycles", "better": "lower",
                               "source": "program_counter", "layer": "driver", "moves": "solve_s.host_bound",
                               "workloads": ["tiny_slice.two_rhs"]})
    next(m for m in bench["end_to_end"] if m["name"] == "solve_s.host_bound")["workloads"].append("tiny_slice.two_rhs")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.resolve("tiny_slice.two_rhs", tmp_path)
    assert Path(cell.reference.__file__) == tmp_path / "aggmg_bench/references/tiny_ref.py"
    out, _ = harness.run(cell, SEED, 0.2, True, device="cpu")
    assert out["correct"] and out["metrics"]["traced_solves_cycles"]["value"] > 0
    assert list(out)[-1] == "checks"
