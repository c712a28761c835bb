"""The readers of the port's spans (``spans.py`` and its nine metrics): on a
synthetic trace each kernel goes to the phase whose span encloses its
launch call, and nothing is read where the launches and kernels do not
pair or the program opens no span; a traced run of the slice cells at a
small size on the CPU reads the host syncs and the four phases' host ms,
and the phases hold nearly all of the traced span."""

import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench_helpers import SEED, SMALL  # noqa: E402

from aggmg_bench import harness, spans, trace  # noqa: E402

PHASES = ("smooth", "transfer", "coarse", "defect")
SLICE_CELLS = ("dg_slice.mixed_damped", "dg_slice.f64")


def _reader(name):
    path = harness.reader_path(ROOT / "aggmg_bench", name)
    spec = importlib.util.spec_from_file_location(f"_reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _synthetic():
    """Two V-cycles' worth of spans: a smooth span with two launches, a
    transfer span with one, a sync between them, one launch outside every
    phase, a coarse span with one launch."""
    host = [
        ("aggmg.vcycle.f32", 0, 100),
        ("aggmg.smooth@0", 0, 30), ("aten::einsum", 2, 10), ("cudaLaunchKernel", 4, 2), ("cuLaunchKernel", 20, 2),
        ("aggmg.sync.defect", 30, 5), ("aten::_local_scalar_dense", 31, 3),
        ("aggmg.transfer@0", 40, 20), ("cudaLaunchKernelExC", 45, 2),
        ("cudaLaunchKernel", 62, 2),
        ("aggmg.coarse", 70, 20), ("cudaLaunchKernel", 75, 2),
    ]
    kernels = [("gemv", 10, 1_000_000), ("k2", 1_000_100, 2_000_000), ("restrict", 3_000_200, 3_000_000),
               ("add", 6_000_300, 500_000), ("bcr", 6_500_400, 4_000_000)]
    return SimpleNamespace(trace=trace.Trace(kernels=kernels, host=host), traced_cycles=2)


def test_kernels_go_to_the_phase_of_their_launch():
    rec = _synthetic()
    assert spans.kernel_spans(rec.trace) == ["aggmg.smooth@0"] * 2 + ["aggmg.transfer@0", None, "aggmg.coarse"]
    got = {p: _reader(f"{p}_ms_per_cycle").read(rec) for p in PHASES}
    assert got == {"smooth": 1.5, "transfer": 1.5, "coarse": 2.0, "defect": 0.0}
    assert _reader("host_syncs_per_cycle").read(rec) == 0.5
    host = {p: _reader(f"{p}_host_ms_per_cycle.host_bound").read(rec) for p in PHASES}
    assert host == {"smooth": 15e-6, "transfer": 10e-6, "coarse": 10e-6, "defect": 0.0}


def test_no_reading_without_pairs_or_spans():
    rec = _synthetic()
    rec.trace.kernels.append(("late", 9_000_000, 10))  # a kernel with no launch call: no pairing
    assert spans.kernel_spans(rec.trace) is None
    assert all(_reader(f"{p}_ms_per_cycle").read(rec) is None for p in PHASES)
    bare = _synthetic()  # a program without spans, as the parent commit
    bare.trace.host = [e for e in bare.trace.host if not e[0].startswith("aggmg.")]
    names = ["host_syncs_per_cycle.host_bound"] + [f"{p}_ms_per_cycle" for p in PHASES] + [
        f"{p}_host_ms_per_cycle.host_bound" for p in PHASES]
    assert all(_reader(n).read(bare) is None for n in names)
    assert all(_reader(n).read(SimpleNamespace(trace=None, traced_cycles=0)) is None for n in names)


@pytest.mark.parametrize("cell", SLICE_CELLS)
def test_traced_slice_reads_syncs_and_phases(cell, monkeypatch):
    kept = []
    collect = harness.tracing.collect
    monkeypatch.setattr(harness.tracing, "collect", lambda prof: kept.append(collect(prof)) or kept[-1])
    out, detail = harness.run(harness.resolve(cell), SEED, 0.2, True, device="cpu", overrides=SMALL["dg_slice"])
    assert out["correct"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["host_syncs_per_cycle.host_bound"] >= 1.0
    host = [m[f"{p}_host_ms_per_cycle.host_bound"] for p in PHASES]
    assert all(v > 0 for v in host)
    (tr,) = kept
    timed = [(t0, t0 + d) for _, t0, d in tr.host]
    span_ms = (max(t1 for _, t1 in timed) - min(t0 for t0, _ in timed)) / 1e6 / detail["traced_cycles"]
    assert sum(host) >= 0.9 * span_ms, (host, span_ms)
