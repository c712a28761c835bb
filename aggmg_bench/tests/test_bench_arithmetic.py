"""The frozen copies hold: the roofline arithmetic equals ``chip_smoke.py``'s
on the same shapes, and the busy / idle arithmetic is right on a synthetic
event list; the kernel names read as the launches were made, and the
roofline reader pairs them with the recorded launch shapes."""

import importlib.util
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from aggmg_bench import roofline, trace  # noqa: E402

LABELS = ("K1", "K2", "K3", "K5", "K5r", "K6", "K8", "K4", "K7", "K7r", "K7c", "K7cr")


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("label", LABELS)
def test_roofline_matches_chip_smoke(chip_smoke, label):
    for bs, n in chip_smoke.SHAPES + [(2, 50331648), (4, 524288)]:
        assert roofline.col_bytes(label, bs) == chip_smoke.col_bytes(label, bs)
        assert roofline.col_ops(label, bs) == chip_smoke.col_ops(label, bs)
        assert roofline.bound(label, bs, n) == chip_smoke.bound(label, bs, n)
    assert (roofline.PEAK_BPS, roofline.PEAK_FLOPS) == (chip_smoke.PEAK_BPS, chip_smoke.PEAK_FLOPS)


def test_busy_and_idle_on_synthetic_events():
    tr = trace.Trace(
        kernels=[("k_a", 0, 10), ("k_b", 5, 10), ("k_c", 40, 10)],  # union [0, 15) and [40, 50)
        copies=[("Memcpy HtoD", 60, 5)],  # [60, 65)
        host=[("aten::add", -20, 10), ("cudaLaunchKernel", 15, 30), ("aten::item", 50, 20)],
    )
    busy, span = trace.busy_and_span(tr)
    assert busy == 30 and span == 90  # the host events at -20 and to 70 bound the span
    assert trace.idle_gaps(tr) == [(15, 40), (50, 60)]
    gaps = dict(trace.gaps_by_host(tr))
    assert gaps == {"cudaLaunchKernel": 25e-9, "aten::item": 10e-9}
    assert dict(trace.device_ops(tr)) == {"k_a": 10e-9, "k_b": 10e-9, "k_c": 10e-9, "Memcpy HtoD": 5e-9}


def test_kernel_names_and_grids():
    lab = roofline.kernel_label
    assert lab("void multisweep_kernel<4, true, false>(float const*, float*)") == ("K1", 4)
    assert lab("void multisweep_kernel<2, false, false>(float const*)") == ("K2", 2)
    assert lab("void multisweep_kernel<2, false, true>(float const*)") == ("K5", 2)
    assert lab("void multisweep_kernel<2, true, true>(float const*)") == ("K5r", 2)
    assert lab("void bt_matvec_kernel<4>(float const*)") == ("K3", 4)
    assert lab("void ff_stencil_defect_kernel<2>(float const*)") == ("K6", 2)
    assert lab("void edge_pair_kernel<4, true, false>(float const*)") is None
    assert lab("void gemv2T_kernel_val<int, int, double, double>(...)") is None


def test_roofline_reader_pairs_launches_in_order():
    from types import SimpleNamespace

    spec = importlib.util.spec_from_file_location("rr", ROOT / "aggmg_bench/metrics/kernels_roofline.py")
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    k1 = "void (anonymous namespace)::multisweep_kernel<4, true, false>(float const*)"
    k3 = "void (anonymous namespace)::bt_matvec_kernel<4>(float const*)"
    kernels = [(k1, 0, 1_000_000), ("void gemv2T_kernel_val<float>(...)", 5, 7), (k3, 10, 500_000)]
    rec = SimpleNamespace(trace=trace.Trace(kernels=kernels), launches=[("K1", 4, 524288), ("K3", 4, 524288)])
    want = (roofline.bound("K1", 4, 524288)[0] + roofline.bound("K3", 4, 524288)[0]) / 1.5 * 100
    assert abs(reader.read(rec) - want) < 1e-9
    rec.launches = rec.launches[::-1]  # out of order: no reading
    assert reader.read(rec) is None
    rec.launches = rec.launches[:1]  # a launch not recorded: no reading
    assert reader.read(rec) is None
