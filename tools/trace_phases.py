"""Where a benchmark cell's V-cycles spend their time, by phase and by level,
from the port's spans (``models/solvers.py``, ``aggmg_bench/spans.py``): one
run of the cell with its traced solves (``aggmg_bench.harness.run``), then,
per V-cycle of the traced solves:

* each phase's device ms (kernels paired with their launch calls), host ms
  (union of its spans) and launches, over all levels and by ``phase@level``;
* the host reads (``aggmg.sync.*`` spans, ``aten::_local_scalar_dense``,
  ``cudaStreamSynchronize``), the launches, the spans opened;
* the device's idle seconds by the innermost ``aggmg.*`` span at each gap's
  midpoint (``outside`` where none covers it);
* how much of the kernels' device time and of the traced span the four
  phases hold, and the time of the traced solves;
* the block-contraction kernels' launches over the run (every contraction
  on the card launches one; a block size without an instance raises);
* kernel K12's (``ff_bt_defect_kernel``, the float-float defect of a
  materialised operator) and kernel K14's (``ff_cheb_update_kernel``, a
  true Chebyshev step's apply and float-float update) launches and device
  ms per V-cycle, in all and by level and by ``phase@level``, and their
  launches over the run;
* on a CG-topped cell, the split by CG level (``aggmg.cg@k`` spans): per
  V-cycle, each CG level's device ms and launches (kernels paired with their
  launch calls), its device-to-device copies (copies paired with their
  ``cudaMemcpy*`` calls) and their device ms, and kernel K13's
  (``ff_cg_defect_kernel``, the float-float defect of a CG band) launches
  and device ms there; K13's launches per V-cycle in all and over the run;
* on a scattered cell, the same split by block-COO level (``aggmg.bcoo@k``
  spans, ``bcoo_levels``);
* on a Schwarz-smoothed CG cell, the same split of the Schwarz window
  applies by CG level (``aggmg.schwarz@k`` spans, ``schwarz_levels``), and
  the count of those spans per V-cycle by level (``schwarz_applies``).

    PYTHONPATH=. python3 tools/trace_phases.py --cell dg_slice.mixed_damped \\
        [--seed N] [--seconds S] [--program DIR] [--out FILE]

``--program DIR`` runs the port package of another checkout under this
checkout's benchmark (a program without spans reads only the counts).  One
JSON object is printed, and written to ``--out`` too.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
K12 = "ff_bt_defect_kernel"
K13 = "ff_cg_defect_kernel"
K14 = "ff_cheb_update_kernel"
OWN = {"k12": K12, "k14": K14}  # the kernels split by phase@level
CG = "aggmg.cg@"
BCOO = "aggmg.bcoo@"
SCHWARZ = "aggmg.schwarz@"
MEMCPY_CALLS = frozenset({"cudaMemcpyAsync", "cudaMemcpy", "cudaMemcpy2DAsync", "cudaMemcpyPeerAsync"})


def cg_levels(tr, per: float, prefix: str = CG) -> dict | None:
    """Per V-cycle and level of a family (``cg@k``, or ``bcoo@k`` /
    ``schwarz@k`` with ``prefix=BCOO`` / ``SCHWARZ``): device ms and launches of the kernels launched inside
    the level's spans, K13's among them, and the device-to-device copies
    issued there.  The i-th launch call (memcpy call) made the i-th kernel
    (copy), both sorted by start, as ``aggmg_bench.spans`` pairs them; a
    side that does not pair one to one reads None.  None without such
    spans."""
    from aggmg_bench import spans

    cg = sorted((t0, t0 + d, name[len("aggmg."):]) for name, t0, d in tr.host if name.startswith(prefix))
    if not cg:
        return None
    starts = [c[0] for c in cg]

    def level(t):  # the CG spans never nest: only the latest one started can enclose t
        i = bisect.bisect_right(starts, t) - 1
        return cg[i][2] if i >= 0 and cg[i][1] >= t else None

    def paired(calls, events):
        calls = sorted(t0 for name, t0, _ in tr.host if name in calls)
        events = sorted(events, key=lambda e: e[1])
        return zip(calls, events) if len(calls) == len(events) else None

    names = sorted({c[2] for c in cg}, key=lambda n: int(n.rsplit("@", 1)[1]))
    out = {n: collections.Counter() for n in names}
    kernels = paired(spans.LAUNCH_CALLS, tr.kernels)
    copies = paired(MEMCPY_CALLS, [c for c in tr.copies if c[0].startswith("Memcpy")])
    for t, (name, _, d) in kernels or ():
        lv = level(t)
        if lv:
            out[lv].update(device_ns=d, launches=1, **({"k13_ns": d, "k13_launches": 1} if K13 in name else {}))
    for t, (name, _, d) in copies or ():
        lv = level(t)
        if lv and "DtoD" in name:
            out[lv].update(dtod_ns=d, dtod_copies=1)

    def fmt(c):
        kern = {"device_ms": c["device_ns"] / 1e6 * per, "launches": c["launches"] * per,
                "k13_ms": c["k13_ns"] / 1e6 * per, "k13_launches": c["k13_launches"] * per}
        copy = {"dtod_copies": c["dtod_copies"] * per, "dtod_ms": c["dtod_ns"] / 1e6 * per}
        return {**(dict.fromkeys(kern) if kernels is None else kern),
                **(dict.fromkeys(copy) if copies is None else copy)}

    return {n: fmt(c) for n, c in out.items()}


def analyse(tr, cycles: int) -> dict:
    from aggmg_bench import spans, trace

    per = 1.0 / cycles
    kernels = sorted(tr.kernels, key=lambda k: k[1])
    counts = collections.Counter(name for name, _, _ in tr.host)
    out = {
        "traced_cycles": cycles,
        "kernels_per_cycle": len(kernels) * per,
        "launch_calls_per_cycle": {n: counts[n] * per for n in sorted(spans.LAUNCH_CALLS) if counts[n]},
        "local_scalar_dense_per_cycle": counts["aten::_local_scalar_dense"] * per,
        "stream_syncs_per_cycle": counts["cudaStreamSynchronize"] * per,
        "aggmg_syncs_per_cycle": sum(c for n, c in counts.items() if n.startswith("aggmg.sync.")) * per,
        "aggmg_vcycle_spans": sum(c for n, c in counts.items() if n.startswith("aggmg.vcycle.")),
        "aggmg_spans_per_cycle": sum(c for n, c in counts.items() if n.startswith("aggmg.")) * per,
        "aggmg_device_events": sum(name.startswith("aggmg.") for name, _, _ in tr.kernels + tr.copies),
        **{key: {"launches_per_cycle": sum(k in name for name, _, _ in kernels) * per,
                 "device_ms_per_cycle": sum(d for name, _, d in kernels if k in name) / 1e6 * per}
           for key, k in OWN.items()},
        "k13": {"launches_per_cycle": sum(K13 in name for name, _, _ in kernels) * per,
                "device_ms_per_cycle": sum(d for name, _, d in kernels if K13 in name) / 1e6 * per},
        "cg_levels": cg_levels(tr, per),
        "bcoo_levels": cg_levels(tr, per, BCOO),
        "schwarz_levels": cg_levels(tr, per, SCHWARZ),
        "schwarz_applies": {n[len("aggmg."):]: c * per for n, c in sorted(counts.items()) if n.startswith(SCHWARZ)},
    }
    if not any(n.startswith("aggmg.") for n in counts):
        return out
    by_span = collections.defaultdict(lambda: [0, 0, 0])  # device ns, host ns, launches
    labels = spans.kernel_spans(tr)
    own = {key: collections.defaultdict(lambda: [0, 0]) for key in OWN}  # device ns, launches, by phase span
    if labels is not None:
        for (name, _, d), label in zip(kernels, labels):
            by_span[label or "outside"][0] += d
            by_span[label or "outside"][2] += 1
            for key, k in OWN.items():
                if k in name:
                    own[key][label or "outside"][0] += d
                    own[key][label or "outside"][1] += 1
    for name, t0, d in tr.host:  # phase spans never nest: a level's host time is the sum of its spans
        if spans.phase(name):
            by_span[name][1] += d
    phases = collections.defaultdict(lambda: [0, 0, 0])
    for name, v in by_span.items():
        p = spans.phase(name) or "outside"
        phases[p] = [a + b for a, b in zip(phases[p], v)]
    fmt = lambda v: {"device_ms": v[0] / 1e6 * per, "host_ms": v[1] / 1e6 * per, "launches": v[2] * per}  # noqa: E731
    out["paired"] = labels is not None
    out["phases"] = {p: fmt(v) for p, v in sorted(phases.items())}
    out["levels"] = {n: fmt(v) for n, v in sorted(by_span.items(), key=lambda kv: -kv[1][0] - kv[1][1])}
    own_fmt = lambda v: {"device_ms": v[0] / 1e6 * per, "launches": v[1] * per}  # noqa: E731
    for key, spans_ in own.items():
        by_level = collections.defaultdict(lambda: [0, 0])
        for label, (ns, launches) in spans_.items():
            level = by_level[label.rsplit("@", 1)[-1]]
            level[0] += ns
            level[1] += launches
        out[key]["by_level"] = {lv: own_fmt(v) for lv, v in sorted(by_level.items())}
        out[key]["by_span"] = {n: own_fmt(v) for n, v in sorted(spans_.items())}
    out["sync_host_ms_per_cycle"] = sum(d for n, _, d in tr.host if n.startswith("aggmg.sync.")) / 1e6 * per
    kernel_ms = sum(d for _, _, d in kernels) / 1e6 * per
    timed = [(t0, t0 + d) for _, t0, d in tr.kernels + tr.copies + tr.host]
    span_ms = (max(t1 for _, t1 in timed) - min(t0 for t0, _ in timed)) / 1e6 * per
    four = [out["phases"].get(p, fmt([0, 0, 0])) for p in spans.PHASES]
    out["coverage"] = {
        "kernel_ms_per_cycle": kernel_ms,
        "phases_device_share": sum(v["device_ms"] for v in four) / kernel_ms if kernel_ms else None,
        "traced_span_ms_per_cycle": span_ms,
        "phases_host_share": sum(v["host_ms"] for v in four) / span_ms,
    }
    marked = trace.Trace(kernels=tr.kernels, copies=tr.copies,
                         host=[e for e in tr.host if e[0].startswith("aggmg.")])
    out["idle_gaps_by_span"] = [[("outside" if n == "host between operators" else n), s]
                                for n, s in trace.gaps_by_host(marked, top=15)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 7)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--program", default=None, help="checkout whose port package runs")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.profiler

    from aggmg_bench import harness  # this checkout's benchmark, imported before --program's path

    if a.program:
        sys.path.insert(0, str(Path(a.program).resolve()))
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    kept, clock = [], {}
    collect = harness.tracing.collect
    harness.tracing.collect = lambda prof: kept.append(collect(prof)) or kept[-1]

    class Timed(torch.profiler.profile):  # the traced solves' wall time, the profiler's start and stop left out
        def __enter__(self):
            r = super().__enter__()
            clock["t0"] = time.perf_counter()
            return r

        def __exit__(self, *exc):
            clock["t1"] = time.perf_counter()
            return super().__exit__(*exc)

    torch.profiler.profile = Timed
    out, detail = harness.run(harness.resolve(a.cell, ROOT), a.seed, a.seconds, True, device="cuda")
    import agglomerationmultigrid1d_tpu_torch as port
    from agglomerationmultigrid1d_tpu_torch.ops.kernels import block_kernels as bk

    res = {"cell": a.cell, "card": harness.power_limit(), "program": str(Path(port.__file__).parent.parent),
           "correct": out["correct"], "solve_median_s": detail["solve_min_median_max_s"][1],
           "traced_solves_s": clock["t1"] - clock["t0"], "metrics": {k: v["value"] for k, v in out["metrics"].items()},
           "breakdown": out.get("breakdown"),
           "contraction_launches": {k: bk.LAUNCHES.get(k) for k in ("bd_gemv", "bp_prolong_gemv", "bp_restrict_gemv")},
           "k12_launches": bk.LAUNCHES.get("ff_bt_defect"),
           "k13_launches": bk.LAUNCHES.get("ff_cg_defect"),
           "k14_launches": bk.LAUNCHES.get("ff_cheb_update"),
           **analyse(kept[0], detail["traced_cycles"])}
    text = json.dumps(res)
    print(text, flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
