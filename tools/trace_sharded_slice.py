#!/usr/bin/env python3
"""Trace the element-sharded DG slice solve beside the unsharded one on one
CUDA card, with ``torch.profiler``.

    PYTHONPATH=<checkout> python3 tools/trace_sharded_slice.py

Builds ``chip_smoke.py``'s 2,097,152-DoF DG slice and its float32 copy,
shards both on a one-rank NCCL group, and runs the damped
``multigrid_mixed`` solve on each after a warm-up.  Per solve it prints one
JSON line: the solve's seconds (host clock around a synchronized call,
median of 7), then from one traced solve the device's kernel launches, busy
milliseconds (the union of kernel, copy and memset intervals), the traced
span and the idle share, the host's CUDA kernel-launch calls, the number of
``aten::`` ops the host dispatched, and the most frequent of them; and from
one more untraced solve ``host_split``: how the host's time inside the solve
divides between smoothing, the matvecs' halo exchanges, the norms'
all-reduces, the gathers below the last sharded level, and the rest.  The
split is taken from here, with no span in the package: the solver module's
references to those functions are wrapped in host-clock timers for that one
solve (``[milliseconds, calls]`` per part; no synchronisation is added, so a
part's time is what the host spends inside it, enqueueing or blocked).

It imports the port from ``PYTHONPATH``, so it can trace two checkouts in
one call (a checkout whose solvers still take ``shard=`` is given
``shard=fused_shard_spec(h32)``).
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import sys
import tempfile
import time

import torch

SLICE = dict(n=524288, max_p=3, n_dg=2, n_agg=12)


def device_busy_ms(events) -> tuple:
    """(busy ms, span ms, launches) from chrome-trace events: the union of
    the device intervals, the span from the first to the last event."""
    dev = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -1.0
    for t0, t1 in dev:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    timed = [e for e in events if "ts" in e and "dur" in e]
    span = max(e["ts"] + e["dur"] for e in timed) - min(e["ts"] for e in timed)
    launches = sum(1 for e in events if e.get("cat") == "kernel")
    return busy / 1e3, span / 1e3, launches


def trace(fn, path: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    busy, span, launches = device_busy_ms(events)
    ops = collections.Counter(e["name"] for e in events
                              if e.get("cat") == "cpu_op" and e["name"].startswith("aten::"))
    runtime = sum(1 for e in events if e.get("cat") == "cuda_runtime" and "LaunchKernel" in e["name"])
    return dict(kernels=launches, busy_ms=busy, span_ms=span, idle=1.0 - busy / span,
                launch_calls=runtime, aten_ops=sum(ops.values()), top_ops=ops.most_common(12))


# the solver module's names whose host time the split reads, by part
SPLIT = {
    "smoothing": ("sharded_multisweep", "sharded_chebyshev_multisweep", "multisweep", "multisweep_residual",
                  "chebyshev_multisweep", "chebyshev_multisweep_residual"),
    "matvec_exchange": ("edge_columns", "halo_neighbours"),
    "norm_all_reduce": ("all_reduce_sum",),
    "gather": ("all_gather_cols",),
}


def host_split(solvers, fn) -> dict:
    """Run ``fn`` once with ``solvers``' references to the functions of
    ``SPLIT`` wrapped in host-clock timers; none of them calls another
    through that module, so the parts do not overlap."""
    spent, calls, saved = collections.Counter(), collections.Counter(), {}

    def timed(part, f):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            try:
                return f(*args, **kw)
            finally:
                spent[part] += time.perf_counter() - t0
                calls[part] += 1
        return wrapper

    for part, names in SPLIT.items():
        for name in names:
            if hasattr(solvers, name):
                saved[name] = getattr(solvers, name)
                setattr(solvers, name, timed(part, saved[name]))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, f in saved.items():
            setattr(solvers, name, f)
    out = {part: [1e3 * spent[part], calls[part]] for part in SPLIT}
    out["other"] = [1e3 * (host - sum(spent.values())), 0]
    return dict(host_ms=1e3 * host, wall_ms=1e3 * wall, host_split=out)


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_sharded_slice: no CUDA device", file=sys.stderr)
        return 2
    from agglomerationmultigrid1d_tpu_torch import parallel
    from agglomerationmultigrid1d_tpu_torch.models import (
        make_low_precision_hierarchy,
        multigrid_mixed,
        poisson_dg_hierarchy,
        solvers,
    )

    tree = os.path.dirname(os.path.dirname(os.path.abspath(parallel.__file__)))
    with tempfile.TemporaryDirectory() as td:
        g = parallel.initialize(0, 1, store_path=os.path.join(td, "store"))
        try:
            prob = poisson_dg_hierarchy(**SLICE, device="cuda")
            h, b = prob.hierarchy, prob.b
            h32 = make_low_precision_hierarchy(h)
            hs, h32s, bl = parallel.shard_hierarchy(h, g), parallel.shard_hierarchy(h32, g), parallel.shard_vector(b, g)
            kw = {"shard": parallel.fused_shard_spec(h32s)} if hasattr(parallel, "fused_shard_spec") else {}
            solves = {
                "unsharded": lambda: multigrid_mixed(h, h32, torch.zeros_like(b), b, 80, 1e-10),
                "sharded": lambda: multigrid_mixed(hs, h32s, torch.zeros_like(bl), bl, 80, 1e-10, **kw),
            }
            for label, fn in solves.items():
                fn()  # warm-up
                torch.cuda.synchronize()
                times = []
                for _ in range(7):
                    t0 = time.perf_counter()
                    res = fn()
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                row = dict(tree=tree, solve=label, outer=res.iterations, inner=res.inner_cycles,
                           solve_s=statistics.median(times), solve_s_all=times)
                row.update(trace(fn, os.path.join(td, f"{label}.json")))
                row.update(host_split(solvers, fn))
                print(json.dumps(row), flush=True)
        finally:
            parallel.shutdown()
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
