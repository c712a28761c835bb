#!/usr/bin/env python3
"""Trace the scattered and mixed-switch slices' solves on one CUDA card with
``torch.profiler``.

    PYTHONPATH=<checkout> python3 tools/trace_scattered_switch.py

Builds ``chip_smoke.py``'s 2,097,152-DoF scattered chain and its
2,097,152-DoF mixed-switch chain, and per solve (scattered:
``multigrid_mixed`` damped and Chebyshev; mixed switch: float64
``multigrid``, ``multigrid_mixed``, ``multigrid_progressive``) prints one
JSON line: the counts, the solve's seconds (host clock around a synchronized
call, median of 3 after a warm-up), and from one traced solve the device's
kernel launches, busy milliseconds, the traced span and the idle share
(``tools/trace_sharded_slice.py``'s reading), the host's kernel-launch
calls and ``aten::`` ops, and the device time of the eight costliest kernel
names.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import statistics
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

SCATTERED_N, SCATTERED_COARSEST = 1048576, 1024  # chip_smoke.py's scattered slice
SWITCH_N, SWITCH_COARSEN = 524288, 6  # and its mixed-switch slice


def kernel_ms(path: str, top: int = 8) -> list:
    """[(kernel name cut to 60 characters, device ms, launches)] of the
    costliest names in a chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ms, n = collections.Counter(), collections.Counter()
    for e in events:
        if e.get("cat") == "kernel":
            name = e["name"][:60]
            ms[name] += e.get("dur", 0) / 1e3
            n[name] += 1
    return [(name, round(t, 3), n[name]) for name, t in ms.most_common(top)]


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_scattered_switch: no CUDA device", file=sys.stderr)
        return 2
    from trace_sharded_slice import trace
    from agglomerationmultigrid1d_tpu_torch.models import (
        chebyshev_hierarchy,
        interleaved_pair_groups,
        make_low_precision_hierarchy,
        multigrid,
        multigrid_mixed,
        multigrid_progressive,
        poisson_scattered_hierarchy,
        poisson_switch_hierarchy,
    )
    from agglomerationmultigrid1d_tpu_torch.utils.precision import tree_to

    prob = poisson_scattered_hierarchy(n=SCATTERED_N, p_dg=1,
                                       groups_per_level=interleaved_pair_groups(SCATTERED_N, SCATTERED_COARSEST),
                                       device="cpu")
    prob = dataclasses.replace(prob, hierarchy=tree_to(prob.hierarchy, "cuda"), b=prob.b.to("cuda"))
    h, b = prob.hierarchy, prob.b
    hc = chebyshev_hierarchy(h)
    h32, hc32 = make_low_precision_hierarchy(h), make_low_precision_hierarchy(hc)
    solves = {
        "scattered mixed damped": lambda: multigrid_mixed(h, h32, torch.zeros_like(b), b, 80, 1e-10),
        "scattered mixed chebyshev": lambda: multigrid_mixed(hc, hc32, torch.zeros_like(b), b, 80, 1e-10),
    }
    ps = poisson_switch_hierarchy(SWITCH_N, SWITCH_COARSEN, device="cuda")
    hs, bs = ps.hierarchy, ps.b
    hs32 = make_low_precision_hierarchy(hs)
    solves.update({
        "switch multigrid": lambda: multigrid(hs, torch.zeros_like(bs), bs, 100, 1e-10, compute_error=False),
        "switch mixed": lambda: multigrid_mixed(hs, hs32, torch.zeros_like(bs), bs, 80, 1e-10),
        "switch progressive": lambda: multigrid_progressive(hs, hs32, torch.zeros_like(bs), bs, 80, 1e-10),
    })
    with tempfile.TemporaryDirectory() as td:
        for label, fn in solves.items():
            fn()  # warm-up
            torch.cuda.synchronize()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                res = fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            path = os.path.join(td, "trace.json")
            row = dict(solve=label, outer=res.iterations, inner=res.inner_cycles,
                       solve_s=statistics.median(times), solve_s_all=times)
            row.update(trace(fn, path))
            row["top_kernels_ms"] = kernel_ms(path)
            print(json.dumps(row), flush=True)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
