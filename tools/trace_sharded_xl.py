#!/usr/bin/env python3
"""Trace the rank-local stencil builds' solves beside the unsharded ones on
one CUDA card, with ``torch.profiler``.

    PYTHONPATH=<checkout> python3 tools/trace_sharded_xl.py

On a one-rank NCCL group it builds ``chip_smoke.py``'s sharded north star
(``build_sharded_xl_problem(..., slim_fine=True)``, 100,663,296 DoF) and its
sharded 16,777,217-DoF CG-topped flagship, each beside ``build_xl_problem``
of the same arguments, and runs ``_mixed_loop_ff`` on each (the north star
with ``chip_smoke.NS_LOOP``, the flagship damped to 1e-10 as
``chip_smoke.py`` does).  Per solve it prints one JSON line: the counts, the
solve's seconds (host clock around a synchronized call, median of 3 after a
warm-up), from one traced solve the device's kernel launches, busy
milliseconds, span and idle share (``tools/trace_sharded_slice.py``'s
reading) with the costliest kernel names, and from one more untraced solve
the host's split (``trace_sharded_slice.host_split``, with one more part:
the CG levels' sharded operations of ``parallel/cg_levels.py``, their
exchanges included).
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_sharded_xl: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import trace_sharded_slice as tss
    from trace_scattered_switch import kernel_ms
    from agglomerationmultigrid1d_tpu_torch import parallel
    from agglomerationmultigrid1d_tpu_torch.models import build_xl_problem, solvers
    from agglomerationmultigrid1d_tpu_torch.ops.df64 import FF

    tss.SPLIT["cg_levels"] = ("cg_matvec_sharded", "apply_smoother_sharded", "cgp_prolong_sharded",
                              "cgp_restrict_sharded", "seam_prolong_sharded", "seam_restrict_sharded")
    flagship = dict(maxiter=60, tol=1e-10, inner_tol=3e-5, max_inner=20)
    cases = {  # label: (spec, n, build keywords, loop keywords)
        "north star": (cs.north_star_spec(), cs.NORTH_STAR_N, dict(slim_fine=True), cs.NS_LOOP),
        "flagship": (cs.flagship_xl_spec(cs.FLAGSHIP_XL_N), cs.FLAGSHIP_XL_N,
                     dict(chebyshev=False, min_blocks_per_device=8), flagship),
    }
    with tempfile.TemporaryDirectory() as td:
        g = parallel.initialize(0, 1, store_path=os.path.join(td, "store"))
        try:
            for label, (spec, n, kw, loop) in cases.items():
                whole_kw = {k: v for k, v in kw.items() if k != "min_blocks_per_device"}
                for sharded in (False, True):
                    torch.cuda.empty_cache()
                    if sharded:
                        h, a_ff, b_ff, norm_b = parallel.build_sharded_xl_problem(spec, n, group=g, **kw)
                    else:
                        h, a_ff, b_ff, norm_b = build_xl_problem(spec, n, device="cuda", **whole_kw)
                    zero = torch.zeros_like(b_ff.hi)

                    def fn():
                        return solvers._mixed_loop_ff(h, a_ff, FF(zero, zero), b_ff, np.float32(1.0 / norm_b), **loop)

                    fn()  # warm-up
                    torch.cuda.synchronize()
                    times = []
                    for _ in range(3):
                        t0 = time.perf_counter()
                        _, outer, cycles, _ = fn()
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                    path = os.path.join(td, "trace.json")
                    row = dict(case=label, sharded=sharded, outer=outer, cycles=cycles,
                               solve_s=statistics.median(times), solve_s_all=times)
                    row.update(tss.trace(fn, path))
                    row["top_kernels_ms"] = kernel_ms(path)
                    row.update(tss.host_split(solvers, fn))
                    print(json.dumps(row), flush=True)
                    del h, a_ff, b_ff, zero
        finally:
            parallel.shutdown()
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
