#!/usr/bin/env python3
"""The benchmark of ``agglomerationmultigrid1d_tpu_torch`` on one NVIDIA card:
one run of one cell.

    python3 aggmg_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's problem, makes its right-hand sides from the seed, warms
up, solves for ``--seconds`` (whole solves, the window ending with the one
that crosses), judges the answers against the plain reference, and prints
one JSON line last on standard output: the end-to-end metrics with
``--trace 0``, the per-layer metrics (from solves run under the profiler
after the window) with ``--trace 1``.  The numbers compared, with their
limits, are the last lines on standard error and the ``checks`` key of the
line.  Exits non-zero, with no line, without a CUDA card (or with fewer
than the cell asks for), or when a JAX module was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "aggmg_bench_cache"  # fixed, inside the checkout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from aggmg_bench import harness

    cell = harness.resolve(a.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {cell.chips} CUDA card(s), found {n}", file=sys.stderr)
        return 2
    print(f"card: {harness.power_limit()}", file=sys.stderr, flush=True)
    out, detail = harness.run(cell, a.seed, a.seconds, bool(a.trace), device="cuda", t_start=T0)
    print(f"detail: {json.dumps(detail)}", file=sys.stderr)
    bad = harness.banned_modules()
    if bad:
        print(f"JAX modules loaded in this process: {bad}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
