#!/usr/bin/env python3
"""BASELINE config 5: the CG-topped flagship (CG p = 8, 4, 2, 1 and
agglomerated levels down to 512 blocks, ``bench.py:369-394``'s spec,
c_dir = 1000 n), built by stencil inflation with ``ff_levels=True`` and
solved by ``multigrid_true`` to 1e-8.  The default n = 12,582,912 elements
is config 5 at full scale (100,663,297 DoF); several ``--n`` run one after
another, to find the size where the solve stops converging.

    PYTHONPATH=<checkout> python3 tools/config5_full_scale.py [--n N [N ...]] [--maxiter K] [--device cuda|cpu]

Prints per size the setup seconds by phase, the solve seconds, the cycles
and their relative residuals, the relative residual recomputed in float64
from the float-float fine band (``hi + lo``) and the rhs, and on a card the
peak device memory; where a stage raises, how far it got.
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import time
import traceback

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from agglomerationmultigrid1d_tpu_torch.models import build_xl_problem, default_stencil_factor, multigrid_true  # noqa: E402
from agglomerationmultigrid1d_tpu_torch.ops.cg_operator import CgOperator, cg_matvec  # noqa: E402
from agglomerationmultigrid1d_tpu_torch.ops.df64 import ff_join  # noqa: E402
from agglomerationmultigrid1d_tpu_torch.utils.config import HierarchySpec  # noqa: E402


def flagship_spec(n: int) -> HierarchySpec:
    return HierarchySpec(cg_orders=(8, 4, 2, 1), n_agg_levels=int(math.log2(n // 4 // 512)) + 1, p_agg=1,
                         c_dir=1000.0 * n)


def run(n: int, maxiter: int, device: str) -> bool:
    cuda = device == "cuda"
    peak = (lambda: torch.cuda.max_memory_allocated()) if cuda else (lambda: "not measured")
    spec = flagship_spec(n)
    print(f"n={n} DoF={8 * n + 1} n_agg={spec.n_agg_levels} z={default_stencil_factor(spec, n)} device={device}",
          flush=True)
    stage = "setup"
    try:
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        timings = {}
        t0 = time.perf_counter()
        h, ffops, b_ff, norm_b = build_xl_problem(spec, n, chebyshev=False, ff_levels=True, device=device,
                                                  timings=timings)
        if cuda:
            torch.cuda.synchronize()
        print(f"setup_s={time.perf_counter() - t0:.3f} timings={timings} levels={h.n_levels} "
              f"coarsest={h.levels[-1].a.n_blocks} blocks peak_after_setup={peak()}", flush=True)
        stage = "solve"
        t0 = time.perf_counter()
        res = multigrid_true(h, ffops, b_ff, norm_b, maxiter, 1e-8)
        if cuda:
            torch.cuda.synchronize()
        hist = (res.res_history[: res.iterations] / norm_b).tolist()
        print(f"solve_s={time.perf_counter() - t0:.3f} cycles={res.iterations} peak_after_solve={peak()} "
              f"res_history={[f'{v:.3e}' for v in hist]}", flush=True)
        stage = "residual"
        windows, a0, x = h.levels[0].a.windows, ffops.a_ffs[0], res.x
        del h, ffops, res
        band = a0.hi.double() + a0.lo.double()
        del a0
        b64 = ff_join(b_ff)
        rel = float(torch.linalg.vector_norm(b64 - cg_matvec(CgOperator(windows=windows, band=band), x))
                    / torch.linalg.vector_norm(b64))
        print(f"rel_residual_f64={rel:.3e} peak={peak()}", flush=True)
        return True
    except Exception:
        traceback.print_exc()
        print(f"stopped in {stage}: peak={peak()}", flush=True)
        return False


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, nargs="+", default=[12582912])
    ap.add_argument("--maxiter", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("config5_full_scale: no CUDA device", file=sys.stderr)
            return 2
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
        print(smi, flush=True)
    ok = [run(n, args.maxiter, args.device) for n in args.n]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
