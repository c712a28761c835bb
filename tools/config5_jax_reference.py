#!/usr/bin/env python3
"""The JAX package's own solve of BASELINE config 5's chain, beside
``tools/config5_full_scale.py``'s: the CG-topped flagship (CG p = 8, 4, 2, 1
and agglomerated levels down to 512 blocks, ``bench.py:369-394``'s spec,
c_dir = 1000 n) built by the JAX package's ``build_xl_problem(...,
ff_levels=True)`` and solved by its ``multigrid_true`` to 1e-8, on JAX's
default device (the package sets float64 and full-precision float32
contractions itself).

    PYTHONPATH=<checkout> python3 tools/config5_jax_reference.py [--n N [N ...]] [--maxiter K]

Prints per size the setup and solve seconds (compilation included), the
cycles and their relative residuals.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from agglomerationmultigrid1d_tpu.models.solvers import multigrid_true  # noqa: E402
from agglomerationmultigrid1d_tpu.models.stencil_setup import build_xl_problem  # noqa: E402
from agglomerationmultigrid1d_tpu.utils.config import HierarchySpec  # noqa: E402


def run(n: int, maxiter: int) -> bool:
    spec = HierarchySpec(cg_orders=(8, 4, 2, 1), n_agg_levels=int(math.log2(n // 4 // 512)) + 1, p_agg=1,
                         c_dir=1000.0 * n)
    print(f"n={n} DoF={8 * n + 1} n_agg={spec.n_agg_levels} device={jax.devices()[0]}", flush=True)
    try:
        t0 = time.perf_counter()
        h, ffops, b_ff, norm_b = build_xl_problem(spec, n, chebyshev=False, ff_levels=True)
        jax.block_until_ready(b_ff)
        print(f"setup_s={time.perf_counter() - t0:.3f} levels={h.n_levels}", flush=True)
        t0 = time.perf_counter()
        res = multigrid_true(h, ffops, b_ff, norm_b, maxiter, 1e-8)
        it = int(res.iterations)
        hist = np.asarray(res.res_history)[:it] / norm_b
        print(f"solve_s={time.perf_counter() - t0:.3f} cycles={it} res_history={[f'{v:.3e}' for v in hist]}",
              flush=True)
        return True
    except Exception:
        traceback.print_exc()
        return False


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, nargs="+", default=[12582912])
    ap.add_argument("--maxiter", type=int, default=40)
    args = ap.parse_args()
    ok = [run(n, args.maxiter) for n in args.n]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
