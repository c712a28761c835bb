"""The north-star solve on the PyTorch port: 10^8 DoF on one card, to 1e-8
relative residual.

1. **Stencil-inflated setup** (``models.stencil_setup.build_xl_problem``):
   O(n/z) host work, the hierarchy inflated on the device.
   ``slim_fine=True`` keeps only the fine diagonal (the M-form smoother
   streams carry the off-diagonals) and ``ff_levels=True`` adds the
   value-accurate operator bundle (``FFOps``).
2. **TRUE-precision solve** (``models.multigrid_true``): at this scale
   ``eps_f32 * kappa_elem(A) ~ 6``, so every operator application in the
   cycle runs from the float-float operator values (kernel K6 on the fine
   level), the coarse solve from a float64 factorization, and the outer
   defect in float64.  ``--handover`` runs the guarded float-float
   refinement instead (``solvers._mixed_loop_ff`` with ``ffops=``: float32
   V-cycles through K1/K2 or K5), which hands over to the true cycles once it
   only trickles.

Defaults to a small size; pass the element count for the real thing (needs a
card with ~20 GB free):

    python examples/xl_north_star_torch.py 50331648 [--handover] [--device cuda]
"""

import argparse
import sys as _sys
import time
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root

import numpy as np
import torch

from agglomerationmultigrid1d_tpu_torch.models import build_xl_problem, multigrid_true
from agglomerationmultigrid1d_tpu_torch.models.solvers import _mixed_loop_ff
from agglomerationmultigrid1d_tpu_torch.ops.df64 import FF
from agglomerationmultigrid1d_tpu_torch.utils.config import HierarchySpec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_el", type=int, nargs="?", default=1 << 16, help="DG p=1 elements")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--handover", action="store_true", help="solve by _mixed_loop_ff(ffops=)")
    args = ap.parse_args(argv)
    n_el, tol = args.n_el, 1e-8
    n_agg = max(int(np.ceil(np.log2(max(n_el / 12288, 4)) / 2)), 1)
    spec = HierarchySpec(cg_orders=(), dg_orders=(1,), n_agg_levels=n_agg, p_agg=1, agg_factor=4,
                         c_dir=1000.0 * n_el)

    sync = torch.cuda.synchronize if torch.device(args.device).type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    h32, ffops, b_ff, norm_b = build_xl_problem(spec, n_el, slim_fine=True, ff_levels=True, device=args.device)
    sync()
    print(f"setup: {time.perf_counter() - t0:.1f}s for {2 * n_el:.3g} DoF, {h32.n_levels} levels")

    t0 = time.perf_counter()
    if args.handover:
        zero = torch.zeros_like(b_ff.hi)
        info = {}
        _, it, cycles, hist = _mixed_loop_ff(h32, ffops.a_ffs[0], FF(zero, zero), b_ff, np.float32(1.0 / norm_b),
                                             maxiter=100, tol=tol, inner_tol=3e-5, max_inner=20, ffops=ffops,
                                             info=info)
        hist = hist[:it].astype(np.float64)
        what = (f"{info['guarded_outer']} guarded steps ({info['guarded_cycles']} float32 V-cycles, ended by "
                f"{info['ended']}), then {info['true_cycles']} true-precision cycles")
    else:
        res = multigrid_true(h32, ffops, b_ff, norm_b, maxiter=40, tol=tol)
        it, info = res.iterations, {}
        hist = res.res_history[:it].numpy() / norm_b
        what = f"{it} true-precision cycles"
    sync()
    print(f"solve: {time.perf_counter() - t0:.1f}s, {what}")
    print("relative residual history:", " ".join(f"{v:.1e}" for v in hist))
    if hist[-1] >= tol:
        raise SystemExit(f"relative residual {hist[-1]:.3e} >= {tol}")
    return {"iterations": it, "history": hist, **info}


if __name__ == "__main__":
    main()
