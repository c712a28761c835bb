"""Mixed-precision fast path on the PyTorch port: float32 V-cycles (the CUDA
kernels K1-K3 on the card) inside a float64 defect-correction loop.

Solves a DG + agglomeration hierarchy to 1e-10 relative residual:

    python examples/mixed_precision_fastpath_torch.py [--device cuda|cpu] [--n 8192]
"""

import argparse
import sys as _sys
import time
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root

import torch

from agglomerationmultigrid1d_tpu_torch.models import (
    make_low_precision_hierarchy,
    multigrid_mixed,
    poisson_dg_hierarchy,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=1 << 13, help="DG elements")
    args = ap.parse_args(argv)
    prob = poisson_dg_hierarchy(n=args.n, max_p=4, n_dg=3, n_agg=6, device=args.device)
    h32 = make_low_precision_hierarchy(prob.hierarchy)
    b = prob.b
    t0 = time.perf_counter()
    res = multigrid_mixed(prob.hierarchy, h32, torch.zeros_like(b), b, 80, 1e-10)
    if b.is_cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    it = res.iterations
    rel = float(res.res_history[it - 1]) / float(torch.linalg.vector_norm(b))
    print(f"{b.numel()} DoF: {res.inner_cycles} float32 V-cycles in {it} float64 refinement "
          f"steps, rel res {rel:.1e}, {wall:.2f}s wall")
    return {"outer": it, "inner": res.inner_cycles, "rel": rel}


if __name__ == "__main__":
    main()
