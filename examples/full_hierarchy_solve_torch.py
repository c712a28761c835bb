"""The flagship multilevel solve (mirrors tests/full_heirarchy_test.jl), on
the PyTorch port.

4 CG levels (p = 8, 4, 2, 1) + log2(n) - 1 agglomerated levels over a mesh-size
sweep, float64 ``multigrid`` to 1e-10; prints the V-cycle count per n, the
h-independence study:

    python examples/full_hierarchy_solve_torch.py [--device cuda|cpu] [--n 8 16 ... 512]
"""

import argparse
import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root

import torch

from agglomerationmultigrid1d_tpu_torch.models import multigrid, poisson_full_hierarchy


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, nargs="+", default=[2**k for k in range(3, 10)], help="element counts")
    args = ap.parse_args(argv)
    out = {}
    for n in args.n:
        prob = poisson_full_hierarchy(n=n, device=args.device)
        res = multigrid(prob.hierarchy, torch.zeros_like(prob.b), prob.b, 100, 1e-10)
        it = res.iterations
        out[n] = it
        print(f"n={n:4d}: {it} V-cycles (final res {float(res.res_history[it - 1]):.2e})")
    return {"cycles": out}


if __name__ == "__main__":
    main()
