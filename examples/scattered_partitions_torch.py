"""Non-contiguous (scattered) agglomeration partitions end to end, on the
PyTorch port.

Mirrors the reference's arbitrary-partition constructor
``AgglomeratedDgMesh1(mP, agg::Vector{Vector{Int64}}, mesh, baseMesh)``
(``src/agglomerated_dg_mesh.jl:400-495``): agglomerates own arbitrary sets of
base elements.  Builds a DG p=1 Poisson problem, coarsens it three ways
(contiguous runs of 8; two runs 4 elements apart; two runs half a domain
apart), solves each two-level hierarchy with the V-cycle and compares it
with the dense direct solution:

    python examples/scattered_partitions_torch.py [--device cuda|cpu] [--n 256]
"""

import argparse
import math
import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root

import numpy as np
import torch

from agglomerationmultigrid1d_tpu_torch.assembly import dg_flux_operators, dg_flux_rhs
from agglomerationmultigrid1d_tpu_torch.mesh import (
    BoundaryCondition,
    create_uniform_mesh,
    make_agg_mesh,
    make_dg_mesh,
    make_scattered_agg_mesh,
)
from agglomerationmultigrid1d_tpu_torch.models import build_dg_hierarchy, multigrid, schur_stiffness
from agglomerationmultigrid1d_tpu_torch.ops import bd_matvec, bt_matvec, bt_to_dense
from agglomerationmultigrid1d_tpu_torch.utils import tree_to


def local_interleave_groups(n: int):
    """Per 16-element block, two interleaved agglomerates of two 4-runs:
    A = {0-3, 8-11}, B = {4-7, 12-15} (relative)."""
    groups = []
    for o in range(0, n, 16):
        groups.append([o + i for i in (0, 1, 2, 3, 8, 9, 10, 11)])
        groups.append([o + i for i in (4, 5, 6, 7, 12, 13, 14, 15)])
    return groups


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=256, help="DG p=1 elements, a multiple of 16")
    args = ap.parse_args(argv)
    n = args.n
    mesh = create_uniform_mesh(n, 0.0, 1.0)
    dg = make_dg_mesh(mesh, 1)
    bc = BoundaryCondition(("dir", 0.0), ("dir", 0.0))
    c_dir = 10.0 * n
    g, d, c = dg_flux_operators(dg, bc, c_dir)
    a = schur_stiffness(g, d, c, dg.mass_inv)
    f, r = dg_flux_rhs(dg, lambda x: torch.sin(2.0 * math.pi * x) * (2.0 * math.pi) ** 2, bc, c_dir)
    b = (f - bt_matvec(d, bd_matvec(dg.mass_inv, r))).to(args.device)

    # three two-level hierarchies, coarse level = n/8 agglomerates of 8: the
    # further the runs of an agglomerate spread, the weaker its coarse space
    # approximates and the slower the V-cycle contracts
    half = n // 2
    far = [list(range(4 * i, 4 * i + 4)) + list(range(half + 4 * i, half + 4 * i + 4)) for i in range(half // 4)]
    x_dense = torch.linalg.solve(bt_to_dense(a).to(args.device), b.T.reshape(-1))
    out = {}
    for name, cmesh in (
        ("contiguous runs of 8", make_agg_mesh(1, mesh, r_base=8, tables=False)),
        ("2 runs, 4 elements apart", make_scattered_agg_mesh(1, mesh, local_interleave_groups(n))),
        ("2 runs, half a domain apart", make_scattered_agg_mesh(1, mesh, far)),
    ):
        h = tree_to(build_dg_hierarchy([dg, cmesh], a, g, d, c), args.device)
        res = multigrid(h, torch.zeros_like(b), b, 300, 1e-10, compute_error=False)
        it = res.iterations
        err = float((res.x.T.reshape(-1) - x_dense).abs().max())
        rr = float(res.res_history[it - 1])
        note = "" if rr < 1e-9 else "  <- stalled: coarse basis spans half the domain"
        print(f"{name:30s}: {it:3d} V-cycles, final res {rr:.2e}, max err vs dense {err:.2e}{note}")
        out[name] = {"cycles": it, "res": rr, "err": err}
    return out


if __name__ == "__main__":
    main()
