"""CG discretization convergence study (mirrors tests/cg_convergence_test.jl),
on the PyTorch port.

Solves -u'' = cos on [0,1] with Neumann/Dirichlet ends at p = 3 over a mesh
sweep and prints the observed L2 convergence slope (expected ~ p + 1):

    python examples/cg_convergence_torch.py [--device cuda|cpu] [--n 4 8 16 32 64]
"""

import argparse
import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root

import numpy as np
import torch

from agglomerationmultigrid1d_tpu_torch.assembly import cg_stiffness_and_rhs
from agglomerationmultigrid1d_tpu_torch.mesh import BoundaryCondition, create_uniform_mesh, make_cg_mesh
from agglomerationmultigrid1d_tpu_torch.numerics import evaluate_nodal_basis, gauss_quad
from agglomerationmultigrid1d_tpu_torch.ops import cg_to_dense

P = 3


def l2_error(cg, u, u_exact):
    """The L2 error of the nodal solution ``u`` (grid order) against ``u_exact``."""
    p = cg.p
    qx, qw = gauss_quad(4 * p)
    basis = evaluate_nodal_basis(cg.ref.basis_coeff, qx)[:, cg.ref.pos_to_slot]
    jac = cg.mesh.jacobians
    idx = p * np.arange(cg.n_elements)[:, None] + np.arange(p + 1)[None, :]
    uh = u[idx] @ basis.T  # (n_el, n_q)
    xq = cg.mesh.centers[:, None] + jac[:, None] * qx[None, :]
    return float(np.sqrt(np.sum(jac[:, None] * qw[None, :] * (u_exact(xq) - uh) ** 2)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, nargs="+", default=[4, 8, 16, 32, 64], help="element counts")
    args = ap.parse_args(argv)
    bc = BoundaryCondition(("neu", -np.sin(0.0)), ("dir", np.cos(1.0)))
    errs = []
    for n in args.n:
        cg = make_cg_mesh(create_uniform_mesh(n, 0.0, 1.0), P)
        a, f = cg_stiffness_and_rhs(cg, torch.cos, bc)
        u = torch.linalg.solve(cg_to_dense(a).to(args.device), f.to(args.device))
        errs.append(l2_error(cg, u.cpu().numpy(), np.cos))
        print(f"n={n:4d}  L2 error = {errs[-1]:.3e}")
    ns = args.n
    slope = (np.log10(errs[-1]) - np.log10(errs[0])) / (np.log10(1 / ns[-1]) - np.log10(1 / ns[0]))
    print(f"observed convergence order: {slope:.2f} (expected ~ {P + 1})")
    return {"errors": errs, "slope": float(slope)}


if __name__ == "__main__":
    main()
