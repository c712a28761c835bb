"""Smoother analysis (mirrors tests/cg_smoother_test.jl), on the PyTorch port.

(a) Richardson-with-smoother solve of -u'' = 1; (b) damping of sin(i pi x)
modes after 10 sweeps; (c) spectral radius of I - alpha S A:

    python examples/smoother_study_torch.py [--device cuda|cpu] [--n 16] [--plot [out.png]]

``--plot`` also renders the reference's MATLAB figures (the iteration
matrix's spectrum in the complex plane, the per-mode damping) to a file
through matplotlib, where it is installed.
"""

import argparse
import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root

import numpy as np
import torch

from agglomerationmultigrid1d_tpu_torch.assembly import cg_stiffness_and_rhs
from agglomerationmultigrid1d_tpu_torch.mesh import BoundaryCondition, create_uniform_mesh, make_cg_mesh
from agglomerationmultigrid1d_tpu_torch.models import (
    CgLevel,
    iterative_smoother_solve,
    mode_damping,
    smoother_spectrum,
)
from agglomerationmultigrid1d_tpu_torch.smoothers import cg_smoother
from agglomerationmultigrid1d_tpu_torch.utils import tree_to

KINDS = [("jac", 2 / 3), ("addSchwarz", 1 / 3), ("hybridSchwarz", 2 / 3)]


def plot_study(results, out_path):
    """The spectrum and mode-damping figures (cg_smoother_test.jl:83-126)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax_spec, ax_damp) = plt.subplots(1, 2, figsize=(11, 4.5))
    theta = np.linspace(0, 2 * np.pi, 200)
    ax_spec.plot(np.cos(theta), np.sin(theta), color="0.8", lw=1, zorder=0)
    for kind, alpha, spec, damp in results:
        label = f"{kind} (alpha={alpha:.2f})"
        ax_spec.scatter(spec.real, spec.imag, s=14, label=label)
        ax_damp.semilogy(np.arange(1, len(damp) + 1), damp, marker="o", label=label)
    ax_spec.set_title("eig(I - alpha S A)")
    ax_spec.set_xlabel("Re")
    ax_spec.set_ylabel("Im")
    ax_spec.set_aspect("equal")
    ax_spec.legend(fontsize=8)
    ax_damp.set_title("damping of sin(i pi x) modes after 10 sweeps")
    ax_damp.set_xlabel("mode i")
    ax_damp.set_ylabel("||E^10 v_i|| / ||v_i||")
    ax_damp.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=140)
    print(f"wrote {out_path}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=16, help="elements of the CG p = 2 mesh")
    ap.add_argument("--plot", nargs="?", const="smoother_study.png", default=None)
    args = ap.parse_args(argv)

    cg = make_cg_mesh(create_uniform_mesh(args.n, 0.0, 1.0), 2)
    bc = BoundaryCondition(("dir", 0.0), ("dir", 0.0))
    a, f = cg_stiffness_and_rhs(cg, torch.ones_like, bc)
    a, f = tree_to(a, args.device), f.to(args.device)
    results, out = [], {}
    for kind, alpha in KINDS:
        level = CgLevel(a=a, smoother=cg_smoother(a, kind))
        res = iterative_smoother_solve(level, torch.zeros_like(f), f, maxiter=20000, tol=1e-8, alpha=alpha)
        print(f"{kind:15s}: {res.iterations} Richardson iterations")
        spec = smoother_spectrum(level, alpha)
        damp = mode_damping(level, modes=8, sweeps=10, alpha=alpha)
        print(f"{'':15s}  spectral radius {np.abs(spec[0]):.4f}; "
              f"mode damping (i=1..8): {np.array2string(damp, precision=3)}")
        results.append((kind, alpha, spec, damp))
        out[kind] = {"iterations": res.iterations, "radius": float(np.abs(spec[0])), "damping": damp}
    if args.plot is not None:
        plot_study(results, args.plot)
    return out


if __name__ == "__main__":
    main()
