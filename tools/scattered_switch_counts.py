#!/usr/bin/env python3
"""Iteration counts of ``chip_smoke.py``'s scattered and mixed-switch chains,
from the port on any device or from the JAX package on the CPU, on the same
partitions and switch.

    PYTHONPATH=<checkout> python3 tools/scattered_switch_counts.py [--package torch|jax]
        [--device cpu|cuda] [--chain scattered|switch|odd ...] [--n N]

The scattered chain: DG p = 1, ``interleaved_pair_groups`` (interleaved
pairs, then pairwise merges down to 1,024 agglomerates); float64
``multigrid``, ``multigrid_mixed`` damped and after ``chebyshev_hierarchy``
(JAX: ``use_pallas=False``).  The switch chain: ``poisson_switch_hierarchy``
(DG p = 3 with a mixed switch, DG p = 1, agglomerates of 2, then 2:1 levels
down to 4,096 agglomerates, or to 15,625 for the ``odd`` chain of 500,000
elements); float64 ``multigrid``, ``multigrid_mixed`` and
``multigrid_progressive`` (``odd``: ``multigrid``, then the witness of
the forward-error floor: the condition estimate, and the banded direct
solution and ``multigrid``'s at 1e-14 against ``fine_refined_solve``'s;
its ``--n`` at least 62,500).  ``--n`` defaults to the card's sizes:
1,048,576 (scattered), 524,288 (switch), 500,000 (odd).
The JAX package's scattered coarsening costs O(m n) on the host: keep its
``--n`` near 65,536.  Prints one line per solve: counts, the relative
residual and seconds (host clock, setup apart).
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SIZES = {"scattered": 1048576, "switch": 524288, "odd": 500000}
COARSEST_AGG = {"scattered": 1024, "switch": 4096, "odd": 15625}


def n_coarsen(chain: str, n: int) -> int:
    """2:1 levels below the agglomerates of 2 (switch chains)."""
    return int(round(math.log2(n // 2 // COARSEST_AGG[chain])))


def run_torch(chain: str, n: int, device: str) -> None:
    import torch

    from agglomerationmultigrid1d_tpu_torch.models import (
        chebyshev_hierarchy,
        interleaved_pair_groups,
        level_matvec,
        make_low_precision_hierarchy,
        multigrid,
        multigrid_mixed,
        multigrid_progressive,
        poisson_scattered_hierarchy,
        poisson_switch_hierarchy,
    )

    t0 = time.perf_counter()
    if chain == "scattered":
        groups = interleaved_pair_groups(n, COARSEST_AGG[chain])
        prob = poisson_scattered_hierarchy(n=n, p_dg=1, groups_per_level=groups, device=device)
    else:
        prob = poisson_switch_hierarchy(n, n_coarsen(chain, n), device=device)
    h, b = prob.hierarchy, prob.b
    print(f"torch {chain} n={n} DoF={b.numel()} levels={h.n_levels} coarsest={h.levels[-1].a.n_blocks} "
          f"({type(h.coarse).__name__}) device={device} setup_s={time.perf_counter() - t0:.3f}", flush=True)

    def rel(x):
        r = b - level_matvec(h.levels[0], x.to(torch.float64))
        return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))

    def solve(tag, fn):
        t = time.perf_counter()
        res = fn()
        counts = res.iterations if res.inner_cycles is None or tag == "progressive" else (
            res.iterations, res.inner_cycles)
        print(f"  {tag}: counts={counts} rel_residual={rel(res.x):.3e} solve_s={time.perf_counter() - t:.3f}",
              flush=True)

    zero = torch.zeros_like(b)
    solve("multigrid", lambda: multigrid(h, zero, b, 100, 1e-10, compute_error=False))
    if chain == "odd":
        witness(h, b)
        return
    h32 = make_low_precision_hierarchy(h)
    solve("mixed", lambda: multigrid_mixed(h, h32, zero, b, 80, 1e-10))
    if chain == "scattered":
        hc = chebyshev_hierarchy(h)
        hc32 = make_low_precision_hierarchy(hc)
        solve("mixed chebyshev", lambda: multigrid_mixed(hc, hc32, zero, b, 80, 1e-10))
    else:
        solve("progressive", lambda: multigrid_progressive(h, h32, zero, b, 80, 1e-10))


def witness(h, b) -> None:
    """The odd chain's float64 solutions beside the fine operator's
    condition estimate: the banded direct solve and ``multigrid`` at tol
    1e-14, each against the banded solution refined in extended precision."""
    import torch

    from agglomerationmultigrid1d_tpu_torch.models import multigrid
    from agglomerationmultigrid1d_tpu_torch.ops.banded_solve import fine_direct_solve, fine_refined_solve

    fine = h.levels[0]._replace(a=type(h.levels[0].a)(*(t.cpu() for t in h.levels[0].a)))
    b_flat = b.cpu().T.reshape(-1).numpy()
    cond, x_ref, last = fine_refined_solve(fine, b_flat)
    x_mg = multigrid(h, torch.zeros_like(b), b, 100, 1e-14, compute_error=False).x.cpu().T.reshape(-1).numpy()
    x_banded = fine_direct_solve(fine, b_flat)

    def gap(x, y):
        return float(np.abs(np.asarray(x, dtype=np.longdouble) - y).max() / np.abs(y).max())

    print(f"  witness: cond_1 estimate={cond:.3e} (x eps {cond * np.finfo(np.float64).eps:.3e}), last "
          f"correction {last:.3e}; max|x - x_refined| / max|x_refined|: banded {gap(x_banded, x_ref):.3e}, "
          f"multigrid at 1e-14 {gap(x_mg, x_ref):.3e}; max|x_mg - x_banded| / max|x_banded| "
          f"{gap(x_mg, x_banded):.3e}", flush=True)


def run_jax(chain: str, n: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from agglomerationmultigrid1d_tpu.assembly import dg_assembly
    from agglomerationmultigrid1d_tpu.mesh import coarsen_agg_mesh, create_uniform_mesh, make_agg_mesh, make_dg_mesh
    from agglomerationmultigrid1d_tpu.models import hierarchy, problems, solvers
    from agglomerationmultigrid1d_tpu.ops import bd_matvec, bt_matvec
    from agglomerationmultigrid1d_tpu_torch.models import interleaved_pair_groups

    t0 = time.perf_counter()
    if chain == "scattered":
        groups = [g.tolist() for g in interleaved_pair_groups(n, COARSEST_AGG[chain])]
        prob = problems.poisson_scattered_hierarchy(n=n, p_dg=1, groups_per_level=groups, to_device=False)
        h, b = prob.hierarchy, prob.b
    else:
        func, u_ex, ux_ex = problems.default_model_problem()
        bc, c_dir = problems._default_bc(u_ex, ux_ex), 1000.0 * n
        s = np.array([False] * (n // 2) + [True] * (n - 1 - n // 2))
        mesh = create_uniform_mesh(n, 0.0, 1.0)
        meshes = [make_dg_mesh(mesh, 3, switch=s), make_dg_mesh(mesh, 1, switch=s),
                  make_agg_mesh(1, mesh, 2, tables=False)]
        for _ in range(n_coarsen(chain, n)):
            meshes.append(coarsen_agg_mesh(meshes[-1], 2))
        dg = meshes[0]
        g, d, c = dg_assembly.dg_flux_operators(dg, bc, c_dir)
        a = hierarchy.schur_stiffness(g, d, c, dg.mass_inv, mixed_switch=True)
        h = hierarchy.build_dg_hierarchy(meshes, a, g, d, c)
        f, r = dg_assembly.dg_flux_rhs(dg, func, bc, c_dir)
        b = f - bt_matvec(d, bd_matvec(dg.mass_inv, r))
    print(f"jax {chain} n={n} DoF={b.size} levels={h.n_levels} coarsest={h.levels[-1].a.n_blocks} "
          f"({type(h.coarse).__name__}) setup_s={time.perf_counter() - t0:.3f}", flush=True)
    nb = float(jnp.linalg.norm(b))

    def solve(tag, fn):
        t = time.perf_counter()
        res = fn()
        it = int(res.iterations)
        counts = it if tag in ("multigrid", "progressive") else (it, int(res.inner_cycles))
        print(f"  {tag}: counts={counts} rel_history_end={float(res.res_history[it - 1]) / nb:.3e} "
              f"solve_s={time.perf_counter() - t:.3f}", flush=True)

    zero = jnp.zeros_like(b)
    solve("multigrid", lambda: solvers.multigrid(h, zero, b, 100, 1e-10, compute_error=False))
    if chain == "odd":
        return
    h32 = solvers.make_low_precision_hierarchy(h)
    solve("mixed", lambda: solvers.multigrid_mixed(h, h32, zero, b, 80, 1e-10, use_pallas=False))
    if chain == "scattered":
        hc = hierarchy.chebyshev_hierarchy(h)
        hc32 = solvers.make_low_precision_hierarchy(hc)
        solve("mixed chebyshev", lambda: solvers.multigrid_mixed(hc, hc32, zero, b, 80, 1e-10, use_pallas=False))
    else:
        solve("progressive", lambda: solvers.multigrid_progressive(h, h32, zero, b, 80, 1e-10, use_pallas=False))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("torch", "jax"), default="torch")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--chain", nargs="+", choices=tuple(SIZES), default=list(SIZES))
    ap.add_argument("--n", type=int, default=None)
    args = ap.parse_args()
    for chain in args.chain:
        n = args.n or SIZES[chain]
        if args.package == "jax":
            run_jax(chain, n)
        else:
            run_torch(chain, n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
