"""The hybrid-Schwarz chain as the benchmark's cell
``flagship_schwarz_16m.handover_cg`` builds it (``aggmg_bench/builders/
xl_cg_problem.py`` on the card), against the plain reference
(``aggmg_bench/references/cg_hybrid_schwarz.py``): on every CG level, the
program's float32 Schwarz apply of a seeded random ``r`` (rounded to
float32, the precision the program smooths in) beside the reference's
float64 one, and the level's float-float band beside the reference's
Galerkin band.

    PYTHONPATH=. python3 tools/schwarz_reference_gap.py [--n N] [--agg L] [--device cuda] [--seed S]

Per level it prints the largest gap relative to ``max|y|`` (``gap_max``),
and the largest gap of an entry relative to that entry of ``|S| |r|``
(``gap``), which is what :data:`TOL` holds: the Dirichlet node's unit row
makes ``max|y|`` of the fine level ~1e5 times its interior entries, where
``max|y|`` would hide any rounding.  The same apply with the inverse
windows rounded to bfloat16 and to float16 is printed beside, and has to
fail :data:`TOL`.  One JSON object is printed; the exit code is 1 where a
level misses a limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CELL = "flagship_schwarz_16m.handover_cg"
# Each entry of a float32 apply rounds at most w + 2 times (the stored
# inverse, the product, the w - 1 sums of the window row, the scatter-add of
# the two windows at a vertex), so its error is below (w + 2) 2^-24 of that
# entry of |S| |r|: 6.6e-7 at w = 9.  Windows stored in bfloat16 or float16
# read 2e-3 and 3e-4 or more (2^-9 and 2^-12 of the same).
TOL = 1e-6
# The level's band: float-float hi + lo against the reference's Galerkin
# product, both float64 sums of the same products in another order.
BAND_TOL = 1e-12


def level_gaps(h_low, ffops, bands, orders, seed: int, device) -> list:
    """Per CG level, the gaps of the program's Schwarz apply and band to
    the reference's (see the module docstring)."""
    import torch

    from aggmg_bench import reference
    from aggmg_bench.references import cg_hybrid_schwarz as ref
    from agglomerationmultigrid1d_tpu_torch.smoothers.smoother import (
        ChebyshevSmoother,
        SchwarzSmoother,
        apply_smoother,
    )

    g = torch.Generator(device="cpu").manual_seed(seed)
    rows = []
    for k, (band, p) in enumerate(zip(bands, orders)):
        s = h_low.levels[k].smoother
        s = s.base if isinstance(s, ChebyshevSmoother) else s
        if not isinstance(s, SchwarzSmoother) or s.mult_inv is None:
            raise TypeError(f"CG level {k} is not smoothed by hybrid Schwarz: {type(s).__name__}")
        r = torch.randn(band.shape[1], generator=g, dtype=torch.float32).to(device)
        want = ref.schwarz_apply(band, r)
        scale = ref.schwarz_apply(band, r, absolute=True)

        def gaps(windows, s=s, r=r, want=want, scale=scale):
            got = apply_smoother(s._replace(inv_windows=windows), r).to(torch.float64)
            d = (got - want).abs()
            return float((d / scale).max()), float(d.max() / want.abs().max())

        a = ffops.a_ffs[k]
        joined = a.hi.to(torch.float64) + a.lo.to(torch.float64)
        row = {"level": k, "p": int(p), "nodes": int(band.shape[1]),
               "band_gap": reference.max_column_gap(joined, band)}
        row["gap"], row["gap_max"] = gaps(s.inv_windows)
        for name, dt in (("bfloat16", torch.bfloat16), ("float16", torch.float16)):
            row[f"gap_{name}"] = gaps(s.inv_windows.to(dt).to(torch.float32))[0]
        row["ok"] = (row["gap"] <= TOL and row["band_gap"] <= BAND_TOL
                     and min(row["gap_bfloat16"], row["gap_float16"]) > TOL)
        rows.append(row)
        del r, want, scale, joined
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=None, help="elements (the configuration's by default)")
    ap.add_argument("--agg", type=int, default=None, help="agglomerated levels (with --n)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=2**31 + 24)
    a = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from aggmg_bench import harness
    from aggmg_bench.references import cg_hybrid_schwarz as ref

    cell = harness.resolve(CELL, ROOT)
    over = {}
    if a.n:
        over = {"builder_args": {"n": a.n, "spec": {"c_dir": 1000.0 * a.n}}, "discretization": {"n_elements": a.n}}
        if a.agg:
            over["builder_args"]["spec"]["n_agg_levels"] = a.agg
    cfg = harness.merged(cell.config, over)
    out = {"n": cfg["builder_args"]["n"], "device": a.device, "seed": a.seed, "tol": TOL, "band_tol": BAND_TOL}
    if a.device == "cuda":
        out["card"] = harness.power_limit()
    t0 = time.perf_counter()
    h_low, ffops, _, _ = cell.builder.build(cfg, a.device)
    out["build_s"] = time.perf_counter() - t0
    orders = cfg["builder_args"]["spec"]["cg_orders"]
    t0 = time.perf_counter()
    bands = ref.level_bands(cfg["discretization"], orders, a.device)
    out["reference_s"] = time.perf_counter() - t0
    out["levels"] = level_gaps(h_low, ffops, bands, orders, a.seed, torch.device(a.device))
    out["ok"] = all(r["ok"] for r in out["levels"])
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
