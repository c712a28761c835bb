"""The scattered chain as the benchmark's cell ``scattered_2m.mixed_damped``
builds it (``aggmg_bench/builders/scattered_hierarchy.py`` on the card),
against the plain reference (``aggmg_bench/references/scattered_dg.py``):
per block-COO level, the largest gap of a column of its operator ``A`` and
of its prolongation over that column's largest entry, and the fine
operator's and right-hand side's gaps, as ``harness.judge`` reads them.

    PYTHONPATH=. python3 tools/scattered_reference_gap.py [--n N] [--coarsest C] [--device cuda]

Every block-COO level is compared.  The build and the reference's sparse
products both run on ``--device``.  One JSON object is printed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=None, help="elements (the configuration's by default)")
    ap.add_argument("--coarsest", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from aggmg_bench import harness, reference

    cell = harness.resolve("scattered_2m.mixed_damped", ROOT)
    n = a.n or cell.config["builder_args"]["n"]
    over = {"builder_args": {"n": n}, "discretization": {"n_elements": n, "c_dir": 1000.0 * n}}
    if a.coarsest:
        over["partition"] = {"coarsest": a.coarsest}
    cfg = harness.merged(cell.config, over)
    ref_mod = reference.load(cfg["reference"])
    out = {"n": n, "partition": cfg["partition"], "device": a.device}
    if a.device == "cuda":
        out["card"] = harness.power_limit()

    t0 = time.perf_counter()
    prob = cell.builder.build(cfg, a.device)
    out["build_s"] = time.perf_counter() - t0
    h = prob.hierarchy
    ref = ref_mod.Problem(cfg["discretization"], torch.float64, a.device)
    fine = prob.hierarchy.levels[0].a
    out["fine_operator_gap"] = max(reference.max_column_gap(g.to(torch.float64), w)
                                   for g, w in zip((fine.lower, fine.diag, fine.upper), ref.operator_columns(0, n)))
    p = cfg["problem"]
    want_b = ref.rhs_columns(getattr(torch, p["source"]), p["left_value"], p["right_value"], 0, n)
    out["rhs_gap"] = reference.max_column_gap(prob.b.to(torch.float64), want_b)

    t0 = time.perf_counter()
    levels = ref_mod.scattered_levels(ref, cfg["partition"])
    out["reference_s"] = time.perf_counter() - t0
    dev = torch.device(a.device)
    rows = []
    for k, lv in enumerate(levels, 1):
        op, t = h.levels[k].a, h.transfers[k - 1]
        got_a = ref_mod.block_sparse(op.rows.to(dev), op.cols.to(dev), op.blocks.to(dev, torch.float64),
                                     op.n_rows, op.n_cols)
        n_f = t.blocks.shape[2]
        got_p = ref_mod.block_sparse(torch.arange(n_f, device=dev), t.cols.to(dev), t.blocks.to(dev, torch.float64),
                                     n_f, t.n_coarse)
        rows.append({"level": k, "blocks": op.n_rows, "nnz_blocks": op.nnz,
                     "owner_equal": bool(np.array_equal(prob.meshes[k].assign, lv["owner"].cpu().numpy())),
                     "operator_gap": ref_mod.column_gap(got_a, lv["a"]),
                     "prolongation_gap": ref_mod.column_gap(got_p, lv["p"])})
    out["levels"] = rows
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
