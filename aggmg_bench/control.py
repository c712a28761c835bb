#!/usr/bin/env python3
"""The control of ``correct``: the plain reference put in the program's
place, computed in the nearest precision below the configuration's
(float32 for float64): its operator and right-hand side rounded to float32
and every solve the reference's direct solve in float32 (block cyclic
reduction for ``dg_block_tridiag``).  A sound check reads it
as not correct.

    python3 aggmg_bench/control.py --workload <cell> --seeds 11 12 13 [--seconds 2]

runs the rest of a benchmark run (set-up, window, checks) around it at the
cell's own size and prints each seed's numbers beside their limits, one
JSON line per seed.  The benchmark's own runs never run it.

As a module it has both interfaces the harness calls, a builder's and an
entry point's (``harness.run(cell, ..., program=control.Control(cell))``),
and uses the reference module that the cell's configuration names."""

import sys
from pathlib import Path

import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from aggmg_bench.reference import Columns  # noqa: E402


class Control:
    FORM = "any"

    def __init__(self, cell):
        self.dtype = {"float64": torch.float32}[cell.config["precision"]]
        self.ref = cell.reference

    # builder
    def build(self, cfg, device):
        prob = self.ref.Problem(cfg["discretization"], self.dtype, device)
        parts = [prob.operator_columns(lo, hi) for lo, hi in prob.blocks()]
        op = tuple(torch.cat([p[i] for p in parts], dim=-1) for i in range(len(parts[0])))
        p = cfg["problem"]
        src = getattr(torch, p["source"])
        b = torch.cat([prob.rhs_columns(src, p["left_value"], p["right_value"], lo, hi)
                       for lo, hi in prob.blocks()], dim=1)
        return dict(op=op, b=b)

    def snapshot(self, problem):
        op = tuple(t.to("cpu", torch.float64) for t in problem["op"])
        return dict(operator=Columns(op), rhs=problem["b"].to("cpu", torch.float64))

    # entry point
    def prepare(self, problem, args):
        return problem

    def inputs(self, state, b64):
        return b64.to(self.dtype)

    def solve(self, state, b, args):
        return self.ref.direct_solve(state["op"], b), 1

    def warmup(self, state, b, args, warm):
        self.solve(state, b, args)


def main(argv=None) -> int:
    import argparse
    import json

    from aggmg_bench import harness

    ap = argparse.ArgumentParser(description="the control of correct, at a cell's own size")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    a = ap.parse_args(argv)
    cell = harness.resolve(a.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in a.seeds:
        out, detail = harness.run(cell, seed, a.seconds, False, device=device, program=Control(cell))
        print(json.dumps(dict(workload=a.workload, seed=seed, correct=out["correct"], checks=out["checks"],
                              solves=detail["solves"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
