"""Element-axis-sharded multigrid over ``torch.distributed``, on the PyTorch
port.

One rank on the card (NCCL), or ``--world N`` ranks over gloo on the CPU,
each a spawned process that joins the group through a file store:

    python examples/distributed_solve_torch.py                        # one NCCL rank
    python examples/distributed_solve_torch.py --device cpu --world 4 # four gloo ranks

Each rank builds the problem, keeps its shard of every sharded level
(``parallel.shard_hierarchy``) and of the rhs, and runs float64
``multigrid``; rank 0 prints the count and the gathered solution's distance
to the unsharded solve's.
"""

import argparse
import os
import sys as _sys
import tempfile
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root

import torch
import torch.multiprocessing as mp

from agglomerationmultigrid1d_tpu_torch import parallel
from agglomerationmultigrid1d_tpu_torch.models import multigrid, poisson_dg_hierarchy


def run(rank: int, world: int, store: str, device: str, n: int, out=None) -> dict:
    g = parallel.initialize(rank, world, store_path=store, device=device)
    try:
        prob = poisson_dg_hierarchy(n=n, max_p=4, n_dg=3, device=g.device)
        h = parallel.shard_hierarchy(prob.hierarchy, g)
        b = parallel.shard_vector(prob.b, g)
        res = multigrid(h, torch.zeros_like(b), b, 50, 1e-10, compute_error=False)
        x = parallel.unshard_vector(res.x, h)
        ref = multigrid(prob.hierarchy, torch.zeros_like(prob.b), prob.b, 50, 1e-10, compute_error=False)
        gap = float((x - ref.x).abs().max() / prob.b.abs().max())
        result = {"iterations": res.iterations, "unsharded": ref.iterations, "gap": gap,
                  "sharded_levels": sum(h.layout.sharded)}
        if rank == 0:
            print(f"{world} rank(s) on {g.device} over {g.backend}: {sum(h.layout.sharded)} of {h.n_levels} levels "
                  f"sharded; {res.iterations} V-cycles (unsharded {ref.iterations}); "
                  f"max|x - x_unsharded| / max|b| = {gap:.2e}")
            if out is not None:
                out.put(result)
        return result
    finally:
        parallel.shutdown()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=1, help="ranks (more than one: gloo on the CPU)")
    ap.add_argument("--n", type=int, default=512, help="DG elements")
    args = ap.parse_args(argv)
    if args.world > 1 and args.device != "cpu":
        raise SystemExit("several ranks share no card here: NCCL refuses two ranks on one device; use --device cpu")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        if args.world == 1:
            return run(0, 1, store, args.device, args.n)
        ctx = mp.get_context("spawn")
        out = ctx.Queue()
        procs = [ctx.Process(target=run, args=(r, args.world, store, args.device, args.n, out))
                 for r in range(args.world)]
        for p in procs:
            p.start()
        result = out.get(timeout=600)
        for p in procs:
            p.join(600)
        if any(p.exitcode != 0 for p in procs):
            raise SystemExit(f"rank exit codes {[p.exitcode for p in procs]}")
        return result


if __name__ == "__main__":
    main()
