"""Run functions on every rank of a spawned ``torch.distributed`` gloo group
(the torch port's element-sharded solve, on the CPU).

:func:`run_group` starts ``world`` processes (``spawn``), joins them through a
``FileStore`` under the caller's directory (no fixed port, so several groups
can run at once), runs each job ``(name, fn, args)`` on every rank and returns
``{name: [result of rank 0, rank 1, ...]}``.  A job that raises on a rank
gives that rank's traceback text instead of a result, so one failing job does
not hide the others.  The whole run has a time limit: past it the processes
are killed and :func:`run_group` raises, so a hung rendezvous or collective
fails the calling test and does not stall the suite.

The job functions below take the rank's ``SolverGroup`` and numpy arrays and
return numpy arrays; they live here, not in a test file, so the children
import torch and the port but never JAX.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import traceback

import numpy as np
import torch


def _rank_main(rank, world, store_path, jobs, q):
    torch.set_num_threads(1)  # this child's own setting: four ranks share the host
    from agglomerationmultigrid1d_tpu_torch.parallel import initialize, shutdown

    out = {}
    try:
        g = initialize(rank, world, store_path=store_path, device="cpu", timeout_s=60)
        for name, fn, args in jobs:
            try:
                out[name] = fn(g, *args)
            except Exception:  # reported to the parent, which fails that job's test
                out[name] = traceback.format_exc()
        shutdown()
    except Exception:
        out = {"__group__": traceback.format_exc()}
    q.put((rank, out))


def run_group(jobs, world: int, store_path: str, timeout_s: float = 120.0) -> dict:
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, world, store_path, jobs, q)) for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):
            rank, out = q.get(timeout=timeout_s)
            results[rank] = out
    except queue.Empty:
        raise TimeoutError(f"the {world}-rank group did not finish within {timeout_s} s") from None
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    for rank, out in results.items():
        if "__group__" in out:
            raise RuntimeError(f"rank {rank} failed to join the group:\n{out['__group__']}")
    return {name: [results[r][name] for r in range(world)] for name, _, _ in jobs}


def check(per_rank: list) -> list:
    """The ranks' results of one job; raises with a rank's traceback if it failed."""
    for r, v in enumerate(per_rank):
        if isinstance(v, str):
            raise AssertionError(f"rank {r} raised:\n{v}")
    return per_rank


def cols(x: np.ndarray, rank: int, world: int) -> np.ndarray:
    """Rank ``rank``'s columns of ``x`` (the last axis)."""
    n = x.shape[-1] // world
    return np.ascontiguousarray(x[..., rank * n : (rank + 1) * n])


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------


def job_halo_shift(g, x, d):
    from agglomerationmultigrid1d_tpu_torch.parallel import halo_shift

    return halo_shift(torch.from_numpy(cols(x, g.rank, g.world)), d, g).numpy()


def _bt(a):
    from agglomerationmultigrid1d_tpu_torch.ops.block_tridiag import BlockTridiag

    return BlockTridiag(*(torch.from_numpy(m) for m in a))


def job_sharded_sweeps(g, a, inv, x, b, kind, kw):
    """``sharded_multisweep`` (kind "damped") or ``sharded_chebyshev_multisweep``
    (kind "cheb", ``kw["coef"]``) on the rank's columns of global numpy inputs."""
    from agglomerationmultigrid1d_tpu_torch.parallel import sharded_chebyshev_multisweep, sharded_multisweep

    r, w = g.rank, g.world
    loc = _bt([cols(m, r, w) for m in a])
    args = (loc, torch.from_numpy(cols(inv, r, w)), torch.from_numpy(cols(x, r, w)), torch.from_numpy(cols(b, r, w)))
    kw = dict(kw)
    if kind == "cheb":
        out = sharded_chebyshev_multisweep(g, *args, kw.pop("coef"), **kw)
    else:
        out = sharded_multisweep(g, *args, **kw)
    return tuple(t.numpy() for t in out) if isinstance(out, tuple) else out.numpy()


def _sharded_problem(g, h, b, min_blocks, low=False):
    """``h``: a whole port hierarchy on the CPU (the parent converts the JAX
    package's, so the children never unpickle a JAX type)."""
    from agglomerationmultigrid1d_tpu_torch.models import make_low_precision_hierarchy
    from agglomerationmultigrid1d_tpu_torch.parallel import shard_hierarchy, shard_vector

    hs = shard_hierarchy(h, g, min_blocks_per_device=min_blocks)
    h32 = shard_hierarchy(make_low_precision_hierarchy(h), g, min_blocks_per_device=min_blocks) if low else None
    return hs, h32, shard_vector(torch.from_numpy(b), g)


def _result(res, h):
    from agglomerationmultigrid1d_tpu_torch.parallel import unshard_vector

    return dict(
        iterations=res.iterations, inner=res.inner_cycles, res=res.res_history.numpy(),
        err=res.err_history.numpy(), x=unshard_vector(res.x, h).numpy(),
    )


def job_multigrid(g, h, b, min_blocks):
    """f64 ``multigrid`` on the sharded hierarchy (``distributed_multigrid``)."""
    from agglomerationmultigrid1d_tpu_torch.parallel import distributed_multigrid

    h, _, bl = _sharded_problem(g, h, b, min_blocks)
    return _result(distributed_multigrid(h, torch.zeros_like(bl), bl, 50, 1e-10), h)


def job_low_precision(g, h, b, min_blocks, solver):
    """``multigrid_mixed`` or ``multigrid_progressive`` on the sharded
    hierarchies (float32 inner cycles through K7's schedule)."""
    from agglomerationmultigrid1d_tpu_torch.models import multigrid_mixed, multigrid_progressive

    h, h32, bl = _sharded_problem(g, h, b, min_blocks, low=True)
    fn = multigrid_mixed if solver == "mixed" else multigrid_progressive
    return _result(fn(h, h32, torch.zeros_like(bl), bl, 60, 1e-10), h)


def job_v_cycle(g, h, b, x0, min_blocks, low=False):
    """One V-cycle from ``x0`` on the sharded hierarchy (``low``: its float32
    copy); the whole result and how many smoothings ran K7's schedule."""
    from agglomerationmultigrid1d_tpu_torch.parallel import (
        distributed_v_cycle,
        shard_vector,
        sharded_kernels,
        unshard_vector,
    )

    hs, h32, bl = _sharded_problem(g, h, b, min_blocks, low=low)
    x = shard_vector(torch.from_numpy(x0), g)
    if low:
        hs, x, bl = h32, x.float(), bl.float()
    runs, schedule = [], sharded_kernels._kernel_schedule

    def counted(*args, **kw):
        runs.append(1)
        return schedule(*args, **kw)

    sharded_kernels._kernel_schedule = counted  # this child's own module
    try:
        out = unshard_vector(distributed_v_cycle(hs, x, bl), hs).numpy()
    finally:
        sharded_kernels._kernel_schedule = schedule
    return out, len(runs)


def job_operator_ghosts(g, h, min_blocks):
    """The float32 levels' K7 operator ghosts, from sharding the float32
    hierarchy and from casting the sharded float64 one (None where a level
    has none); and, per level of the first, whether it carries an edge plan
    bound to its present operators and ghosts."""
    from agglomerationmultigrid1d_tpu_torch.models import make_low_precision_hierarchy
    from agglomerationmultigrid1d_tpu_torch.parallel import shard_hierarchy

    def ghosts(hh):
        return [None if lv.smoother.ghosts is None else lv.smoother.ghosts.numpy() for lv in hh.levels]

    first = shard_hierarchy(make_low_precision_hierarchy(h), g, min_blocks_per_device=min_blocks)
    second = make_low_precision_hierarchy(shard_hierarchy(h, g, min_blocks_per_device=min_blocks))
    bound = [
        lv.smoother.plan is not None
        and lv.smoother.plan.bound_to(lv.smoother.ml, lv.smoother.mu, lv.smoother.inv, lv.a.diag, lv.smoother.ghosts)
        for lv in first.levels
    ]
    return ghosts(first), ghosts(second), bound


def job_plan_reuse(g, a, inv, xs, b, kind, kw):
    """The sharded smoother on one level, once per ``x`` of ``xs`` in a row:
    through ONE edge plan (its messages reused from call to call), and through
    a plan built anew for every call.  Returns ``(reused, fresh)``, each a list
    of per-call results."""
    from agglomerationmultigrid1d_tpu_torch.ops.block_tridiag import block_mul
    from agglomerationmultigrid1d_tpu_torch.parallel import (
        edge_plan,
        operator_ghosts,
        sharded_chebyshev_multisweep,
        sharded_multisweep,
    )

    r, w = g.rank, g.world
    loc = _bt([cols(m, r, w) for m in a])
    s_inv, bl = torch.from_numpy(cols(inv, r, w)), torch.from_numpy(cols(b, r, w))
    ml, mu = block_mul(s_inv, loc.lower), block_mul(s_inv, loc.upper)
    gops = operator_ghosts(ml, mu, s_inv, g)
    kw = dict(kw, ml=ml, mu=mu, op_ghosts=gops)
    coef = (kw.pop("coef"),) if kind == "cheb" else ()
    fn = sharded_chebyshev_multisweep if kind == "cheb" else sharded_multisweep

    def run(plan_for_call):
        outs = []
        for x in xs:
            out = fn(g, loc, s_inv, torch.from_numpy(cols(x, r, w)), bl, *coef, plan=plan_for_call(), **kw)
            outs.append(tuple(t.numpy().copy() for t in out) if isinstance(out, tuple) else out.numpy().copy())
        return outs

    one = edge_plan(ml, mu, s_inv, loc.diag, gops, g)
    return run(lambda: one), run(lambda: edge_plan(ml, mu, s_inv, loc.diag, gops, g))
