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


# ---------------------------------------------------------------------------
# CG levels on a shard and the rank-local stencil build
# ---------------------------------------------------------------------------


def tensor_leaves(tree, path="", out=None) -> list:
    """``(path, tensor)`` of every tensor in nested NamedTuples / tuples /
    dataclasses (a ``BTFFStencil``), in a fixed order, leaving out what only
    a sharded hierarchy's levels have: its layout, and its block levels' K7
    operator ghosts and edge plans (a cut transfer's column plans stay)."""
    import dataclasses

    from agglomerationmultigrid1d_tpu_torch.parallel.sharded_kernels import EdgePlan

    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append((path, tree))
    elif isinstance(tree, EdgePlan):
        pass
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            if f not in ("layout", "ghosts"):
                tensor_leaves(getattr(tree, f), f"{path}.{f}", out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            tensor_leaves(getattr(tree, f.name), f"{path}.{f.name}", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            tensor_leaves(v, f"{path}[{i}]", out)
    return out


def gathered(g, t: torch.Tensor, width: int) -> torch.Tensor:
    """The whole of a leaf from the ranks' parts: gathered along the last
    axis (each rank's width exchanged) where the rank's part is narrower
    than the whole's ``width``, else the rank's own."""
    from agglomerationmultigrid1d_tpu_torch.parallel import all_gather_cols, all_reduce_sum

    mine = t.dim() > 0 and t.shape[-1] != width
    widths = torch.zeros(g.world, dtype=torch.int64)
    widths[g.rank] = t.shape[-1] if mine else -1
    widths = all_reduce_sum(widths, g).tolist()
    if all(w_ < 0 for w_ in widths):
        return t
    if not all(w_ >= 0 for w_ in widths):
        raise AssertionError(f"a leaf sharded on some ranks only: widths {widths}")
    return all_gather_cols(t, g, widths)


def _gathered_mismatches(g, local, whole) -> list:
    """The paths of the leaves whose gathered value differs from the whole
    build's, bit for bit (and of a difference in the leaves' structure)."""
    la, lb = tensor_leaves(local), tensor_leaves(whole)
    if [p for p, _ in la] != [p for p, _ in lb]:
        return ["structure"]
    bad = []
    for (path, t), (_, w) in zip(la, lb):
        got = gathered(g, t, w.shape[-1] if w.dim() else 0)
        if got.shape != w.shape or got.dtype != w.dtype or not torch.equal(got, w):
            bad.append(path)
    return bad


def _xl_case(case):
    from agglomerationmultigrid1d_tpu_torch.utils.config import HierarchySpec

    spec, n, kw, min_blocks = case
    return HierarchySpec(**dict(spec)), n, dict(kw), min_blocks


def _solve_ff(h, a_ff, b_ff, norm_b):
    from agglomerationmultigrid1d_tpu_torch.models.solvers import _mixed_loop_ff
    from agglomerationmultigrid1d_tpu_torch.ops.df64 import FF

    zero = torch.zeros_like(b_ff.hi)
    x, outer, cycles, hist = _mixed_loop_ff(h, a_ff, FF(zero, zero), b_ff, np.float32(1.0 / norm_b),
                                            maxiter=100, tol=1e-10, inner_tol=3.0e-5, max_inner=20)
    return x, outer, cycles, hist


def _uncut(bundle, cut):
    """``(levels, transfers, coarse, a_ff, b_ff)`` with the transfers ``cut``
    (the indices of the rank-local build's ``ShardBlock`` / ``ShardScattered``,
    which are not column slices of a whole transfer) left out."""
    levels, transfers, *rest = bundle
    return (levels, tuple(None if k in cut else t for k, t in enumerate(transfers)), *rest)


def job_sharded_xl(g, case, jax_ref=None):
    """``build_sharded_xl_problem`` on the rank: the level flags, the
    transfers cut because their agglomerates straddle the ranks, the fine
    level's own width, the widest leaf the rank holds, ``norm_b`` and
    ``_mixed_loop_ff`` on it (counts, history, the rank's x).  Where the
    stencil factor is at least 2, also against the port's whole
    ``build_xl_problem`` of the same arguments: the paths of the leaves
    whose gathered value differs from it, bit for bit (``h_low`` but the cut
    transfers, ``a_ff``, the rhs pair); the leaves at least ``n`` wide that
    this rank holds whole (none may be); the paths of the leaves of
    ``h_low`` (the cut transfers and their column plans included) that
    differ, bit for bit, from ``shard_hierarchy`` of the whole build; and
    ``_mixed_loop_ff`` on the whole build.  With ``ff_levels`` the whole
    build's ``a_ff`` is its ``FFOps.a_ffs``, the sharded build's tuple, and
    nothing is solved.  ``jax_ref``, the JAX package's sharded build of the
    same arguments as the port's ``(h, a_ff, b_ff)`` (global arrays, its CG
    node padding cut off): ``jax_leaves``, the rank's leaves gathered as
    the JAX arrays are (rank 0's, NumPy), and ``jax_cut``, per cut transfer
    the paths and NumPy leaves of the rank's part and of the JAX transfer
    cut by ``parallel.transfers.shard_transfer``."""
    from agglomerationmultigrid1d_tpu_torch.models import build_xl_problem, default_stencil_factor
    from agglomerationmultigrid1d_tpu_torch.models.hierarchy import CgLevel
    from agglomerationmultigrid1d_tpu_torch.parallel import build_sharded_xl_problem, shard_hierarchy, unshard_vector
    from agglomerationmultigrid1d_tpu_torch.parallel.distributed import level_size
    from agglomerationmultigrid1d_tpu_torch.parallel.transfers import SHARD_TRANSFERS, shard_transfer

    spec, n, kw, min_blocks = _xl_case(case)
    h, a_ff, b_ff, norm_b = build_sharded_xl_problem(spec, n, group=g, min_blocks_per_device=min_blocks, **kw)
    fine = h.levels[0]
    cut = [k for k, t in enumerate(h.transfers) if isinstance(t, SHARD_TRANSFERS)]
    local = (h.levels, h.transfers, h.coarse, a_ff, b_ff)
    out = dict(
        flags=h.layout.sharded, cut=cut, norm_b=norm_b,
        fine_width=fine.a.band.shape[-1] if isinstance(fine, CgLevel) else fine.a.n_blocks,
        widest=max(t.shape[-1] for _, t in tensor_leaves(local) if t.dim() > 0),
    )
    if not kw.get("ff_levels"):
        x, outer, cycles, hist = _solve_ff(h, a_ff, b_ff, norm_b)
        out.update(solve=(outer, cycles, float(hist[outer - 1])), hist=hist[:outer],
                   x_hi=unshard_vector(x.hi, h).numpy(), x_lo=unshard_vector(x.lo, h).numpy())
    if (kw.get("z") or default_stencil_factor(spec, n)) >= 2:
        hw, aw, bw_, nw = build_xl_problem(spec, n, device="cpu", **kw)
        if kw.get("ff_levels"):
            aw = aw.a_ffs
        whole = (hw.levels, hw.transfers, hw.coarse, aw, bw_)
        layout = shard_hierarchy(hw, g, min_blocks_per_device=min_blocks)
        la, lb = (tensor_leaves((x_.levels, x_.transfers, x_.coarse)) for x_ in (h, layout))
        out.update(
            whole_norm_b=nw,
            mismatches=_gathered_mismatches(g, _uncut(local, cut), _uncut(whole, cut)),
            # the leaves held whole on this rank although at least n wide
            whole_wide=[path for (path, t), (_, w) in zip(tensor_leaves(_uncut(local, cut)),
                                                          tensor_leaves(_uncut(whole, cut)))
                        if w.dim() > 0 and w.shape[-1] >= n and t.shape[-1] == w.shape[-1]],
            layout_mismatches=["structure"] if [p for p, _ in la] != [p for p, _ in lb] else
            [p for (p, t), (_, w) in zip(la, lb) if t.shape != w.shape or t.dtype != w.dtype or not torch.equal(t, w)],
        )
        if not kw.get("ff_levels"):
            _, w_outer, w_cycles, w_hist = _solve_ff(hw, aw, bw_, nw)
            out.update(whole=(w_outer, w_cycles, float(w_hist[w_outer - 1])), whole_hist=w_hist[:w_outer])
    if jax_ref is not None:
        jh, ja, jb = jax_ref
        mine = tensor_leaves(_uncut(local, cut))
        theirs = tensor_leaves(_uncut((jh.levels, jh.transfers, jh.coarse, ja, jb), cut))
        if [p for p, _ in mine] != [p for p, _ in theirs]:
            raise AssertionError("the rank-local build's leaves are not the JAX sharded build's")
        got = [(p, gathered(g, t, w.shape[-1] if w.dim() else 0).numpy()) for (p, t), (_, w) in zip(mine, theirs)]
        out["jax_leaves"] = got if g.rank == 0 else None
        out["jax_cut"] = {}
        for k in cut:
            n_f, n_c = level_size(jh.levels[k]), level_size(jh.levels[k + 1])
            ref = shard_transfer(jh.transfers[k], n_f, n_c, False, g)
            a_, b_ = tensor_leaves(h.transfers[k]), tensor_leaves(ref)
            if [p for p, _ in a_] != [p for p, _ in b_]:
                raise AssertionError(f"transfer {k}: the rank's part is not shard_transfer's form")
            out["jax_cut"][k] = [(p, t.numpy(), w.numpy()) for (p, t), (_, w) in zip(a_, b_)]
    return out


def job_cg_solves(g, h, b, min_blocks):
    """float64 ``multigrid`` and the counts of ``multigrid_mixed`` /
    ``multigrid_progressive`` on the sharded CG-topped hierarchy ``h`` (whole,
    on the CPU), and every level's local width on this rank."""
    from agglomerationmultigrid1d_tpu_torch.models import make_low_precision_hierarchy, multigrid_mixed, multigrid_progressive
    from agglomerationmultigrid1d_tpu_torch.models.hierarchy import CgLevel
    from agglomerationmultigrid1d_tpu_torch.parallel import distributed_multigrid, shard_hierarchy, shard_vector

    hs = shard_hierarchy(h, g, min_blocks_per_device=min_blocks)
    bl = shard_vector(torch.from_numpy(b), g, hs)
    out = _result(distributed_multigrid(hs, torch.zeros_like(bl), bl, 50, 1e-10), hs)
    h32 = make_low_precision_hierarchy(hs)
    for name, fn in (("mixed", multigrid_mixed), ("progressive", multigrid_progressive)):
        res = fn(hs, h32, torch.zeros_like(bl), bl, 60, 1e-10)
        out[name] = (res.iterations, res.inner_cycles)
    out["flags"] = hs.layout.sharded
    out["local"] = [
        (lv.a.band.shape[-1], lv.a.n_el) if isinstance(lv, CgLevel) else (lv.a.n_blocks,) for lv in hs.levels
    ]
    return out


def job_cg_ops(g, h, min_blocks, seed):
    """The CG-level operations on the rank's shards of random vectors,
    gathered: per CG level ``cg_matvec`` and the level's smoother (and both
    Schwarz forms on the first), per CG or seam transfer its prolongation and
    restriction.  Every rank draws the same global vectors."""
    from agglomerationmultigrid1d_tpu_torch.models.hierarchy import CgLevel
    from agglomerationmultigrid1d_tpu_torch.models.solvers import _prolong, _restrict, _smoother_apply, level_matvec
    from agglomerationmultigrid1d_tpu_torch.parallel import node_range, shard_hierarchy, unshard_vector
    from agglomerationmultigrid1d_tpu_torch.smoothers.smoother import cg_smoother

    hs = shard_hierarchy(h, g, min_blocks_per_device=min_blocks)
    rng = np.random.default_rng(seed)
    out = {}

    def whole_vec(lv):
        return rng.standard_normal(lv.a.n_nodes if isinstance(lv, CgLevel) else (lv.a.block_size, lv.a.n_blocks))

    def mine(lv, v):
        lo, hi = node_range(lv.a.n_el, lv.a.p, g) if isinstance(lv, CgLevel) else (None, None)
        t = torch.from_numpy(v)
        return t[lo:hi] if isinstance(lv, CgLevel) else t[..., g.rank * t.shape[-1] // g.world:(g.rank + 1) * t.shape[-1] // g.world]

    def gather(k, t):
        return unshard_vector(t, hs._replace(levels=hs.levels[k:], layout=hs.layout._replace(sharded=hs.layout.sharded[k:]))).numpy()

    for k, (lv, lw) in enumerate(zip(hs.levels, h.levels)):
        if not hs.layout.sharded[k] or not isinstance(lv, CgLevel):
            continue
        v = whole_vec(lw)
        out[f"matvec{k}"] = (v, gather(k, level_matvec(lv, mine(lw, v), g)))
        smoothers = {"own": lv.smoother}
        if k == 0:
            for kind in ("addSchwarz", "hybridSchwarz"):
                sw = cg_smoother(lw.a, kind)
                lo, hi = node_range(lw.a.n_el, lw.a.p, g)
                e0, e1 = g.rank * lw.a.n_el // g.world, (g.rank + 1) * lw.a.n_el // g.world
                smoothers[kind] = sw._replace(
                    inv_windows=sw.inv_windows[..., e0:e1].contiguous(),
                    mult_inv=None if sw.mult_inv is None else sw.mult_inv[lo:hi].contiguous())
        for name, s in smoothers.items():
            out[f"smoother{k}-{name}"] = (v, gather(k, _smoother_apply(s, mine(lw, v), 2.0 / 3.0, g)))
    for k in range(len(h.transfers)):
        if not hs.layout.sharded[k] or not isinstance(hs.levels[k], CgLevel):
            continue
        vc, vf = whole_vec(h.levels[k + 1]), whole_vec(h.levels[k])
        coarse_sharded = hs.layout.sharded[k + 1]
        uc = mine(h.levels[k + 1], vc) if coarse_sharded else torch.from_numpy(vc)
        rc = _restrict(hs, k, mine(h.levels[k], vf))
        out[f"prolong{k}"] = (vc, gather(k, _prolong(hs, k, uc)))
        out[f"restrict{k}"] = (vf, gather(k + 1, rc) if coarse_sharded else rc.numpy())
    return out


# ---------------------------------------------------------------------------
# Block-pentadiagonal and block-COO levels, straddling and scattered transfers
# ---------------------------------------------------------------------------


def job_family_solves(g, h, b, min_blocks, solvers=()):
    """float64 ``multigrid`` (``compute_error=False``) on the sharded
    hierarchy, and each of ``solvers`` ("mixed", "progressive") on it with
    its float32 copy cast after sharding; and the level flags."""
    from agglomerationmultigrid1d_tpu_torch.models import make_low_precision_hierarchy, multigrid_mixed, multigrid_progressive
    from agglomerationmultigrid1d_tpu_torch.parallel import distributed_multigrid, shard_hierarchy, shard_vector

    hs = shard_hierarchy(h, g, min_blocks_per_device=min_blocks)
    bl = shard_vector(torch.from_numpy(b), g, hs)
    out = dict(flags=hs.layout.sharded,
               multigrid=_result(distributed_multigrid(hs, torch.zeros_like(bl), bl, 60, 1e-10, compute_error=False), hs))
    h32 = make_low_precision_hierarchy(hs) if solvers else None
    for name in solvers:
        fn = multigrid_mixed if name == "mixed" else multigrid_progressive
        out[name] = _result(fn(hs, h32, torch.zeros_like(bl), bl, 60, 1e-10), hs)
    return out


def job_family_ops(g, h, min_blocks, vecs):
    """On the sharded hierarchy, from the rank's parts of the whole vectors
    ``vecs`` (``vecs[k]`` of level k's shape): every level's matvec (and a block-pentadiagonal level's float-float defect,
    ``b = 0``, x split from ``vecs[k]``), every transfer's prolongation of
    ``vecs[k + 1]`` and restriction of ``vecs[k]``; each gathered whole."""
    from agglomerationmultigrid1d_tpu_torch.models.hierarchy import CgLevel
    from agglomerationmultigrid1d_tpu_torch.models.solvers import _ff_defect, _group, _prolong, _restrict, level_matvec
    from agglomerationmultigrid1d_tpu_torch.ops import BlockPenta
    from agglomerationmultigrid1d_tpu_torch.ops.df64 import FF, bp5_split, ff_join, ff_split
    from agglomerationmultigrid1d_tpu_torch.parallel import all_gather_cols, local_range, node_range, shard_hierarchy
    from agglomerationmultigrid1d_tpu_torch.parallel.distributed import level_widths

    hs = shard_hierarchy(h, g, min_blocks_per_device=min_blocks)

    def mine(k, v):
        if not hs.layout.sharded[k]:
            return torch.from_numpy(v)
        lv = h.levels[k]
        lo, hi = node_range(lv.a.n_el, lv.a.p, g) if isinstance(lv, CgLevel) else local_range(v.shape[-1], g)
        return torch.from_numpy(v[..., lo:hi])

    def whole(k, t):
        return (all_gather_cols(t, g, level_widths(hs.levels[k], g)) if hs.layout.sharded[k] else t).numpy()

    out = {}
    for k, lv in enumerate(hs.levels):
        out[f"matvec{k}"] = whole(k, level_matvec(lv, mine(k, vecs[k]), _group(hs, k)))
        if isinstance(lv.a, BlockPenta):
            x = ff_split(mine(k, vecs[k]))
            zero = torch.zeros_like(x.hi)
            out[f"ff_defect{k}"] = whole(k, ff_join(_ff_defect(bp5_split(lv.a), x, FF(zero, zero), _group(hs, k))))
    for k in range(len(hs.transfers)):
        out[f"prolong{k}"] = whole(k, _prolong(hs, k, mine(k + 1, vecs[k + 1])))
        out[f"restrict{k}"] = whole(k + 1, _restrict(hs, k, mine(k, vecs[k])))
    out["flags"] = hs.layout.sharded
    return out
