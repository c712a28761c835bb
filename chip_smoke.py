#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``agglomerationmultigrid1d_tpu_torch``) on
one CUDA card.

    python3 chip_smoke.py

Phases, one line of numbers each:

1. the card: its name, and its name and power limit from ``nvidia-smi``;
2. the CUDA kernels K1-K3 and K5 (with and without the residual), built from
   ``csrc/block_kernels.cu`` into ``build/aggmg_torch_kernels/``, against
   their plain PyTorch versions on the same tensors on the card (to 1e-5 of
   ``max|out|``), and both timed with CUDA events (median of 20 launches after
   a warm-up);
3. the DG-topped path: the 2,097,152-DoF problem (DG p=3 on 524,288
   elements, DG p=1, 12 agglomerated levels, dense coarse solve) solved to
   1e-10 by ``multigrid_mixed`` with float32 V-cycles through K1-K3; the
   launch counts of that solve show it went through every kernel;
4. the float64 reference entry point ``multigrid`` at 16,384 DoF, and the
   mixed solve of the same problem held against it;
5. the Chebyshev path: the same 2,097,152-DoF problem under
   ``chebyshev_hierarchy`` (a power iteration per level), solved to 1e-10 by
   ``multigrid_mixed`` through K5 on every block level;
6. the CG-topped flagship ``poisson_full_hierarchy(n=16384)`` (131,073 DoF;
   CG p = 8, 4, 2, 1, then 13 agglomerated levels): float64 ``multigrid`` and
   ``multigrid_mixed``, each with damped and with Chebyshev smoothing;
7. the 1e8-DoF north star (``examples/xl_north_star.py``): 50,331,648 DG p=1
   elements (100,663,296 DoF), 6 agglomerated levels at 4:1, c_dir = 1000 n,
   built by ``build_xl_problem(..., slim_fine=True, ff_levels=True)`` on the
   card and solved to 1e-8 by ``multigrid_true``, whose fine-level defects go
   through K6 (7 launches per V-cycle); the relative residual is recomputed
   independently in float64 from the materialized fine operator.

The kernel phase also holds K6 (the float-float stencil defect) to its plain
version bit for bit, hi and lo.

Then a JSON line with the kernels' numbers, and last a JSON line with the
device.  Any failure raises, and the exit code is non-zero; without a CUDA
device the script exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

SOURCE = "agglomerationmultigrid1d_tpu_torch/csrc/block_kernels.cu"
PALLAS = "agglomerationmultigrid1d_tpu/ops/pallas/block_kernels.py"
# (bs, n): the headline shape of 16,777,216 DoF, the main path's level shapes
# from the finest down to the smallest smoothed level, and an awkward size
SHAPES = [(4, 4194304), (4, 524288), (2, 524288), (2, 131072), (2, 128), (4, 1000)]
TOL = 1e-5  # of max|out|: float32 kernels with FMA against unfused plain torch
SLICE = dict(n=524288, max_p=3, n_dg=2, n_agg=12)
SMALL = dict(n=4096, max_p=3, n_dg=2, n_agg=5)
FLAGSHIP_N = 16384
SEED = 0
DAMPED = ("bt_matvec", "multisweep", "multisweep_residual")  # K3, K2, K1: the damped solves' kernels
CHEB_INTERVAL = (0.3, 1.2)  # K5's coefficients in the kernel phase, k = 3
# K6's (bs, n): the north star's fine level, the JAX test's shape, the width of
# K1-K3's headline, an awkward size
K6_SHAPES = [(2, 50331648), (2, 16384), (4, 4194304), (2, 1000)]
K6_BW = 4  # boundary columns of the stencil, as the setup extracts them
NORTH_STAR_N = 50331648  # DG p=1 elements: 100,663,296 DoF
NORTH_STAR_JAX_CYCLES = 15  # BENCH_r05.json (cycles do not depend on the hardware)
# iterations of the JAX package on the CPU at the same sizes (its
# multigrid_mixed with use_pallas=False), for comparison
JAX_CPU = {
    "slice_cheb": "15 outer / 19 inner (BENCH_r05.json: 19 V-cycles)",
    "flagship_f64": "12", "flagship_f64_cheb": "7",
    "flagship_mixed": "14 outer / 20 inner", "flagship_mixed_cheb": "13 outer / 18 inner",
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def time_ms(fn, reps: int = 20) -> float:
    """Median device time of one call, from CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_inputs(bs: int, n: int, seed: int):
    """Random diagonally dominant block-tridiagonal operator with S^-1 the
    exact inverse of A_D (as tests/test_pallas.py builds them), on the card."""
    from agglomerationmultigrid1d_tpu_torch.ops.block_tridiag import BlockTridiag, block_mul

    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    l, u = rnd(bs, bs, n), rnd(bs, bs, n)
    l[:, :, 0] = 0
    u[:, :, -1] = 0
    d = rnd(bs, bs, n) + 5 * torch.eye(bs, device="cuda")[:, :, None]
    sinv = torch.linalg.inv(d.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    x, b = rnd(bs, n), rnd(bs, n)
    return BlockTridiag(l, d, u), sinv, block_mul(sinv, l), block_mul(sinv, u), x, b


def phase_kernels(bk) -> dict:
    # floats per block column (in + out), the bytes each kernel must move
    def col_bytes(name, bs):
        return 4 * {
            "K1": 4 * bs * bs + 2 * bs + 2 * bs,
            "K2": 3 * bs * bs + 2 * bs + bs,
            "K3": 3 * bs * bs + bs + bs,
            "K5": 3 * bs * bs + 2 * bs + bs,
            "K5r": 4 * bs * bs + 2 * bs + 2 * bs,
        }[name]

    coef = bk.chebyshev_coefficients(*CHEB_INTERVAL, 3)
    results = {k: {"max_abs_err": 0.0} for k in ("K1", "K2", "K3", "K5", "K5r")}
    for bs, n in SHAPES:
        a, sinv, ml, mu, x, b = kernel_inputs(bs, n, SEED + bs * n)
        runs = {
            "K1": (lambda: bk.multisweep_residual(ml, mu, sinv, a.diag, x, b),
                   lambda: bk.multisweep_residual_plain(ml, mu, sinv, a.diag, x, b)),
            "K2": (lambda: bk.multisweep(ml, mu, sinv, x, b),
                   lambda: bk.multisweep_plain(ml, mu, sinv, x, b)),
            "K3": (lambda: bk.fused_bt_matvec(a, x), lambda: bk.bt_matvec_plain(a, x)),
            "K5": (lambda: bk.chebyshev_multisweep(ml, mu, sinv, x, b, coef),
                   lambda: bk.chebyshev_multisweep_plain(ml, mu, sinv, x, b, coef)),
            "K5r": (lambda: bk.chebyshev_multisweep_residual(ml, mu, sinv, a.diag, x, b, coef),
                    lambda: bk.chebyshev_multisweep_residual_plain(ml, mu, sinv, a.diag, x, b, coef)),
        }
        line = [f"kernels bs={bs} n={n}:"]
        for name, (kern, plain) in runs.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(float((g_ - w_).abs().max()) for g_, w_ in zip(got, want))
            scale = max(float(w_.abs().max()) for w_ in want)
            check(all(bool(torch.isfinite(g_).all()) for g_ in got), f"{name} non-finite at {bs},{n}")
            check(err <= TOL * scale, f"{name} differs from plain at bs={bs} n={n}: {err} > {TOL} * {scale}")
            ms, plain_ms = time_ms(kern), time_ms(plain)
            gbps = col_bytes(name, bs) * n / (ms * 1e-3) / 1e9
            line.append(
                f"{name} err={err:.3e} (rel {err / scale:.2e}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"GB/s={gbps:.1f} plain_GB/s={col_bytes(name, bs) * n / (plain_ms * 1e-3) / 1e9:.1f};"
            )
            r = results[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r[(bs, n)] = (ms, plain_ms)
            if (bs, n) == SHAPES[0]:
                r.update(ms=ms, plain_ms=plain_ms, gbps=gbps)
        print(" ".join(line), flush=True)
        del a, sinv, ml, mu, x, b, runs
        torch.cuda.empty_cache()
    return results


def phase_k6(bk) -> dict:
    """K6 against its plain version, bit for bit, on random stencils with
    boundary columns; both timed with CUDA events."""
    out = {"max_abs_err": 0.0}
    for bs, n in K6_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(SEED + 7 * bs + n)
        rnd = lambda *s, scale=1.0: scale * torch.randn(*s, generator=g, device="cuda")  # noqa: E731
        blocks = torch.stack([rnd(3, bs, bs, 2 * K6_BW + 1, scale=1e3),
                              rnd(3, bs, bs, 2 * K6_BW + 1, scale=1e-4)]).contiguous()
        x_hi, x_lo = rnd(bs, n), rnd(bs, n, scale=1e-8)
        b_hi, b_lo = rnd(bs, n, scale=1e3), rnd(bs, n, scale=1e-5)
        args = (blocks, x_hi, x_lo, b_hi, b_lo)
        got, want = bk.ff_stencil_mid_defect(*args), bk.ff_stencil_mid_defect_plain(*args)
        torch.cuda.synchronize()
        err = max(float((got_ - want_).abs().max()) for got_, want_ in zip(got, want))
        n_diff = sum(int((got_ != want_).sum()) for got_, want_ in zip(got, want))
        check(all(bool(torch.isfinite(t).all()) for t in got), f"K6 non-finite at {bs},{n}")
        check(n_diff == 0, f"K6 differs from plain at bs={bs} n={n}: {n_diff} elements, max {err}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        del got, want
        ms = time_ms(lambda: bk.ff_stencil_mid_defect(*args))
        plain_ms = time_ms(lambda: bk.ff_stencil_mid_defect_plain(*args), reps=5)
        gbps = 24 * bs * n / (ms * 1e-3) / 1e9  # x and b pairs in, r pair out
        print(f"K6 bs={bs} n={n}: bit-exact (hi and lo) ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"GB/s={gbps:.1f}", flush=True)
        out[(bs, n)] = (ms, plain_ms)
        if (bs, n) == K6_SHAPES[0]:
            out.update(ms=ms, plain_ms=plain_ms, gbps=gbps)
        del args, blocks, x_hi, x_lo, b_hi, b_lo
        torch.cuda.empty_cache()
    return out


def phase_north_star(bk) -> int:
    """The 100,663,296-DoF north star: build on the card, one warm-up cycle,
    then the solve to 1e-8; returns the solve's K6 launches."""
    from agglomerationmultigrid1d_tpu_torch.models import build_xl_problem, default_stencil_factor, multigrid_true
    from agglomerationmultigrid1d_tpu_torch.ops.block_tridiag import BlockTridiag, bt_matvec
    from agglomerationmultigrid1d_tpu_torch.ops.coarse_solve import BTCoarseSolver
    from agglomerationmultigrid1d_tpu_torch.ops.df64 import ff_join
    from agglomerationmultigrid1d_tpu_torch.utils.config import HierarchySpec

    n = NORTH_STAR_N
    spec = HierarchySpec(cg_orders=(), dg_orders=(1,), n_agg_levels=6, p_agg=1, agg_factor=4,
                         c_dir=1000.0 * n)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    t0 = time.perf_counter()
    h, ffops, b_ff, norm_b = build_xl_problem(spec, n, slim_fine=True, ff_levels=True, device="cuda",
                                              timings=timings)
    setup_s = time.perf_counter() - t0
    coarse = ffops.coarse64
    blocks_c = h.levels[-1].a.n_blocks
    print(f"north star {2 * n} DoF: setup_s={setup_s:.3f} (host stencil {timings['host_stencil']:.3f}, "
          f"inflation {timings['inflate']:.3f}, device rhs {timings['rhs']:.3f}); levels={h.n_levels} "
          f"coarsest={blocks_c} blocks ({type(coarse).__name__}); stencil factor z={default_stencil_factor(spec, n)}",
          flush=True)
    check(h.n_levels == 7 and blocks_c == 12288 and isinstance(coarse, BTCoarseSolver), "north star shape")

    t0 = time.perf_counter()
    multigrid_true(h, ffops, b_ff, norm_b, 1, 1e-8)  # warm-up: one V-cycle
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    bk.reset_launch_counts()
    t0 = time.perf_counter()
    res = multigrid_true(h, ffops, b_ff, norm_b, 40, 1e-8)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    k6 = bk.LAUNCHES["ff_stencil_mid_defect"]
    peak = torch.cuda.max_memory_allocated()
    it = res.iterations
    hist = (res.res_history[:it] / norm_b).tolist()

    # independent check: the fine operator materialized in float64 from the
    # stencil (hi + lo joined, interior broadcast, boundary columns spliced)
    st = ffops.a_ffs[0]

    def full(name):
        parts = []
        for side, reps in (("left", 1), ("mid", n - 2 * st.bw), ("right", 1)):
            v = getattr(getattr(st, "hi_" + side), name).double() + getattr(getattr(st, "lo_" + side), name).double()
            parts.append(v.expand(*v.shape[:-1], reps) if side == "mid" else v)
        return torch.cat(parts, dim=-1)

    x = res.x
    del ffops, h
    b64 = ff_join(b_ff)
    a64 = BlockTridiag(lower=full("lower"), diag=full("diag"), upper=full("upper"))
    rel = float(torch.linalg.vector_norm(b64 - bt_matvec(a64, x)) / torch.linalg.vector_norm(b64))
    del a64, b64
    print(f"north star solve: cycles={it} (JAX: {NORTH_STAR_JAX_CYCLES}, BENCH_r05.json) "
          f"solve_s={solve_s:.3f} warmup_cycle_s={warm_s:.3f} rel_residual_f64={rel:.3e} "
          f"K6_launches={k6} peak_mem_bytes={peak} res_history={[f'{v:.3e}' for v in hist]}",
          flush=True)
    check(tuple(x.shape) == (2, n) and bool(torch.isfinite(x).all()), "north star x")
    check(rel < 1e-8, f"north star relative residual {rel:.3e} >= 1e-8")
    check(k6 == 7 * it, f"K6 launched {k6} times in {it} cycles, expected {7 * it}")
    del res, x
    torch.cuda.empty_cache()
    return k6


def rel_residual(prob, x) -> float:
    """||b - A x|| / ||b|| in float64 on the card, on the float64 fine operator."""
    from agglomerationmultigrid1d_tpu_torch.models.solvers import level_matvec

    b = prob.b
    r = b - level_matvec(prob.hierarchy.levels[0], x.to(torch.float64))
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))


def phase_slice(bk) -> dict:
    from agglomerationmultigrid1d_tpu_torch.models import (
        make_low_precision_hierarchy,
        multigrid_mixed,
        poisson_dg_hierarchy,
    )

    t0 = time.perf_counter()
    prob = poisson_dg_hierarchy(**SLICE, device="cuda")
    h32 = make_low_precision_hierarchy(prob.hierarchy)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b = prob.b
    check(prob.hierarchy.n_levels == 14 and prob.hierarchy.coarse.n == 128, "slice shape")

    t0 = time.perf_counter()
    multigrid_mixed(prob.hierarchy, h32, torch.zeros_like(b), b, 80, 1e-10)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    bk.reset_launch_counts()
    t0 = time.perf_counter()
    res = multigrid_mixed(prob.hierarchy, h32, torch.zeros_like(b), b, 80, 1e-10)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = dict(bk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    rel = rel_residual(prob, res.x)
    print(
        f"slice {b.numel()} DoF, {prob.hierarchy.n_levels} levels: setup_s={setup_s:.3f} "
        f"first_solve_s={first_s:.3f} solve_s={solve_s:.3f} outer={res.iterations} "
        f"inner_cycles={res.inner_cycles} rel_residual={rel:.3e} launches={launches} "
        f"peak_mem_bytes={peak} (JAX on the CPU at this size: 21 outer / 27 inner; "
        f"BENCH_r05.json: 28 inner)",
        flush=True,
    )
    check(tuple(res.x.shape) == (4, SLICE["n"]) and bool(torch.isfinite(res.x).all()), "slice x")
    check(rel < 1e-10, f"slice relative residual {rel:.3e} >= 1e-10")
    check(all(launches[k] > 0 for k in DAMPED), f"a kernel was not launched by the solve: {launches}")
    return launches


def phase_reference(bk) -> None:
    from agglomerationmultigrid1d_tpu_torch.models import (
        make_low_precision_hierarchy,
        multigrid,
        multigrid_mixed,
        poisson_dg_hierarchy,
    )

    prob = poisson_dg_hierarchy(**SMALL, device="cuda")
    b = prob.b
    ref = multigrid(prob.hierarchy, torch.zeros_like(b), b, 80, 1e-10, compute_error=False)
    rel_ref = rel_residual(prob, ref.x)
    h32 = make_low_precision_hierarchy(prob.hierarchy)
    before = dict(bk.LAUNCHES)
    mixed = multigrid_mixed(prob.hierarchy, h32, torch.zeros_like(b), b, 80, 1e-10)
    rel_mixed = rel_residual(prob, mixed.x)
    diff = float((mixed.x - ref.x).abs().max())
    print(
        f"reference {b.numel()} DoF: multigrid f64 iterations={ref.iterations} "
        f"rel_residual={rel_ref:.3e}; multigrid_mixed outer={mixed.iterations} "
        f"inner_cycles={mixed.inner_cycles} rel_residual={rel_mixed:.3e} "
        f"max|x_mixed - x_f64|={diff:.3e}",
        flush=True,
    )
    check(rel_ref < 1e-10, f"f64 multigrid relative residual {rel_ref:.3e}")
    check(rel_mixed < 1e-10, f"small mixed relative residual {rel_mixed:.3e}")
    check(diff < 1e-4, f"mixed and f64 solutions differ by {diff:.3e}")
    check(all(bk.LAUNCHES[k] > before[k] for k in DAMPED), "small mixed solve skipped a kernel")


def phase_chebyshev(bk) -> dict:
    """The DG-topped Chebyshev mixed solve at full width; returns its K5 launches."""
    from agglomerationmultigrid1d_tpu_torch.models import (
        chebyshev_hierarchy,
        make_low_precision_hierarchy,
        multigrid_mixed,
        poisson_dg_hierarchy,
    )

    t0 = time.perf_counter()
    prob = poisson_dg_hierarchy(**SLICE, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    h = chebyshev_hierarchy(prob.hierarchy)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    h32 = make_low_precision_hierarchy(h)
    torch.cuda.synchronize()
    setup_s, lam_s = time.perf_counter() - t0, t2 - t1
    b = prob.b

    t0 = time.perf_counter()
    multigrid_mixed(h, h32, torch.zeros_like(b), b, 80, 1e-10)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    bk.reset_launch_counts()
    t0 = time.perf_counter()
    res = multigrid_mixed(h, h32, torch.zeros_like(b), b, 80, 1e-10)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = dict(bk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    rel = rel_residual(prob, res.x)
    print(
        f"chebyshev {b.numel()} DoF, {h.n_levels} levels: setup_s={setup_s:.3f} "
        f"(lambda estimation {lam_s:.3f}) first_solve_s={first_s:.3f} solve_s={solve_s:.3f} "
        f"outer={res.iterations} inner_cycles={res.inner_cycles} rel_residual={rel:.3e} "
        f"launches={launches} peak_mem_bytes={peak} (JAX on the CPU at this size: "
        f"{JAX_CPU['slice_cheb']})",
        flush=True,
    )
    check(tuple(res.x.shape) == (4, SLICE["n"]) and bool(torch.isfinite(res.x).all()), "chebyshev x")
    check(rel < 1e-10, f"chebyshev relative residual {rel:.3e} >= 1e-10")
    k5 = {k: launches[k] for k in ("chebyshev_multisweep", "chebyshev_multisweep_residual")}
    check(all(v > 0 for v in k5.values()), f"K5 was not launched by the Chebyshev solve: {launches}")
    return k5


def phase_flagship(bk) -> None:
    from agglomerationmultigrid1d_tpu_torch.models import (
        chebyshev_hierarchy,
        make_low_precision_hierarchy,
        multigrid,
        multigrid_mixed,
        poisson_full_hierarchy,
    )

    t0 = time.perf_counter()
    prob = poisson_full_hierarchy(n=FLAGSHIP_N, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    h = prob.hierarchy
    check(h.n_levels == 17 and tuple(prob.b.shape) == (8 * FLAGSHIP_N + 1,), "flagship shape")
    b = prob.b
    line = [f"flagship {b.numel()} DoF, {h.n_levels} levels: setup_s={setup_s:.3f};"]
    for cheb in (False, True):
        hh = chebyshev_hierarchy(h) if cheb else h
        tag = "_cheb" if cheb else ""
        t0 = time.perf_counter()
        ref = multigrid(hh, torch.zeros_like(b), b, 100, 1e-10, compute_error=False)
        torch.cuda.synchronize()
        f64_s = time.perf_counter() - t0
        rel_ref = rel_residual(prob, ref.x)
        h32 = make_low_precision_hierarchy(hh)
        bk.reset_launch_counts()
        t0 = time.perf_counter()
        mixed = multigrid_mixed(hh, h32, torch.zeros_like(b), b, 80, 1e-10)
        torch.cuda.synchronize()
        mixed_s = time.perf_counter() - t0
        launches = dict(bk.LAUNCHES)
        rel_mixed = rel_residual(prob, mixed.x)
        line.append(
            f"{'chebyshev' if cheb else 'damped'}: f64 iterations={ref.iterations} "
            f"(JAX on the CPU: {JAX_CPU['flagship_f64' + tag]}) rel_residual={rel_ref:.3e} "
            f"first_solve_s={f64_s:.3f}; mixed outer={mixed.iterations} inner_cycles={mixed.inner_cycles} "
            f"(JAX on the CPU: {JAX_CPU['flagship_mixed' + tag]}) rel_residual={rel_mixed:.3e} "
            f"first_solve_s={mixed_s:.3f} launches={launches};"
        )
        check(rel_ref < 1e-10, f"flagship f64{tag} relative residual {rel_ref:.3e}")
        check(rel_mixed < 1e-10, f"flagship mixed{tag} relative residual {rel_mixed:.3e}")
        used = ("chebyshev_multisweep", "chebyshev_multisweep_residual") if cheb else (
            "multisweep", "multisweep_residual")
        check(all(launches[k] > 0 for k in used), f"flagship mixed{tag} skipped a kernel: {launches}")
    print(" ".join(line), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from agglomerationmultigrid1d_tpu_torch.ops.kernels import block_kernels as bk

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card {name}; torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    t0 = time.perf_counter()
    so = bk.build()
    print(f"build {time.perf_counter() - t0:.1f} s -> {so.name}", flush=True)

    kernels = phase_kernels(bk)
    kernels["K6"] = phase_k6(bk)
    launches = phase_slice(bk)
    phase_reference(bk)
    launches.update(phase_chebyshev(bk))
    phase_flagship(bk)
    launches["ff_stencil_mid_defect"] = phase_north_star(bk)

    meta = {  # kernel: (label, wrapper, launch counter, line of the Pallas wrapper)
        "K1": ("K1", "multisweep_residual", "multisweep_residual", ":510"),
        "K2": ("K2", "multisweep", "multisweep", ":495"),
        "K3": ("K3", "fused_bt_matvec", "bt_matvec", ":130"),
        "K5": ("K5", "chebyshev_multisweep", "chebyshev_multisweep", ":422"),
        "K5r": ("K5", "chebyshev_multisweep_residual", "chebyshev_multisweep_residual", ":422"),
        "K6": ("K6", "ff_stencil_mid_defect", "ff_stencil_mid_defect", ":621"),
    }
    out = []
    for k, (label, wrapper, counter, line) in meta.items():
        r = kernels[k]
        out.append({
            "name": f"{label} {wrapper}", "route": "cuda", "source": SOURCE,
            "replaces": PALLAS + line, "launches": launches[counter],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        })
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
