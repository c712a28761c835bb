#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``agglomerationmultigrid1d_tpu_torch``) on
one CUDA card.

    python3 chip_smoke.py

Phases, one line of numbers each:

1. the card: its name, and its name and power limit from ``nvidia-smi``;
2. the CUDA kernels K1-K3, built from ``csrc/block_kernels.cu`` into
   ``build/aggmg_torch_kernels/``, against their plain PyTorch versions on
   the same tensors on the card (to 1e-5 of ``max|out|``), and both timed with
   CUDA events (median of 20 launches after a warm-up);
3. the main path: the 2,097,152-DoF DG-topped problem (DG p=3 on 524,288
   elements, DG p=1, 12 agglomerated levels, dense coarse solve) solved to
   1e-10 by ``multigrid_mixed`` with float32 V-cycles through the kernels;
   the launch counts of that solve show it went through every kernel;
4. the float64 reference entry point ``multigrid`` at 16,384 DoF, and the
   mixed solve of the same problem held against it.

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
SEED = 0


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
        }[name]

    results = {k: {"max_abs_err": 0.0} for k in ("K1", "K2", "K3")}
    for bs, n in SHAPES:
        a, sinv, ml, mu, x, b = kernel_inputs(bs, n, SEED + bs * n)
        runs = {
            "K1": (lambda: bk.multisweep_residual(ml, mu, sinv, a.diag, x, b),
                   lambda: bk.multisweep_residual_plain(ml, mu, sinv, a.diag, x, b)),
            "K2": (lambda: bk.multisweep(ml, mu, sinv, x, b),
                   lambda: bk.multisweep_plain(ml, mu, sinv, x, b)),
            "K3": (lambda: bk.fused_bt_matvec(a, x), lambda: bk.bt_matvec_plain(a, x)),
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
            if (bs, n) == SHAPES[0]:
                r.update(ms=ms, plain_ms=plain_ms, gbps=gbps)
        print(" ".join(line), flush=True)
        del a, sinv, ml, mu, x, b, runs
        torch.cuda.empty_cache()
    return results


def rel_residual(prob, x) -> float:
    """||b - A x|| / ||b|| in float64 on the card, on the float64 fine operator."""
    from agglomerationmultigrid1d_tpu_torch.ops.block_tridiag import bt_matvec

    b = prob.b
    r = b - bt_matvec(prob.hierarchy.levels[0].a, x.to(torch.float64))
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
    check(all(v > 0 for v in launches.values()), f"a kernel was not launched by the solve: {launches}")
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
    check(all(bk.LAUNCHES[k] > before[k] for k in before), "small mixed solve skipped a kernel")


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
    launches = phase_slice(bk)
    phase_reference(bk)

    meta = {
        "K1": ("multisweep_residual", ":510"),
        "K2": ("multisweep", ":495"),
        "K3": ("fused_bt_matvec", ":130"),
    }
    out = []
    for k, (wrapper, line) in meta.items():
        r = kernels[k]
        key = "bt_matvec" if k == "K3" else wrapper
        out.append({
            "name": f"{k} {wrapper}", "route": "cuda", "source": SOURCE,
            "replaces": PALLAS + line, "launches": launches[key],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        })
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
