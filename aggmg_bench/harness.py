"""One run of one cell: resolve it from ``BENCHMARK.json`` and the files it
names, set up, warm up, measure a window of solves, judge the answers
against the plain reference, and return the result line.

A cell names a configuration (``configs/<config>.json``: the builder, its
arguments, the reference module and the discretization it works out again,
the limits of the operator and right-hand-side checks) and a traffic mix
(``traffic/<mix>.json``: the entry point, its arguments, the right-hand
sides drawn from the seed, the warm-up, the sample of answers checked).
Builders, references, entry points and per-layer readers are small
modules found by name under ``builders/``, ``references/``, ``entries/`` and
``metrics/``, so a new cell, mix, configuration, family of operators or
metric is a new file and an entry in ``BENCHMARK.json``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import generator, launches, reference
from . import trace as tracing

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "agglomerationmultigrid1d_tpu")
GIB = float(1 << 30)
FAR = 1e300  # a compared number that is not finite


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(name: str, root: Path = REPO) -> SimpleNamespace:
    """The cell ``name`` of ``root/BENCHMARK.json`` with everything it
    names loaded: its configuration and mix, the builder, reference and
    entry modules, its end-to-end metrics and its per-layer metrics with their
    readers."""
    root = Path(root)
    folder = root / HERE.name
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise ValueError(f"no cell {name!r}; cells: {sorted(cells)}")
    wl = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    mix = json.loads((folder / "traffic" / f"{wl['traffic']}.json").read_text())

    def applies(m):
        return name in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if (applies(m) if "workloads" in m else m["moves"] in e2e_names)]
    return SimpleNamespace(
        name=name,
        chips=int(wl["chips"]),
        config=config,
        mix=mix,
        builder=load_module(folder / "builders" / f"{config['builder']}.py", f"_aggmg_builder_{config['builder']}"),
        reference=reference.load(config["reference"], folder),
        entry=load_module(folder / "entries" / f"{mix['entry']}.py", f"_aggmg_entry_{mix['entry']}"),
        end_to_end=e2e,
        per_layer=[(m, load_module(reader_path(folder, m["name"]), f"_aggmg_metric_{m['name']}")) for m in per_layer],
    )


def reader_path(folder: Path, name: str) -> Path:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or,
    for a quantity split by the end-to-end metric it moves (``x.tag``), the
    shared ``metrics/x.py`` where the split has no reader of its own."""
    own = folder / "metrics" / f"{name}.py"
    return own if own.is_file() or "." not in name else folder / "metrics" / f"{name.split('.')[0]}.py"


def merged(base: dict, over: dict | None) -> dict:
    """``base`` with ``over``'s keys replaced, nested dicts merged."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def to_host(answer) -> torch.Tensor:
    """An entry's answer on the host in float64: a tensor, or a float-float
    ``(hi, lo)`` pair joined there."""
    if isinstance(answer, tuple):
        hi, lo = answer
        return hi.to("cpu", torch.float64) + lo.to("cpu", torch.float64)
    return answer.to("cpu", torch.float64)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def banned_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in BANNED})


def run(cell, seed: int, seconds: float, trace: bool, *, device="cuda", t_start: float | None = None,
        overrides: dict | None = None, program=None) -> tuple:
    """One run of ``cell`` (from :func:`resolve`); returns the result line
    as a dict, and a few more numbers for the log.  ``overrides`` merge
    into the configuration (tests shrink it); ``program`` replaces the
    builder and the entry by one object with both interfaces (the
    control)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cfg = merged(cell.config, overrides)
    mix = cell.mix
    builder = entry = cell.builder if program is None else program
    if program is None:
        entry = cell.entry
        if builder.FORM != entry.FORM:
            raise ValueError(f"builder {cfg['builder']} makes a {builder.FORM!r} problem; "
                             f"entry {mix['entry']} takes {entry.FORM!r}")
    args = mix["args"]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # -- set-up: build, prepare, the right-hand sides, warm-up ----------------
    t0 = time.perf_counter()
    problem = builder.build(cfg, device)
    _sync(device)
    build_s = time.perf_counter() - t0
    state = entry.prepare(problem, args)
    ref_in = cell.reference.Problem(cfg["discretization"], torch.float64, device)  # makes the inputs only
    draws = generator.draws(mix["rhs"], seed)
    rhs = []
    for d in draws:
        b64 = generator.rhs_vector(ref_in, d)
        rhs.append(entry.inputs(state, b64))
        del b64
    entry.warmup(state, rhs[0], args, mix.get("warmup", {}))
    every = int(mix["check_every"])  # 0: the window's last answer alone
    offset = int(np.random.default_rng([int(seed) % 2**64, 1]).integers(max(every, 1)))
    to_host(torch.zeros(1, device=device))  # the copy path's first use
    _sync(device)
    setup_s = time.perf_counter() - t_start

    # -- the window: whole solves until the one that crosses `seconds` -------
    times, cycles, answers = [], [], {}
    t_win = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        ans, cyc = entry.solve(state, rhs[i % len(rhs)], args)
        _sync(device)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        cycles.append(cyc)
        last = t1 - t_win >= seconds
        if last:
            window_s = t1 - t_win
        if (every and (i + offset) % every == 0) or (last and not answers):
            answers[i] = to_host(ans)
        del ans
        i += 1
        if last:
            break
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    # -- the traced run: solves under the profiler, after the window ----------
    rec = SimpleNamespace(build_s=build_s, cycles_per_solve=cycles, trace=None, traced_cycles=0, busy_ns=0,
                          span_ns=0, launches=[])
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with contextlib.ExitStack() as stack:
            if cuda:
                rec.launches = stack.enter_context(launches.Recorder()).records
            with profile(activities=acts) as prof:
                for j in range(int(mix["trace_solves"])):
                    _, cyc = entry.solve(state, rhs[j % len(rhs)], args)
                    rec.traced_cycles += cyc
                _sync(device)
        rec.trace = tracing.collect(prof)
        del prof
        if rec.trace.kernels or rec.trace.copies:
            rec.busy_ns, rec.span_ns = tracing.busy_and_span(rec.trace)

    # -- free the program, then judge it against the reference ----------------
    snap = builder.snapshot(problem)
    del problem, state, rhs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, failed = judge(cell.reference, cfg, mix, draws, snap, answers, device)

    # -- the result line -------------------------------------------------------
    e2e_values = {
        "setup_s": (setup_s, "s"),
        "solve_s": (window_s / len(times), "s"),
        "solve_s.host_bound": (window_s / len(times), "s"),
        "solve_p95_s": (statistics.quantiles(times, n=20)[-1] if len(times) > 1 else times[0], "s"),
        "peak_mem_gib": (peak / GIB, "GiB"),
    }
    metrics = {}
    if trace:
        for m, reader in cell.per_layer:
            v = reader.read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v, unit = e2e_values[m["name"]]
            metrics[m["name"]] = {"value": float(v), "unit": unit}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()) and failed == 0,
           "attempted": len(times), "failed": failed, "metrics": metrics, "device": dev}
    if trace and rec.span_ns:
        dev["busy_s"] = rec.busy_ns / 1e9
        dev["window_s"] = rec.span_ns / 1e9
        out["breakdown"] = {"device_ops": tracing.device_ops(rec.trace), "idle_gaps": tracing.gaps_by_host(rec.trace)}
    out["checks"] = checks
    detail = dict(solves=len(times), cycles=sorted(set(cycles)), answers_checked=len(answers), window_s=window_s,
                  build_s=build_s, solve_min_median_max_s=[min(times), statistics.median(times), max(times)],
                  traced_cycles=rec.traced_cycles)
    return out, detail


def judge(ref_mod, cfg: dict, mix: dict, draws: list, snap: dict, answers: dict, device) -> tuple:
    """The numbers compared, each with its limit, and the count of answers
    that failed: the relative residual ``||b - A x|| / ||b||`` of every
    sampled answer on the operator and right-hand side of the reference
    module ``ref_mod``, in float64, against the mix's tol; and, where the configuration gives them
    a limit, the program's fine operator and right-hand side against the
    reference's (largest gap of a block column over that column's largest
    entry)."""
    ref = ref_mod.Problem(cfg["discretization"], torch.float64, device)
    limits = cfg["limits"]
    gaps = {}
    if "operator_gap" in limits:
        gaps["operator_gap"] = 0.0
        for lo, hi in ref.blocks():
            want = ref.operator_columns(lo, hi)
            got = snap["operator"].columns(lo, hi)
            gaps["operator_gap"] = max(gaps["operator_gap"],
                                       *(reference.max_column_gap(g.to(device), w) for g, w in zip(got, want)))
            del want, got
    if "rhs_gap" in limits:
        p = cfg["problem"]
        src = getattr(torch, p["source"])
        gaps["rhs_gap"] = 0.0
        for lo, hi in ref.blocks():
            want = ref.rhs_columns(src, p["left_value"], p["right_value"], lo, hi)
            gaps["rhs_gap"] = max(gaps["rhs_gap"], reference.max_column_gap(snap["rhs"][:, lo:hi].to(device), want))
    worst, failed = 0.0, 0
    for i, x in sorted(answers.items()):
        d = draws[i % len(draws)]

        def b_of(lo, hi, d=d):
            return ref.rhs_columns(d.source, d.left, d.right, lo, hi)

        res = reference.relative_residual(ref, x, b_of) if bool(torch.isfinite(x).all()) else math.inf
        if not res <= mix["tol"]:
            failed += 1
        worst = max(worst, res)
    if not answers:
        failed += 1
        worst = math.inf
    finite = lambda v: v if v <= FAR else FAR  # noqa: E731  (NaN and inf read as FAR: JSON has no inf)
    checks = {"rel_residual": {"value": finite(worst), "limit": float(mix["tol"])}}
    for k, v in gaps.items():
        checks[k] = {"value": finite(v), "limit": float(limits[k])}
    return checks, failed
