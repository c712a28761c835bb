"""The spans of the port's solvers (``utils.profiling.span``) under
``torch.profiler`` on the CPU: ``aggmg.solve.<driver>``,
``aggmg.vcycle.<kind>``, the four phases ``aggmg.smooth@k``,
``aggmg.transfer@k``, ``aggmg.coarse`` and ``aggmg.defect@k``, and
``aggmg.sync.<site>`` around each host read, ``aggmg.cg@k`` /
``aggmg.bcoo@k`` around the work on a CG / block-COO level inside its phase
spans, and ``aggmg.schwarz@k`` around each Schwarz apply on CG level ``k``
inside its ``aggmg.cg@k``.  Five drivers on tiny problems, and
``multigrid_mixed`` on a scattered chain (``poisson_scattered_hierarchy``,
block-COO levels):
``multigrid`` and ``multigrid_mixed`` on ``poisson_dg_hierarchy``,
``multigrid_true`` and the hand-over ``_mixed_loop_ff(ffops=)`` on a
DG-topped ``build_xl_problem(..., ff_levels=True)`` bundle, the hand-over on
a CG-topped one (float32 ``v_cycle`` and ``v_cycle_true``), and
``multigrid_progressive`` (``v_cycle_ff``) on ``poisson_full_hierarchy``;
the CG-topped hand-over and ``multigrid_progressive`` again with hybrid
Schwarz on the CG levels (the hand-over under Chebyshev and damped)."""

import bisect
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from agglomerationmultigrid1d_tpu_torch.models import (
    build_problem,
    build_xl_problem,
    make_low_precision_hierarchy,
    multigrid,
    multigrid_mixed,
    multigrid_progressive,
    multigrid_true,
    interleaved_pair_groups,
    poisson_dg_hierarchy,
    poisson_scattered_hierarchy,
)
from agglomerationmultigrid1d_tpu_torch.models.solvers import _mixed_loop_ff
from agglomerationmultigrid1d_tpu_torch.ops.df64 import FF
from agglomerationmultigrid1d_tpu_torch.utils.config import HierarchySpec

PHASES = ("smooth", "transfer", "coarse", "defect")
XL_N = 1024
XL_SPEC = dict(cg_orders=(), dg_orders=(1,), n_agg_levels=4, p_agg=1, c_dir=1000.0 * XL_N)
XL_CG_SPEC = dict(cg_orders=(8, 4, 2, 1), n_agg_levels=2, p_agg=1, c_dir=1000.0 * XL_N)


def _slice(n):
    return poisson_dg_hierarchy(n=n, max_p=3, n_dg=2, n_agg=2, device="cpu")


def _xl():
    return build_xl_problem(HierarchySpec(**XL_SPEC), XL_N, slim_fine=True, ff_levels=True, device="cpu")


def _multigrid():
    prob = _slice(32)

    def solve():
        res = multigrid(prob.hierarchy, torch.zeros_like(prob.b), prob.b, 40, 1e-10)
        return res.iterations, {"f64": res.iterations}

    return "multigrid", prob.hierarchy.n_levels, solve


def _multigrid_mixed():
    prob = _slice(64)
    h_low = make_low_precision_hierarchy(prob.hierarchy)

    def solve():
        res = multigrid_mixed(prob.hierarchy, h_low, torch.zeros_like(prob.b), prob.b, 40, 1e-10)
        return res.inner_cycles, {"f32": res.inner_cycles}

    return "multigrid_mixed", h_low.n_levels, solve


def _multigrid_true():
    h, ffops, b, norm_b = _xl()

    def solve():
        res = multigrid_true(h, ffops, b, norm_b, 12, 1e-10)
        return res.iterations, {"true": res.iterations}

    return "multigrid_true", h.n_levels, solve


def _handover(xl=_xl, tol=1e-9, maxiter=40):
    """``inner_tol`` 0.5: the guard trickles and hands over to true cycles."""
    h, ffops, b, norm_b = xl()
    z = torch.zeros_like(b.hi)

    def solve():
        info = {}
        _, _, cycles, _ = _mixed_loop_ff(h, ffops.a_ffs[0], FF(z, z), b, np.float32(1.0 / norm_b), maxiter=maxiter,
                                         tol=tol, inner_tol=0.5, max_inner=20, ffops=ffops, info=info)
        assert info["true_cycles"] > 0 and info["guarded_cycles"] > 0
        return cycles, {"f32": info["guarded_cycles"], "true": info["true_cycles"]}

    return "_mixed_loop_ff", h.n_levels, solve


def _handover_cg():
    """tol 1e-13: the CG chain's guard reaches 1e-9 alone, and trickles at ~4e-13."""
    return _handover(lambda: build_xl_problem(HierarchySpec(**XL_CG_SPEC), XL_N, ff_levels=True, device="cpu"),
                     tol=1e-13, maxiter=16)


def _handover_cg_schwarz(chebyshev=True):
    """:func:`_handover_cg` with hybrid Schwarz on the CG levels."""
    spec = HierarchySpec(**XL_CG_SPEC, cg_smoother="hybridSchwarz")
    return _handover(lambda: build_xl_problem(spec, XL_N, chebyshev=chebyshev, ff_levels=True, device="cpu"),
                     tol=1e-13, maxiter=16)


def _progressive_cg(cg_smoother="jac"):
    spec = HierarchySpec(cg_orders=(8, 4, 2, 1), n_agg_levels=4, c_dir=1000.0 * 32, cg_smoother=cg_smoother)
    prob = build_problem(spec, 32, device="cpu")  # poisson_full_hierarchy(n=32)'s chain
    h_low = make_low_precision_hierarchy(prob.hierarchy)

    def solve():
        res = multigrid_progressive(prob.hierarchy, h_low, torch.zeros_like(prob.b), prob.b, 40, 1e-10)
        return res.iterations, {"ff": res.iterations}

    return "multigrid_progressive", h_low.n_levels, solve


def _scattered_mixed():
    """DG p = 1 on 256 elements, then 5 block-COO levels (128 -> 8 agglomerates)."""
    prob = poisson_scattered_hierarchy(n=256, p_dg=1, groups_per_level=interleaved_pair_groups(256, 8),
                                       device="cpu")
    h_low = make_low_precision_hierarchy(prob.hierarchy)

    def solve():
        res = multigrid_mixed(prob.hierarchy, h_low, torch.zeros_like(prob.b), prob.b, 40, 1e-10)
        return res.inner_cycles, {"f32": res.inner_cycles}

    return "multigrid_mixed", h_low.n_levels, solve


SCHWARZ_CASES = {"handover_cg_schwarz": _handover_cg_schwarz,
                 "handover_cg_schwarz_damped": functools.partial(_handover_cg_schwarz, chebyshev=False),
                 "progressive_cg_schwarz": functools.partial(_progressive_cg, "hybridSchwarz")}
CASES = {"multigrid": _multigrid, "multigrid_mixed": _multigrid_mixed, "multigrid_true": _multigrid_true,
         "handover": _handover, "handover_cg": _handover_cg, "progressive_cg": _progressive_cg,
         "scattered_mixed": _scattered_mixed, **SCHWARZ_CASES}
CG_LEVELS = {"handover_cg": 4, "progressive_cg": 4, **dict.fromkeys(SCHWARZ_CASES, 4)}  # CG p = 8, 4, 2, 1 on top
BCOO_LEVELS = {"scattered_mixed": range(1, 6)}  # levels 1-5 block-COO, level 5 the coarsest; the others none


@functools.lru_cache(maxsize=None)
def _traced(case):
    """One solve of ``case`` under the profiler: its kineto events as
    ``(name, start, end, is_user_annotation)``, sorted by start."""
    driver, n_levels, solve = CASES[case]()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cycles, kinds = solve()
    events = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.is_user_annotation())
                     for e in prof.profiler.kineto_results.events()), key=lambda e: e[1])
    return SimpleNamespace(driver=driver, n_levels=n_levels, cycles=cycles, kinds=kinds, events=events)


def _named(tr, prefix):
    return [e for e in tr.events if e[0].startswith(prefix)]


def _phase(name):
    p = name.removeprefix("aggmg.").split("@")[0]
    return p if name.startswith("aggmg.") and p in PHASES else None


@pytest.mark.parametrize("case", CASES)
def test_spans_are_cpu_ops_not_annotations(case):
    tr = _traced(case)
    spans = _named(tr, "aggmg.")
    assert spans and not any(e[3] for e in spans)
    assert [e[0] for e in _named(tr, "aggmg.solve.")] == [f"aggmg.solve.{tr.driver}"]


@pytest.mark.parametrize("case", CASES)
def test_one_vcycle_span_per_cycle(case):
    tr = _traced(case)
    assert tr.cycles > 0 and len(_named(tr, "aggmg.vcycle.")) == tr.cycles
    for kind, n in tr.kinds.items():
        assert len(_named(tr, f"aggmg.vcycle.{kind}")) == n, kind


@pytest.mark.parametrize("case", CASES)
def test_each_level_smooths_and_transfers_twice_a_cycle(case):
    tr = _traced(case)
    for k in range(tr.n_levels - 1):
        assert len(_named(tr, f"aggmg.smooth@{k}")) == 2 * tr.cycles, k
        assert len(_named(tr, f"aggmg.transfer@{k}")) == 2 * tr.cycles, k
    assert not _named(tr, f"aggmg.smooth@{tr.n_levels - 1}")
    assert len([e for e in tr.events if e[0] == "aggmg.coarse"]) == tr.cycles


def _cycle_phases(n_levels, fused):
    """The phase spans of one V-cycle on ``n_levels`` levels, in order: down
    smooth (then a defect unless the residual is ``fused`` into the
    smoothing) and restrict, the coarse solve, up prolong and smooth."""
    down = [p for k in range(n_levels - 1)
            for p in (f"aggmg.smooth@{k}", *(() if fused else (f"aggmg.defect@{k}",)), f"aggmg.transfer@{k}")]
    up = [p for k in reversed(range(n_levels - 1)) for p in (f"aggmg.transfer@{k}", f"aggmg.smooth@{k}")]
    return [*down, "aggmg.coarse", *up]


@pytest.mark.parametrize("case", CASES)
def test_phase_sequence_within_each_vcycle(case):
    """Inside every ``aggmg.vcycle.<kind>`` span the phases come in the one
    V-cycle order, by name and level: a native (``f32`` / ``f64``) cycle has
    its residual fused into the pre-smoothing and opens no ``defect@k``; a
    float-float (``ff``) or TRUE-precision (``true``) cycle opens one after
    each pre-smoothing."""
    tr = _traced(case)
    cycles = _named(tr, "aggmg.vcycle.")
    assert len(cycles) == tr.cycles
    for name, t0, t1, _ in cycles:
        got = [e[0] for e in tr.events if _phase(e[0]) and t0 <= e[1] and e[2] <= t1]
        assert got == _cycle_phases(tr.n_levels, fused=name.split(".")[-1] in ("f32", "f64")), name


@pytest.mark.parametrize("case", CASES)
def test_one_sync_span_per_host_read(case):
    """Every host read (``aten::_local_scalar_dense``, what ``float(t)``
    runs) lies in an ``aggmg.sync.*`` span, one read a span."""
    tr = _traced(case)
    syncs = _named(tr, "aggmg.sync.")
    reads = [e for e in tr.events if e[0] == "aten::_local_scalar_dense"]
    assert syncs and len(syncs) == len(reads)
    for name, t0, t1, _ in syncs:
        assert sum(t0 <= r[1] and r[2] <= t1 for r in reads) == 1, name
    if case == "multigrid":  # ||b||, then the residual and the error after each cycle
        assert len(syncs) == 1 + 2 * tr.cycles


@pytest.mark.parametrize("case", CASES)
def test_phase_spans_enclose_their_operators(case):
    """The phases never nest, never hold a host read, and each holds the
    operators it starts, to their ends (one clock)."""
    tr = _traced(case)
    phases = [e for e in tr.events if _phase(e[0])]
    assert {_phase(e[0]) for e in phases} == set(PHASES)
    for a, b in zip(phases, phases[1:]):
        assert a[2] <= b[1], (a[0], b[0])
    held, i = [0] * len(phases), 0
    for name, t0, t1, _ in tr.events:
        if not name.startswith("aten::"):
            continue
        while i < len(phases) and phases[i][2] < t0:
            i += 1
        if i < len(phases) and phases[i][1] <= t0:
            assert t1 <= phases[i][2] and name != "aten::_local_scalar_dense", (phases[i][0], name)
            held[i] += 1
    assert all(held)


def _check_family_spans(tr, prefix, levels):
    """The ``<prefix>k`` spans of ``tr`` open inside the phase spans of the
    levels ``k`` in ``levels``, exactly one in each such phase span and
    none in any other; none lies outside a phase span or in another."""
    marked = _named(tr, prefix)
    assert {int(e[0].split("@")[1]) for e in marked} == set(levels) - {tr.n_levels - 1}
    for a, b in zip(marked, marked[1:]):
        assert a[2] <= b[1], (a[0], b[0])
    phases = [e for e in tr.events if _phase(e[0])]
    starts = [e[1] for e in phases]
    held = [[] for _ in phases]
    for name, t0, t1, _ in marked:
        i = bisect.bisect_right(starts, t0) - 1
        assert i >= 0 and t1 <= phases[i][2], name
        held[i].append(name)
    for (name, *_), inner in zip(phases, held):
        level = int(name.split("@")[1]) if "@" in name else None
        assert inner == ([f"{prefix}{level}"] if level in levels else []), (name, inner)


@pytest.mark.parametrize("case", CASES)
def test_cg_spans_mark_the_cg_levels_inside_their_phases(case):
    """Every phase span of a CG level ``k`` holds exactly one
    ``aggmg.cg@k`` span, every other phase span none; no CG span lies
    outside a phase span or in another CG span.  Block-topped chains open
    none, so the phase readings of their cells are as before."""
    _check_family_spans(_traced(case), "aggmg.cg@", range(CG_LEVELS.get(case, 0)))


@pytest.mark.parametrize("case", CASES)
def test_bcoo_spans_mark_the_block_coo_levels_inside_their_phases(case):
    """On the scattered chain every phase span of a block-COO level ``k >=
    1`` holds exactly one ``aggmg.bcoo@k`` span, level 0 (DG) none; the
    spans never nest, in each other or in a CG span.  Every other chain
    opens none."""
    tr = _traced(case)
    _check_family_spans(tr, "aggmg.bcoo@", BCOO_LEVELS.get(case, range(0)))
    if case in BCOO_LEVELS:
        assert not _named(tr, "aggmg.cg@")


def _within(inner, outer):
    """For each event of ``inner``, the events of ``outer`` (sorted, never
    nested) that enclose it."""
    return [[o[0] for o in outer if o[1] <= e[1] and e[2] <= o[2]] for e in inner]


@pytest.mark.parametrize("case", CASES)
def test_schwarz_spans_lie_in_the_cg_spans_of_their_level(case):
    """On a Schwarz-smoothed chain every ``aggmg.schwarz@k`` lies inside one
    ``aggmg.cg@k`` of its level, inside a smoothing phase, never in another
    Schwarz span; each smoothing of a CG level above the coarsest holds
    ``n_pre = n_post = 3`` of them (one a Chebyshev step or damped sweep)
    and no other phase holds one.  A Jacobi-smoothed chain (the flagship's)
    and the block-topped chains open none."""
    tr = _traced(case)
    marked = _named(tr, "aggmg.schwarz@")
    if case not in SCHWARZ_CASES:
        assert not marked
        return
    for a, b in zip(marked, marked[1:]):
        assert a[2] <= b[1], (a[0], b[0])
    levels = [int(e[0].split("@")[1]) for e in marked]
    assert set(levels) == set(range(CG_LEVELS[case]))
    for (name, *_), cg in zip(marked, _within(marked, _named(tr, "aggmg.cg@"))):
        assert cg == [name.replace("schwarz", "cg")], (name, cg)
    for name, t0, t1, _ in (e for e in tr.events if _phase(e[0])):
        held = [m[0] for m in marked if t0 <= m[1] and m[2] <= t1]
        level = int(name.split("@")[1]) if "@" in name else None
        want = 3 if _phase(name) == "smooth" and level < CG_LEVELS[case] else 0
        assert held == [f"aggmg.schwarz@{level}"] * want, (name, held)


@pytest.mark.parametrize("case", SCHWARZ_CASES)
def test_one_schwarz_span_per_window_apply(case, monkeypatch):
    """Counted where the windows are applied (``smoother.schwarz_windows``,
    marked here): every apply lies in exactly one ``aggmg.schwarz@k``
    span, and every such span holds exactly one apply."""
    from agglomerationmultigrid1d_tpu_torch.smoothers import smoother

    orig = smoother.schwarz_windows

    def marked_windows(s, r):
        with torch.profiler.record_function("test.schwarz_windows"):
            return orig(s, r)

    monkeypatch.setattr(smoother, "schwarz_windows", marked_windows)
    _, _, solve = CASES[case]()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solve()
    events = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()), key=lambda e: e[1])
    applies = [e for e in events if e[0] == "test.schwarz_windows"]
    spans = [e for e in events if e[0].startswith("aggmg.schwarz@")]
    assert applies and len(applies) == len(spans)
    assert all(len(w) == 1 for w in _within(applies, spans))


@pytest.mark.parametrize("case", ("multigrid", "multigrid_mixed"))
def test_slice_opens_no_family_span(case):
    """The DG-topped slice (``dg_slice``'s chain): block-tridiagonal levels
    only, so neither family span opens."""
    tr = _traced(case)
    assert not _named(tr, "aggmg.cg@") and not _named(tr, "aggmg.bcoo@")


SETUP = {
    "poisson_dg_hierarchy": (lambda t: poisson_dg_hierarchy(n=32, max_p=3, n_dg=2, n_agg=2, device="cpu", timings=t),
                             ("meshes", "assemble", "hierarchy", "to_device")),
    "build_xl_problem": (lambda t: build_xl_problem(HierarchySpec(**XL_SPEC), XL_N, slim_fine=True, ff_levels=True,
                                                    device="cpu", timings=t),
                         ("host_stencil", "inflate", "rhs")),
}


@pytest.mark.parametrize("builder", SETUP)
def test_setup_phases_are_spans_and_timed(builder):
    build, phases = SETUP[builder]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        build(None)
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events() if e.name().startswith("aggmg."))
    outer, end = [], -1
    for t0, t1, name in spans:  # the stencil build's own problem nests its set-up phases in host_stencil
        if t0 >= end:
            outer.append(name)
            end = t1
    assert outer == [f"aggmg.setup.{p}" for p in phases] and all(n.startswith("aggmg.setup.") for *_, n in spans)
    timings = {}
    build(timings)
    assert tuple(timings) == phases and all(v >= 0.0 for v in timings.values())
