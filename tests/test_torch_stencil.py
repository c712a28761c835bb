"""The torch port's stencil-inflated setup and TRUE-precision solve against
the JAX package's, on the CPU.

* ``build_xl_problem(spec, 4096, z=8, slim_fine=True, ff_levels=True)`` (the
  spec of ``tests/test_stencil_setup.py:266-272``): every tensor of
  ``h_low``, ``FFOps`` and ``b_ff`` agrees with JAX's — float32 leaves to
  1 ulp (plus 1e-12 of the leaf's largest magnitude, for entries that are the
  float64 rounding noise of an exact zero), float64 leaves and ``norm_b`` to
  1e-13 relative, the float32 Chebyshev bounds to 1e-6 relative (50 float32
  power steps in both; the 1e-12 of ``test_torch_chebyshev.py`` holds for
  float64 bounds only, see ROADMAP queue 3);
* ``default_stencil_factor`` agrees, the rhs of the port's device path
  agrees to 1e-14 relative with JAX's and with the direct full-size build;
* ``multigrid_true`` on the same carried-across inputs
  (``utils.convert.xl_problem_from_numpy``) in both packages: at n=4096 equal
  iteration counts and ``res_history`` to 1e-6 relative; at the
  conditioning-matched n=16,384 (``tests/test_stencil_setup.py:391-401``)
  both end below tol within one cycle of each other; the tail of the history
  is NaN;
* at n=16,384, with the float32 prolongation's contraction fused as XLA and
  the card form it, the port's true cycle contracts every cycle at JAX's rate
  (the cause of the gap, ROADMAP queue 3);
* the port's own build and solve, end to end, with the residual recomputed
  independently in float64;
* importing the stencil setup and ``ops.df64`` leaves JAX out.
"""

import functools
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from agglomerationmultigrid1d_tpu.models.solvers import multigrid_true as jmultigrid_true
from agglomerationmultigrid1d_tpu.models.stencil_setup import build_xl_problem as jbuild_xl_problem
from agglomerationmultigrid1d_tpu.models.stencil_setup import default_stencil_factor as jdefault_factor
from agglomerationmultigrid1d_tpu.utils.config import HierarchySpec as JHierarchySpec
from agglomerationmultigrid1d_tpu_torch.models import (
    FFOps,
    build_problem,
    build_xl_problem,
    multigrid_true,
)
from agglomerationmultigrid1d_tpu_torch.models.stencil_setup import default_stencil_factor
from agglomerationmultigrid1d_tpu_torch.ops.df64 import BTFFStencil, ff_join
from agglomerationmultigrid1d_tpu_torch.utils.config import HierarchySpec
from agglomerationmultigrid1d_tpu_torch.utils.convert import xl_problem_from_numpy

N = 4096
SPEC = dict(cg_orders=(), dg_orders=(1,), n_agg_levels=4, p_agg=1, c_dir=1000.0 * N)
N_KAPPA = 16384  # eps_f32 * kappa_elem ~ 6, as at the 1e8-DoF north star
SPEC_KAPPA = dict(cg_orders=(), dg_orders=(1,), n_agg_levels=4, p_agg=1, agg_factor=4,
                  c_dir=1000.0 * float(3 << 24) ** 2 / N_KAPPA)


@functools.lru_cache(maxsize=None)
def _jax_xl(n, spec_items, z):
    out = jbuild_xl_problem(JHierarchySpec(**dict(spec_items)), n, z=z, slim_fine=True, ff_levels=True)
    return out, jax.tree_util.tree_map(np.asarray, out[:3])


@functools.lru_cache(maxsize=None)
def _port_xl(n, spec_items, z):
    return build_xl_problem(HierarchySpec(**dict(spec_items)), n, z=z, slim_fine=True, ff_levels=True, device="cpu")


def _walk(want, got, path, out):
    """Pair the JAX bundle's leaves (NumPy) with the port's by field name."""
    if isinstance(want, np.ndarray):
        out.append((path, want, got))
    elif hasattr(want, "_fields"):
        for f in want._fields:
            _walk(getattr(want, f), getattr(got, f), f"{path}.{f}", out)
    elif hasattr(want, "hi_mid"):  # the stencil fine operator, a dataclass
        for f in ("hi_left", "hi_mid", "hi_right", "lo_left", "lo_mid", "lo_right"):
            _walk(getattr(want, f), getattr(got, f), f"{path}.{f}", out)
        assert got.n == want.n
    elif isinstance(want, (tuple, list)):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            _walk(w, g, f"{path}[{i}]", out)
    else:
        assert want is None and got is None, path
    return out


def _hi_path(path: str):
    """The path of the hi part a float-float lo leaf pairs with, else None."""
    if ".lo_" in path:
        return path.replace(".lo_", ".hi_")
    if ".lo." in path:
        return path.replace(".lo.", ".hi.")
    if path == "[2].lo":
        return "[2].hi"
    if path.startswith("[1].t_los["):  # a transfer's lo tail; hi is the float32 transfer
        return path.replace("[1].t_los[", "[0].transfers[")
    return None


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_build_xl_problem_matches_jax():
    (jh, jff, jb, jnb), (jh_np, jff_np, jb_np) = _jax_xl(N, tuple(SPEC.items()), 8)
    h, ff, b, nb = _port_xl(N, tuple(SPEC.items()), 8)
    assert isinstance(ff, FFOps) and isinstance(ff.a_ffs[0], BTFFStencil)
    leaves = _walk((jh_np, jff_np, jb_np), (h, ff, b), "", [])
    assert len(leaves) > 80
    by_path = {path: (want, got.numpy()) for path, want, got in leaves}
    n_f32 = n_f64 = n_ff = 0
    for path, want, got in leaves:
        got = got.numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, path
        if want.size == 0:
            continue
        hi_path = _hi_path(path)
        if hi_path is not None:
            # a float-float lo tail: the pair hi + lo is the float64 value (lo
            # moves by an ulp of hi where hi rounds the other way)
            w_hi, g_hi = by_path[hi_path]
            w_val, g_val = w_hi.astype(np.float64) + want, g_hi.astype(np.float64) + got
            np.testing.assert_allclose(g_val, w_val, rtol=0, atol=1e-13 * np.abs(w_val).max(), err_msg=path)
            n_ff += 1
        elif path.endswith(("lam_lo", "lam_hi")):
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=path)
        elif want.dtype == np.float32:
            noise = 1e-12 * float(np.abs(want).max())
            ok = (_ulps(got, want) <= 1) | (np.abs(got - want) <= noise)
            assert ok.all(), (path, int((~ok).sum()))
            n_f32 += 1
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * np.abs(want).max(), err_msg=path)
            n_f64 += 1
    assert n_f32 > 40 and n_f64 >= 2 and n_ff > 10  # float64: the coarse64 factorization
    np.testing.assert_allclose(nb, jnb, rtol=1e-13)
    # the rhs value, hi + lo
    np.testing.assert_allclose(ff_join(b).numpy(), jb_np.hi.astype(np.float64) + jb_np.lo,
                               rtol=0, atol=1e-14 * float(np.abs(jb_np.hi).max()))


def test_rhs_and_stencil_factor():
    """The rhs of the port's device path (float64 load on the target device
    plus the boundary patches of the stencil problem) against the direct
    full-size build, and the default stencil factor against JAX's."""
    h, ff, b, nb = _port_xl(N, tuple(SPEC.items()), 8)
    direct = build_problem(HierarchySpec(**SPEC), N, device="cpu").b
    np.testing.assert_allclose(ff_join(b).numpy(), direct.numpy(), rtol=0,
                               atol=1e-14 * float(direct.abs().max()))
    np.testing.assert_allclose(nb, float(torch.linalg.vector_norm(direct)), rtol=1e-14)
    north_star = dict(cg_orders=(), dg_orders=(1,), n_agg_levels=6, p_agg=1, agg_factor=4)
    for spec, n in ((SPEC, N), (SPEC_KAPPA, N_KAPPA), (north_star, 50331648), (SPEC, 3 * 1024)):
        got = default_stencil_factor(HierarchySpec(**spec), n)
        assert got == jdefault_factor(JHierarchySpec(**spec), n), (spec, n)
    assert default_stencil_factor(HierarchySpec(**north_star), 50331648) == 1024


def test_setup_timings_and_unported_chains():
    timings = {}
    build_xl_problem(HierarchySpec(**SPEC), 1024, slim_fine=True, ff_levels=True, timings=timings, device="cpu")
    assert set(timings) == {"host_stencil", "inflate", "rhs"} and all(v >= 0 for v in timings.values())
    # CG-topped chains are ported now (held to the JAX package in tests/test_torch_stencil_cg.py)
    h, a_ff, b, nb = build_xl_problem(HierarchySpec(cg_orders=(2, 1), n_agg_levels=3, c_dir=1000.0 * 2048), 2048,
                                      device="cpu")
    assert [type(lv).__name__ for lv in h.levels] == ["CgLevel"] * 2 + ["BlockLevel"] * 3
    assert type(a_ff).__name__ == "CgBandFF" and tuple(b.hi.shape) == (2 * 2048 + 1,) and nb > 0
    with pytest.raises(ValueError, match="DG-topped"):  # slim_fine stays DG-only, as in the JAX package
        build_xl_problem(HierarchySpec(cg_orders=(2, 1), n_agg_levels=3), 2048, slim_fine=True, device="cpu")


@pytest.mark.parametrize(
    "n,spec,z,maxiter,tol,exact",
    [(N, SPEC, 8, 40, 1e-8, True), (N_KAPPA, SPEC_KAPPA, None, 25, 1e-10, False)],
    ids=["n4096", "kappa-n16384"],
)
def test_multigrid_true_matches_jax_on_shared_inputs(n, spec, z, maxiter, tol, exact):
    (jh, jff, jb, jnb), (jh_np, jff_np, jb_np) = _jax_xl(n, tuple(spec.items()), z)
    jres = jmultigrid_true(jh, jff, jb, jnb, maxiter, tol)
    res = multigrid_true(*xl_problem_from_numpy(jh_np, jff_np, jb_np, jnb, device="cpu"), maxiter, tol)
    j_it = int(jres.iterations)
    j_hist, hist = np.asarray(jres.res_history), res.res_history.numpy()
    assert j_hist[j_it - 1] < tol * jnb and hist[res.iterations - 1] < tol * jnb
    assert np.isnan(hist[res.iterations:]).all() and np.isnan(j_hist[j_it:]).all()
    assert res.x.dtype == torch.float64 and tuple(res.x.shape) == tuple(jb_np.hi.shape)
    if exact:
        assert res.iterations == j_it
        np.testing.assert_allclose(hist[:j_it], j_hist[:j_it], rtol=1e-6)
    else:
        assert abs(res.iterations - j_it) <= 1, (res.iterations, j_it)


def _prolong_fused(l, xc):
    """``bp_prolong`` with each float32 contraction formed as
    ``fma(a1, x1, a0 * x0)``, as a fused multiply-add unit forms it; the fma
    is emulated in float64, where the product ``a1 * x1`` is exact."""
    bs_c = xc.shape[0]
    cols = []
    for j in range(l.r):
        rows = []
        for i in range(l.bs_fine):
            acc = l.blocks[j, i, 0] * xc[0]
            for c in range(1, bs_c):
                acc = (l.blocks[j, i, c].double() * xc[c].double() + acc.double()).float()
            rows.append(acc)
        cols.append(torch.stack(rows))
    return torch.stack(cols).permute(1, 2, 0).reshape(l.bs_fine, l.r * xc.shape[-1])


def test_true_cycle_contracts_with_a_fused_prolongation(monkeypatch):
    """Where the counts at n=16,384 part: the float32 prolongation ``T e_hi``
    of ``_transfer_true`` cancels at this conditioning, and its rounding decides
    whether the cycle contracts.  With the contraction fused as XLA's CPU code
    and the card's gemv form it, the port contracts every cycle at JAX's rate
    and reaches tol no later than JAX; the plain float32 sum does not (its
    history jumps 7x after the first cycle, ROADMAP queue 3)."""
    import agglomerationmultigrid1d_tpu_torch.models.solvers as tsolvers

    (jh, jff, jb, jnb), (jh_np, jff_np, jb_np) = _jax_xl(N_KAPPA, tuple(SPEC_KAPPA.items()), None)
    args = xl_problem_from_numpy(jh_np, jff_np, jb_np, jnb, device="cpu")
    monkeypatch.setattr(tsolvers, "bp_prolong", _prolong_fused)
    j_it = int(jmultigrid_true(jh, jff, jb, jnb, 25, 1e-10).iterations)
    assert multigrid_true(*args, 25, 1e-10).iterations <= j_it
    for hist in (np.asarray(jmultigrid_true(jh, jff, jb, jnb, 8, 1e-30).res_history),
                 multigrid_true(*args, 8, 1e-30).res_history.numpy()):
        assert np.isfinite(hist).all() and (hist[1:] / hist[:-1] < 0.6).all(), hist / jnb


def test_port_build_and_solve_end_to_end():
    """The port's own build and ``multigrid_true``: below tol, with the
    relative residual recomputed in float64 from the stencil, materialized."""
    h, ff, b, nb = _port_xl(N, tuple(SPEC.items()), 8)
    res = multigrid_true(h, ff, b, nb, 40, 1e-8)
    (jh, jff, jb, jnb), _ = _jax_xl(N, tuple(SPEC.items()), 8)
    assert abs(res.iterations - int(jmultigrid_true(jh, jff, jb, jnb, 40, 1e-8).iterations)) <= 1
    st = ff.a_ffs[0]
    assert len(h.levels) == 5 and st.n == N and st.bw == 4

    def full(name):
        parts = [getattr(st, f"{h_}_{side}") for h_ in ("hi",) for side in ("left", "mid", "right")]
        los = [getattr(st, f"lo_{side}") for side in ("left", "mid", "right")]
        cols = []
        for p_hi, p_lo, reps in zip(parts, los, (1, N - 2 * st.bw, 1)):
            v = getattr(p_hi, name).double() + getattr(p_lo, name).double()
            cols.append(v.expand(*v.shape[:-1], v.shape[-1] * reps) if reps > 1 else v)
        return torch.cat(cols, dim=-1)

    from agglomerationmultigrid1d_tpu_torch.ops.block_tridiag import BlockTridiag, bt_matvec

    a64 = BlockTridiag(lower=full("lower"), diag=full("diag"), upper=full("upper"))
    b64 = ff_join(b)
    rel = float(torch.linalg.vector_norm(b64 - bt_matvec(a64, res.x)) / torch.linalg.vector_norm(b64))
    assert rel < 1e-8
    np.testing.assert_allclose(rel * nb, float(res.res_history[res.iterations - 1]), rtol=1e-3)


def test_imports_leave_jax_out():
    code = (
        "import sys\n"
        "import agglomerationmultigrid1d_tpu_torch.models.stencil_setup\n"
        "import agglomerationmultigrid1d_tpu_torch.ops.df64\n"
        "import agglomerationmultigrid1d_tpu_torch.utils.convert\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True)


def test_inflate_float64_identity_roundtrip():
    """Inflating a stencil-size float64 hierarchy by its own z equals the
    direct float64 build of the full size (the generic entry point, with full
    off-diagonals on every level), as ``tests/test_stencil_setup.py`` holds
    the JAX package's."""
    from agglomerationmultigrid1d_tpu_torch.models import inflate_hierarchy, strip_hierarchy
    from agglomerationmultigrid1d_tpu_torch.models.stencil_setup import _stencil_mesh
    from agglomerationmultigrid1d_tpu_torch.utils.precision import tree_map

    n, z = 2048, 4
    spec = HierarchySpec(**dict(SPEC, c_dir=1000.0 * n))
    small = strip_hierarchy(build_problem(spec, n // z, mesh=_stencil_mesh(n // z, 1.0 / n), device="cpu").hierarchy)
    big = inflate_hierarchy(small, small, z, device="cpu")
    ref = strip_hierarchy(build_problem(spec, n, device="cpu").hierarchy)
    got, want = [], []
    tree_map(got.append, (big.levels, big.transfers))
    tree_map(want.append, (ref.levels, ref.transfers))
    assert len(got) == len(want) > 20
    for g, w in zip(got, want):
        if g is None or w.numel() == 0:
            continue
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-11 * float(w.abs().max()))


def test_inflation_rejects_nonuniform():
    """A graded mesh is not translation invariant: the constancy check
    refuses to inflate it."""
    from agglomerationmultigrid1d_tpu_torch.mesh.topology import create_graded_mesh
    from agglomerationmultigrid1d_tpu_torch.models import inflate_hierarchy, strip_hierarchy

    n, z = 2048, 8
    spec = HierarchySpec(**dict(SPEC, c_dir=1000.0 * n))
    small = strip_hierarchy(build_problem(spec, n // z, mesh=create_graded_mesh(n // z, 0.0, 1.0), device="cpu").hierarchy)
    with pytest.raises(ValueError, match="translation invariant"):
        inflate_hierarchy(small, small, z, device="cpu")
