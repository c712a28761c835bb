"""The hand-over of the guarded float-float refinement to the TRUE-precision
cycles (``models.solvers._mixed_loop_ff(..., ffops=)``) against the JAX
package's ``_mixed_eager_outer(..., ffops=)``, on the CPU, on inputs built
by the JAX package and carried across with ``utils.convert.xl_problem_from_numpy``.

* The north-star spec (``examples/xl_north_star.py``: DG p = 1, 4:1
  agglomerates, c_dir = 1000 n) at n = 16,384, tol 1e-9: the guard trickles
  (less than a decade over three outer steps) and hands over in both
  packages; the outer steps and cycles are held within 3 of JAX's (equal
  here: 13 / 22), the relative-defect histories, where the counts are
  equal, to 1e-1 relative (they differ by up to 5.1e-2: the float32 inner
  V-cycle rounds differently, M-form against JAX's CPU A-form, ROADMAP G16),
  and the end below tol.
* The conditioning-matched inputs of ``tests/test_stencil_setup.py:310-333``
  (eps_f32 kappa_elem ~ 6, as at the 1e8-DoF north star), tol 1e-9.  The
  float32 inner V-cycle decides the guard here, and its form decides the
  cycle: JAX's CPU branch smooths in the A-form ``u += S (b - A u)``, whose
  float32 defect cancels at this conditioning, so its guard rejects three
  steps in a row and hands over; the port smooths in K5's M-form (its plain
  version on the CPU) and its guard reaches tol alone.  The witness: JAX's
  own M-form smoothing (its Pallas Chebyshev kernel in interpret mode, with
  128-column tiles so that every level of two tiles or more takes it) on
  the same inputs; the port's counts are held within 3 of it, and to no
  more than the A-form run's (ROADMAP G21).  At tol 1e-12, below the
  float-float defect's floor, the port's guard trickles and hands over, and
  the true cycles end below tol.
* ``ffops=None`` leaves the loop as it was; a sharded hierarchy is refused.
"""

import functools

import agglomerationmultigrid1d_tpu.ops.pallas as jpallas
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agglomerationmultigrid1d_tpu.models.solvers import _mixed_eager_outer
from agglomerationmultigrid1d_tpu.ops.pallas import block_kernels as jblock_kernels
from agglomerationmultigrid1d_tpu.models.stencil_setup import build_xl_problem as jbuild_xl_problem
from agglomerationmultigrid1d_tpu.ops.df64 import FF as JFF
from agglomerationmultigrid1d_tpu.utils.config import HierarchySpec as JHierarchySpec
from agglomerationmultigrid1d_tpu_torch.models import ShardLayout
from agglomerationmultigrid1d_tpu_torch.models.solvers import _mixed_loop_ff
from agglomerationmultigrid1d_tpu_torch.ops.df64 import FF
from agglomerationmultigrid1d_tpu_torch.utils.convert import xl_problem_from_numpy

N = 16384
LOOP = dict(maxiter=60, inner_tol=3e-5, max_inner=20)
NORTH_STAR = dict(cg_orders=(), dg_orders=(1,), n_agg_levels=1, p_agg=1, agg_factor=4, c_dir=1000.0 * N)
KAPPA = dict(cg_orders=(), dg_orders=(1,), n_agg_levels=4, p_agg=1, agg_factor=4,
             c_dir=1000.0 * float(3 << 24) ** 2 / N)
HIST_RTOL = 1e-1
# JAX's Pallas wrappers that its solvers import at call time; the witness runs them in interpret mode
PALLAS_WRAPPERS = ("pallas_block_jacobi_multisweep", "pallas_block_jacobi_multisweep_residual",
                   "pallas_chebyshev_multisweep", "pallas_bt_matvec")
TILE_BYTES = 128 * (4 * 2 * 2 + 5 * 2) * 4 * 2  # _pick_tile's budget for 128 columns at bs = 2, float32


@functools.lru_cache(maxsize=None)
def _problem(spec_items):
    """JAX's bundle and the port's copy of it, ``(jax, port)``."""
    out = jbuild_xl_problem(JHierarchySpec(**dict(spec_items)), N, slim_fine=True, ff_levels=True)
    h, ffops, b, norm_b = out
    return out, xl_problem_from_numpy(*jax.tree_util.tree_map(np.asarray, (h, ffops, b)), norm_b, device="cpu")


def _jax_loop(j, tol, use_pallas=False):
    h, ffops, b, norm_b = j
    z = JFF(jnp.zeros_like(b.hi), jnp.zeros_like(b.hi))
    x, outer, cycles, hist = _mixed_eager_outer(
        h, ffops.a_ffs[0], z, b, jnp.asarray(1.0 / norm_b, jnp.float32), tol=tol, **LOOP,
        n_pre=3, n_post=3, alpha=2.0 / 3.0, use_pallas=use_pallas, eager_inner=True, eager_cut=1, ffops=ffops,
    )
    return int(outer), int(cycles), np.asarray(hist)[: int(outer)]


def _jax_mform_loop(j, tol, monkeypatch):
    """JAX's loop with its Pallas (M-form) smoothing, the kernels in interpret
    mode on the CPU.  ``_pick_tile``'s budget is cut to 128-column tiles so
    that every level of at least two tiles takes the kernel (at its own
    budget a 16,384-column level is one tile and falls back to the A-form)."""
    traced = set()

    def interpreted(name):
        kernel = getattr(jpallas, name)

        def run(*args, **kw):
            traced.add(name)
            return kernel(*args, interpret=True, **kw)

        return run

    for name in PALLAS_WRAPPERS:
        monkeypatch.setattr(jpallas, name, interpreted(name))
    monkeypatch.setattr(jblock_kernels, "_pick_tile",
                        functools.partial(jblock_kernels._pick_tile, vmem_budget=TILE_BYTES))
    return _jax_loop(j, tol, use_pallas=True), traced


def _port_loop(t, tol, **kw):
    h, ffops, b, norm_b = t
    z = torch.zeros_like(b.hi)
    info = {}
    x, outer, cycles, hist = _mixed_loop_ff(h, ffops.a_ffs[0], FF(z, z), b, np.float32(1.0 / norm_b), tol=tol,
                                            **LOOP, info=info, **kw)
    return x, outer, cycles, hist[:outer], info


def test_handover_matches_jax_where_the_guard_trickles():
    j, t = _problem(tuple(NORTH_STAR.items()))
    j_outer, j_cycles, j_hist = _jax_loop(j, 1e-9)
    x, outer, cycles, hist, info = _port_loop(t, 1e-9, ffops=t[1])
    assert info["ended"] == "trickle" and info["true_cycles"] >= 1, info
    assert outer == info["guarded_outer"] + info["true_cycles"]
    assert cycles == info["guarded_cycles"] + info["true_cycles"]
    assert hist[-1] < 1e-9 and j_hist[-1] < 1e-9
    assert abs(outer - j_outer) <= 3 and abs(cycles - j_cycles) <= 3, (outer, cycles, j_outer, j_cycles)
    if outer == j_outer:
        np.testing.assert_allclose(hist, j_hist, rtol=HIST_RTOL)
    assert np.isfinite(x.hi).all() and hist.dtype == np.float32


def test_conditioning_matched_inputs(monkeypatch):
    j, t = _problem(tuple(KAPPA.items()))
    j_outer, j_cycles, j_hist = _jax_loop(j, 1e-9)
    assert j_hist[-1] < 1e-9
    (m_outer, m_cycles, m_hist), traced = _jax_mform_loop(j, 1e-9, monkeypatch)
    assert m_hist[-1] < 1e-9 and "pallas_chebyshev_multisweep" in traced, traced
    # the port's float32 inner cycle contracts here, as JAX's M-form one does: its guard reaches tol alone
    _, outer, cycles, hist, info = _port_loop(t, 1e-9, ffops=t[1])
    assert hist[-1] < 1e-9 and info["ended"] == "tol" and info["true_cycles"] == 0, (hist, info)
    assert abs(outer - m_outer) <= 3 and abs(cycles - m_cycles) <= 3, (outer, cycles, m_outer, m_cycles)
    assert cycles <= j_cycles and outer <= j_outer, (outer, cycles, j_outer, j_cycles)
    # below the float-float defect's floor the guard only trickles: hand over
    _, outer, cycles, hist, info = _port_loop(t, 1e-12, ffops=t[1])
    assert info["ended"] in ("trickle", "rejections") and info["true_cycles"] >= 1, info
    assert hist[-1] < 1e-12 and outer <= LOOP["maxiter"], hist


def test_without_ffops_the_loop_is_unchanged():
    _, t = _problem(tuple(NORTH_STAR.items()))
    x0, outer0, cycles0, hist0, info = _port_loop(t, 1e-9)
    h, ffops, b, norm_b = t
    z = torch.zeros_like(b.hi)
    x1, outer1, cycles1, hist1 = _mixed_loop_ff(h, ffops.a_ffs[0], FF(z, z), b, np.float32(1.0 / norm_b),
                                                tol=1e-9, **LOOP)
    assert (outer0, cycles0) == (outer1, cycles1) and info["true_cycles"] == 0
    assert torch.equal(x0.hi, x1.hi) and torch.equal(x0.lo, x1.lo)
    np.testing.assert_array_equal(hist0, hist1[:outer1])
    assert info["ended"] != "trickle"


def test_a_sharded_hierarchy_is_refused():
    _, t = _problem(tuple(NORTH_STAR.items()))
    h, ffops, b, norm_b = t
    sharded = h._replace(layout=ShardLayout(group=None, sharded=(True,) + (False,) * (h.n_levels - 1)))
    z = torch.zeros_like(b.hi)
    with pytest.raises(ValueError, match="unsharded hierarchy"):
        _mixed_loop_ff(sharded, ffops.a_ffs[0], FF(z, z), b, np.float32(1.0 / norm_b), tol=1e-9, **LOOP,
                       ffops=ffops)
