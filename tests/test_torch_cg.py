"""The torch port's CG-topped setup against the JAX package's, on the CPU in
float64: the CG operator, mesh and assembly, the agglomerated seam assembly,
the CG -> CG, DG -> CG and agg -> CG transfers, the Jacobi and Schwarz
smoothers, and the three CG-topped hierarchies level by level.

Random inputs are made with numpy and handed to both packages.  Every
comparison is normwise: ``||got - want|| <= 1e-12 ||want||`` (setup sums run
in the same order in both packages, so they agree to a few ulps)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agglomerationmultigrid1d_tpu.assembly import agg_assembly as jagg_asm
from agglomerationmultigrid1d_tpu.assembly import cg_assembly as jcg_asm
from agglomerationmultigrid1d_tpu.mesh import agg_mesh as jagg_mesh
from agglomerationmultigrid1d_tpu.mesh import cg_mesh as jcg_mesh
from agglomerationmultigrid1d_tpu.mesh import dg_mesh as jdg_mesh
from agglomerationmultigrid1d_tpu.mesh.topology import BoundaryCondition as JBC
from agglomerationmultigrid1d_tpu.mesh.topology import create_uniform_mesh as jmesh
from agglomerationmultigrid1d_tpu.models import problems as jproblems
from agglomerationmultigrid1d_tpu.ops import cg_operator as jcg
from agglomerationmultigrid1d_tpu.ops import transfer_ops as jto
from agglomerationmultigrid1d_tpu.smoothers import smoother as jsm
from agglomerationmultigrid1d_tpu.transfer import interpolation as jint
from agglomerationmultigrid1d_tpu_torch.assembly import agg_flux_operators, cg_stiffness_and_rhs
from agglomerationmultigrid1d_tpu_torch.mesh import (
    BoundaryCondition,
    create_uniform_mesh,
    make_agg_mesh,
    make_cg_mesh,
    make_dg_mesh,
)
from agglomerationmultigrid1d_tpu_torch.models import (
    poisson_cg_hierarchy,
    poisson_dg_cg_hierarchy,
    poisson_full_hierarchy,
)
from agglomerationmultigrid1d_tpu_torch.ops import cg_operator as tcg
from agglomerationmultigrid1d_tpu_torch.ops import transfer_ops as tto
from agglomerationmultigrid1d_tpu_torch.smoothers import smoother as tsm
from agglomerationmultigrid1d_tpu_torch.transfer import interpolation as tint

RTOL = 1e-12
BCS = {
    "neu-dir": (("neu", -np.sin(0.0)), ("dir", np.cos(1.0))),
    "dir-dir": (("dir", 0.3), ("dir", -0.7)),
    "dir-neu": (("dir", 1.0), ("neu", 0.25)),
}


def _close(got, want, what="", rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.linalg.norm((got - want).ravel())
    assert err <= rtol * np.linalg.norm(want.ravel()), (what, err, np.linalg.norm(want.ravel()))


def _windows(rng, p, n_el):
    w = rng.standard_normal((p + 1, p + 1, n_el))
    return torch.from_numpy(w), jnp.asarray(w)


@pytest.mark.parametrize("p,n_el", [(1, 9), (2, 7), (8, 5)])
def test_cg_operator_matches_jax(rng, p, n_el):
    tw, jw = _windows(rng, p, n_el)
    ta, ja = tcg.cg_from_windows(tw), jcg.cg_from_windows(jw)
    _close(ta.band, ja.band, "band")
    x = rng.standard_normal(ta.n_nodes)
    _close(tcg.cg_matvec(ta, torch.from_numpy(x)), jcg.cg_matvec(ja, jnp.asarray(x)), "matvec")
    _close(tcg.cg_diagonal(ta), jcg.cg_diagonal(ja), "diagonal")
    _close(tcg.cg_assembled_windows(ta), jcg.cg_assembled_windows(ja), "assembled windows")
    _close(tcg.cg_to_dense(ta), jcg.cg_to_dense(ja), "dense")
    _close(tcg.cg_node_multiplicity(p, n_el, device="cpu"), jcg.cg_node_multiplicity(p, n_el), "multiplicity")
    assert ta.p == p and ta.n_el == n_el and ta.n_nodes == n_el * p + 1


@pytest.mark.parametrize("p", [1, 4, 8])
@pytest.mark.parametrize("bc", list(BCS))
def test_cg_mesh_and_assembly_match_jax(p, bc):
    n = 12
    mesh, jm = create_uniform_mesh(n, 0.0, 1.0), jmesh(n, 0.0, 1.0)
    cg, jcgm = make_cg_mesh(mesh, p), jcg_mesh.make_cg_mesh(jm, p)
    _close(cg.mass.windows, jcgm.mass.windows, "mass windows")
    _close(cg.mass.band, jcgm.mass.band, "mass band")
    _close(cg.lumped_mass, jcgm.lumped_mass, "lumped mass")
    np.testing.assert_allclose(cg.node_x(), jcgm.node_x(), rtol=RTOL)
    a, f = cg_stiffness_and_rhs(cg, torch.cos, BoundaryCondition(*BCS[bc]))
    ja, jf = jcg_asm.cg_stiffness_and_rhs(jcgm, jnp.cos, JBC(*BCS[bc]))
    _close(a.windows, ja.windows, "stiffness windows")
    _close(a.band, ja.band, "stiffness band")
    _close(f, jf, "rhs")


@pytest.mark.parametrize("p_agg", [0, 1])
@pytest.mark.parametrize("bc", list(BCS))
def test_agg_flux_operators_match_jax(p_agg, bc):
    mesh, jm = create_uniform_mesh(24, 0.0, 1.0), jmesh(24, 0.0, 1.0)
    agg = make_agg_mesh(p_agg, mesh, 4, tables=False)
    jagg = jagg_mesh.make_agg_mesh(p_agg, jm, 4, tables=False)
    got = agg_flux_operators(agg, BoundaryCondition(*BCS[bc]), 2400.0)
    want = jagg_asm.agg_flux_operators(jagg, JBC(*BCS[bc]), 2400.0)
    for name, g, w in zip("GDC", got, want):
        for part in ("lower", "diag", "upper"):
            _close(getattr(g, part), getattr(w, part), f"{name}.{part}")


def _apply_both(rng, t_l, j_l, n_coarse_vec, n_fine_vec):
    """Prolong a random coarse vector and restrict a random fine one with both
    packages' transfers."""
    xc = rng.standard_normal(n_coarse_vec)
    rf = rng.standard_normal(n_fine_vec)
    tp, jp = tto.__dict__, jto.__dict__
    kind = {"CgProlong": "cgp", "SeamProlong": "seam"}[type(t_l).__name__]
    _close(tp[f"{kind}_prolong"](t_l, torch.from_numpy(xc)), jp[f"{kind}_prolong"](j_l, jnp.asarray(xc)), "prolong")
    _close(tp[f"{kind}_restrict"](t_l, torch.from_numpy(rf)), jp[f"{kind}_restrict"](j_l, jnp.asarray(rf)), "restrict")


@pytest.mark.parametrize("p_hi,p_lo", [(8, 4), (4, 2), (2, 1), (3, 1)])
def test_cg_cg_transfer_matches_jax(rng, p_hi, p_lo):
    n = 10
    mesh, jm = create_uniform_mesh(n, 0.0, 1.0), jmesh(n, 0.0, 1.0)
    hi, lo = make_cg_mesh(mesh, p_hi), make_cg_mesh(mesh, p_lo)
    jhi, jlo = jcg_mesh.make_cg_mesh(jm, p_hi), jcg_mesh.make_cg_mesh(jm, p_lo)
    l, jl = tint.cg_cg_interpolation(lo, hi), jint.cg_cg_interpolation(jlo, jhi)
    _close(l.e, jl.e, "E")
    _apply_both(rng, l, jl, lo.n_nodes, hi.n_nodes)
    tw, jw = _windows(rng, p_hi, n)
    ga, ja = tto.cgp_galerkin(l, tcg.cg_from_windows(tw)), jto.cgp_galerkin(jl, jcg.cg_from_windows(jw))
    _close(ga.windows, ja.windows, "galerkin windows")
    _close(ga.band, ja.band, "galerkin band")


@pytest.mark.parametrize("p_cg,p_dg", [(1, 0), (2, 1), (8, 3)])
def test_dg_cg_seam_matches_jax(rng, p_cg, p_dg):
    n = 8
    mesh, jm = create_uniform_mesh(n, 0.0, 1.0), jmesh(n, 0.0, 1.0)
    cg, dg = make_cg_mesh(mesh, p_cg), make_dg_mesh(mesh, p_dg)
    jcgm, jdg = jcg_mesh.make_cg_mesh(jm, p_cg), jdg_mesh.make_dg_mesh(jm, p_dg)
    l, jl = tint.dg_cg_interpolation(dg, cg), jint.dg_cg_interpolation(jdg, jcgm)
    _close(l.n_win, jl.n_win, "n_win")
    _close(l.inv_lump, jl.inv_lump, "inv_lump")
    _apply_both(rng, l, jl, (p_dg + 1, n), cg.n_nodes)


@pytest.mark.parametrize("p_cg,p_agg,r", [(1, 1, 4), (2, 0, 2), (8, 1, 4)])
def test_aggdg_cg_seam_matches_jax(rng, p_cg, p_agg, r):
    n = 16
    mesh, jm = create_uniform_mesh(n, 0.0, 1.0), jmesh(n, 0.0, 1.0)
    cg, agg = make_cg_mesh(mesh, p_cg), make_agg_mesh(p_agg, mesh, r, tables=False)
    jcgm = jcg_mesh.make_cg_mesh(jm, p_cg)
    jagg = jagg_mesh.make_agg_mesh(p_agg, jm, r, tables=False)
    l, jl = tint.aggdg_cg_interpolation(agg, cg), jint.aggdg_cg_interpolation(jagg, jcgm)
    assert jl.offsets is None
    _close(l.n_win, jl.n_win, "n_win")
    _close(l.inv_lump, jl.inv_lump, "inv_lump")
    _apply_both(rng, l, jl, (p_agg + 1, n // r), cg.n_nodes)


@pytest.mark.parametrize("kind", ["jac", "addSchwarz", "hybridSchwarz"])
@pytest.mark.parametrize("p", [2, 8])
def test_cg_smoothers_match_jax(rng, kind, p):
    n = 10
    mesh, jm = create_uniform_mesh(n, 0.0, 1.0), jmesh(n, 0.0, 1.0)
    bc = BCS["neu-dir"]
    a, _ = cg_stiffness_and_rhs(make_cg_mesh(mesh, p), torch.cos, BoundaryCondition(*bc))
    ja, _ = jcg_asm.cg_stiffness_and_rhs(jcg_mesh.make_cg_mesh(jm, p), jnp.cos, JBC(*bc))
    s, js = tsm.cg_smoother(a, kind), jsm.cg_smoother(ja, kind)
    assert type(s).__name__ == type(js).__name__
    r = rng.standard_normal(a.n_nodes)
    _close(tsm.apply_smoother(s, torch.from_numpy(r), alpha=0.7),
           jsm.apply_smoother(js, jnp.asarray(r), alpha=0.7), "S r")


def test_dg_pointwise_jacobi_matches_jax(rng):
    """``dg_smoother(kind="jac")``: the inverted scalar diagonal of a block level."""
    from agglomerationmultigrid1d_tpu.ops.block_tridiag import BlockTridiag as JBT
    from agglomerationmultigrid1d_tpu_torch.ops.block_tridiag import BlockTridiag

    l, d, u = (rng.standard_normal((3, 3, 20)) for _ in range(3))
    s = tsm.dg_smoother(BlockTridiag(*map(torch.from_numpy, (l, d, u))), "jac")
    js = jsm.dg_smoother(JBT(*map(jnp.asarray, (l, d, u))), "jac")
    r = rng.standard_normal((3, 20))
    _close(tsm.apply_smoother(s, torch.from_numpy(r)), jsm.apply_smoother(js, jnp.asarray(r)), "S r")
    with pytest.raises(ValueError):
        tsm.dg_smoother(BlockTridiag(*map(torch.from_numpy, (l, d, u))), "gaussSeidel")


# ---------------------------------------------------------------------------
# the three CG-topped hierarchies, level by level
# ---------------------------------------------------------------------------

CONFIGS = {
    "full-32": ("full", dict(n=32)),
    "cg-64": ("cg", dict(n=64)),
    "dg_cg-64": ("dg_cg", dict(n=64)),
    "cg-32-hybridSchwarz": ("cg", dict(n=32, max_p=4, n_cg=3, cg_smoother="hybridSchwarz")),
}
PORT = {"full": poisson_full_hierarchy, "cg": poisson_cg_hierarchy, "dg_cg": poisson_dg_cg_hierarchy}


@functools.lru_cache(maxsize=None)
def _pair(name):
    kind, kw = CONFIGS[name]
    jprob = getattr(jproblems, f"poisson_{kind}_hierarchy")(**kw)
    return PORT[kind](**kw, device="cpu"), jax.tree_util.tree_map(np.asarray, jprob.hierarchy), np.asarray(jprob.b)


def _walk(got, want, path):
    """Compare two operator containers field by field (NamedTuples by field
    name); a field that JAX leaves None (``ml`` on float64 levels, a uniform
    seam's ``offsets``) must be absent or None in the port."""
    if want is None:
        assert got is None, path
        return
    if isinstance(want, np.ndarray):
        _close(got, want, path)
        return
    if hasattr(want, "_fields"):
        assert type(got).__name__ == type(want).__name__, (path, type(got), type(want))
        for f in want._fields:
            _walk(getattr(got, f, None), getattr(want, f), f"{path}.{f}")
        return
    assert len(got) == len(want), path
    for i, (g, w) in enumerate(zip(got, want)):
        _walk(g, w, f"{path}[{i}]")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_hierarchy_matches_jax_level_by_level(name):
    prob, jh, jb = _pair(name)
    h = prob.hierarchy
    assert h.n_levels == len(jh.levels)
    for k, (lv, jlv) in enumerate(zip(h.levels, jh.levels)):
        _walk(lv, jlv, f"level {k}")
    for k, (tr, jtr) in enumerate(zip(h.transfers, jh.transfers)):
        _walk(tr, jtr, f"transfer {k}")
    _close(h.coarse.a_dense, jh.coarse.a_dense, "coarse a_dense")
    # a rounding-level difference in A moves A^-1 by up to cond(A) times as
    # much, so the inverse is held to cond(A) * 1e-15
    cond = np.linalg.cond(jh.coarse.a_dense)
    _close(h.coarse.a_inv, jh.coarse.a_inv, "coarse a_inv", rtol=max(RTOL, 1e-15 * cond))
    _close(prob.b, jb, "b")


def test_flagship_shape():
    """4 CG levels p = 8, 4, 2, 1, then log2(n) - 1 agglomerated levels."""
    h = _pair("full-32")[0].hierarchy
    assert [lv.a.p for lv in h.levels[:4]] == [8, 4, 2, 1]
    assert [lv.a.n_blocks for lv in h.levels[4:]] == [8, 4, 2, 1]
    assert [type(t).__name__ for t in h.transfers] == ["CgProlong"] * 3 + ["SeamProlong"] + ["BlockProlong"] * 3
    assert h.coarse.n == 2


def test_unported_cg_configurations_raise():
    """The two CG-topped configurations that were refused before ragged
    agglomerates were ported now build, equal to the JAX package's."""
    # a ragged seam: 18 base elements, about 4 per agglomerate
    mesh, jm = create_uniform_mesh(18, 0.0, 1.0), jmesh(18, 0.0, 1.0)
    part = [4, 4, 4, 3, 3]
    got = tint.aggdg_cg_interpolation(make_agg_mesh(1, mesh, partition=part), make_cg_mesh(mesh, 2))
    want = jint.aggdg_cg_interpolation(jagg_mesh.make_agg_mesh(1, jm, partition=part), jcg_mesh.make_cg_mesh(jm, 2))
    for f in ("n_win", "inv_lump", "offsets"):
        _close(getattr(got, f).double(), np.asarray(getattr(want, f), np.float64), f)
    # a ragged agglomerated level below a uniform seam (20 -> 5 -> 3 + 2 agglomerates)
    h = poisson_full_hierarchy(n=20, device="cpu").hierarchy
    jh = jproblems.poisson_full_hierarchy(n=20).hierarchy
    assert type(h.transfers[-1]).__name__ == "RaggedBlockProlong"
    for k, (lv, jlv) in enumerate(zip(h.levels, jh.levels)):
        for got_t, want_t in zip(lv.a, jlv.a):
            _close(got_t, want_t, f"level {k}")
