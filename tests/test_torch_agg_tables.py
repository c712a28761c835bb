"""The torch port's tabled agglomerated meshes, their assembly, the
nodal-averaging seams and the dense (analysis-only) interpolations against
the JAX package's, on the CPU in float64.

Inputs: uniform and graded base meshes (the assembly and the transfers on
the graded one), uniform and ragged partitions, the
three boundary-condition pairs; a random load is made with numpy from a
seed.  Tables, load vectors, ``agg_flux_rhs``, the standalone operators and
every interpolation are held to ``1e-12`` relative (normwise); the tabled
``agg_flux_operators`` to the lite ones to ``1e-14`` relative (the
quadrature sum of the volume moment against its closed form).  The
hierarchy builders keep building lite meshes unless asked for tables."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agglomerationmultigrid1d_tpu.assembly import agg_assembly as jagg_asm
from agglomerationmultigrid1d_tpu.mesh import agg_mesh as jagg_mesh
from agglomerationmultigrid1d_tpu.mesh import cg_mesh as jcg_mesh
from agglomerationmultigrid1d_tpu.mesh import dg_mesh as jdg_mesh
from agglomerationmultigrid1d_tpu.mesh.topology import BoundaryCondition as JBC
from agglomerationmultigrid1d_tpu.mesh.topology import create_graded_mesh as jgraded
from agglomerationmultigrid1d_tpu.mesh.topology import create_uniform_mesh as juniform
from agglomerationmultigrid1d_tpu.ops import transfer_ops as jto
from agglomerationmultigrid1d_tpu.transfer import interpolation as jint
from agglomerationmultigrid1d_tpu_torch.assembly import agg_assembly as tagg_asm
from agglomerationmultigrid1d_tpu_torch.mesh import (
    BoundaryCondition,
    coarsen_agg_mesh,
    create_graded_mesh,
    create_uniform_mesh,
    make_agg_mesh,
    make_cg_mesh,
    make_dg_mesh,
)
from agglomerationmultigrid1d_tpu_torch.models import (
    build_problem,
    poisson_dg_hierarchy,
    poisson_full_hierarchy,
    poisson_switch_hierarchy,
)
from agglomerationmultigrid1d_tpu_torch.ops.transfer_ops import seam_prolong
from agglomerationmultigrid1d_tpu_torch.transfer import interpolation as tint
from agglomerationmultigrid1d_tpu_torch.utils.config import HierarchySpec
from agglomerationmultigrid1d_tpu_torch.utils.convert import agg_mesh_from_numpy

RTOL = 1e-12
BCS = {
    "neu-dir": (("neu", -np.sin(0.0)), ("dir", np.cos(1.0))),
    "dir-dir": (("dir", 0.3), ("dir", -0.7)),
    "dir-neu": (("dir", 1.0), ("neu", 0.25)),
}
PARTS = {"uniform": 4, "ragged": [3, 4, 5, 1, 3]}  # 16 base elements


def _close(got, want, what="", rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.linalg.norm((got - want).ravel())
    assert err <= rtol * np.linalg.norm(want.ravel()), (what, err, np.linalg.norm(want.ravel()))


def _meshes(graded: bool, n: int = 16):
    if graded:
        return create_graded_mesh(n, 0.0, 1.0, ratio=3.0), jgraded(n, 0.0, 1.0, ratio=3.0)
    return create_uniform_mesh(n, 0.0, 1.0), juniform(n, 0.0, 1.0)


def _agg_pair(p, part, graded, **kw):
    mesh, jm = _meshes(graded)
    args = (part,) if isinstance(part, int) else ()
    kws = {} if isinstance(part, int) else {"partition": part}
    return make_agg_mesh(p, mesh, *args, **kws, **kw), jagg_mesh.make_agg_mesh(p, jm, *args, **kws, **kw)


@pytest.mark.parametrize("graded", [False, True])
@pytest.mark.parametrize("part", list(PARTS))
@pytest.mark.parametrize("p", [0, 1])
def test_tabled_mesh_matches_jax(p, part, graded):
    agg, jagg = _agg_pair(p, PARTS[part], graded)
    assert agg.has_tables and jagg.has_tables
    for name in ("quad_nodes", "quad_weights", "basis_q", "x_quad", "jacs", "boxes"):
        _close(getattr(agg, name), getattr(jagg, name), name)
    _close(agg.base_jacobians(), jagg.base_jacobians(), "base_jacobians")
    _close(agg.mass.blocks, jagg.mass.blocks, "mass")
    _close(agg.mass_inv.blocks, jagg.mass_inv.blocks, "mass_inv")
    assert (agg.n_elements, agg.n_nodes, agg.r_max) == (jagg.n_elements, jagg.n_nodes, jagg.r_max)
    # the next level inherits the choice, as in the JAX package
    sub = 2 if agg.n_agg % 2 == 0 else [2] * (agg.n_agg // 2 - 1) + [2 + agg.n_agg % 2]
    coarse = coarsen_agg_mesh(agg, partition=sub) if isinstance(sub, list) else coarsen_agg_mesh(agg, sub)
    jcoarse = (jagg_mesh.coarsen_agg_mesh(jagg, partition=sub) if isinstance(sub, list)
               else jagg_mesh.coarsen_agg_mesh(jagg, sub))
    assert coarse.has_tables
    _close(coarse.basis_q, jcoarse.basis_q, "coarse basis_q")
    _close(coarse.mass_inv.blocks, jcoarse.mass_inv.blocks, "coarse mass_inv")
    assert not coarsen_agg_mesh(agg, partition=[agg.n_agg], tables=False).has_tables


def test_lite_mesh_refuses_tables():
    agg, jagg = _agg_pair(1, 4, False, tables=False)
    assert not agg.has_tables and agg.basis_q is None
    with pytest.raises(ValueError, match="tables=False"):
        agg.base_jacobians()
    with pytest.raises(ValueError, match="tables=False"):
        tagg_asm.agg_load_vector(agg, torch.cos)
    _close(agg.mass.blocks, jagg.mass.blocks, "lite mass")


@pytest.mark.parametrize("part", list(PARTS))
@pytest.mark.parametrize("p", [0, 1])
@pytest.mark.parametrize("bc", list(BCS))
def test_tabled_assembly_matches_jax(bc, p, part):
    agg, jagg = _agg_pair(p, PARTS[part], True)
    tbc, jbc = BoundaryCondition(*BCS[bc]), JBC(*BCS[bc])
    c_dir = 37.0
    g, d, c = tagg_asm.agg_flux_operators(agg, tbc, c_dir)
    jg, jd, jc = jagg_asm.agg_flux_operators(jagg, jbc, c_dir)
    for name, t_op, j_op in (("g", g, jg), ("d", d, jd), ("c", c, jc)):
        for f in ("lower", "diag", "upper"):
            _close(getattr(t_op, f), getattr(j_op, f), f"{name}.{f}")
    # the tabled volume moment against the closed form of the lite mesh
    lite = make_agg_mesh(p, agg.mesh, partition=agg.sizes, tables=False)
    for t_op, l_op in zip((g, d, c), tagg_asm.agg_flux_operators(lite, tbc, c_dir)):
        for f in ("lower", "diag", "upper"):
            _close(getattr(t_op, f), getattr(l_op, f), f"tabled against lite {f}", rtol=1e-14)

    coef = np.random.default_rng(7).standard_normal(3)
    func_t = lambda x: coef[0] + coef[1] * torch.sin(3.0 * x) + coef[2] * x**2  # noqa: E731
    func_j = lambda x: coef[0] + coef[1] * jnp.sin(3.0 * x) + coef[2] * x**2  # noqa: E731
    _close(tagg_asm.agg_load_vector(agg, func_t), jagg_asm.agg_load_vector(jagg, func_j), "load")
    f, r = tagg_asm.agg_flux_rhs(agg, func_t, tbc, c_dir)
    jf, jr = jagg_asm.agg_flux_rhs(jagg, func_j, jbc, c_dir)
    _close(f, jf, "f")
    _close(r, jr, "r")
    _close(tagg_asm.agg_f_vector(agg, func_t, tbc, c_dir), jagg_asm.agg_f_vector(jagg, func_j, jbc, c_dir), "f_vector")
    _close(tagg_asm.agg_r_vector(agg, tbc), jagg_asm.agg_r_vector(jagg, jbc), "r_vector")
    for t_fn, j_fn in ((tagg_asm.agg_gradient, jagg_asm.agg_gradient),
                       (tagg_asm.agg_divergence, jagg_asm.agg_divergence)):
        t_op, j_op = t_fn(agg, tbc), j_fn(jagg, jbc)
        for fld in ("lower", "diag", "upper"):
            _close(getattr(t_op, fld), getattr(j_op, fld), f"{t_fn.__name__}.{fld}")
    _close(tagg_asm.agg_c_matrix(agg, tbc, c_dir).diag, jagg_asm.agg_c_matrix(jagg, jbc, c_dir).diag, "c_matrix")


def test_convert_carries_a_tabled_mesh_across():
    """``utils.convert.agg_mesh_from_numpy`` of JAX's tabled mesh assembles
    what the port's own mesh assembles, bit for bit."""
    agg, jagg = _agg_pair(1, PARTS["ragged"], True)
    carried = agg_mesh_from_numpy(jagg)
    assert carried.has_tables
    f_own = tagg_asm.agg_load_vector(agg, torch.cos)
    f_car = tagg_asm.agg_load_vector(carried, torch.cos)
    _close(f_car, jagg_asm.agg_load_vector(jagg, jnp.cos), "carried load")
    _close(f_car, f_own, "carried against own")
    np.testing.assert_array_equal(carried.jacs, agg.jacs)


@pytest.mark.parametrize("p_dg,p_cg", [(0, 1), (1, 2), (2, 4)])
def test_dg_cg_interpolation_flags_match_jax(p_dg, p_cg):
    """Both flags' windows and the seam prolongation of a random DG vector,
    the consistent-mass dense projection; on a graded mesh."""
    mesh, jm = _meshes(True, 7)
    dg, cg = make_dg_mesh(mesh, p_dg), make_cg_mesh(mesh, p_cg)
    jdg, jcg = jdg_mesh.make_dg_mesh(jm, p_dg), jcg_mesh.make_cg_mesh(jm, p_cg)
    x = np.random.default_rng(p_dg).standard_normal((p_dg + 1, 7))
    for flag in (1, 2):
        l, jl = tint.dg_cg_interpolation(dg, cg, flag), jint.dg_cg_interpolation(jdg, jcg, flag)
        _close(l.n_win, jl.n_win, f"flag {flag} n_win")
        _close(l.inv_lump, jl.inv_lump, f"flag {flag} inv_lump")
        _close(seam_prolong(l, torch.from_numpy(x)), jto.seam_prolong(jl, jnp.asarray(x)), f"flag {flag} prolong")
    with pytest.raises(ValueError, match="interp_flag"):
        tint.dg_cg_interpolation(dg, cg, 0)
    _close(tint.dg_cg_interpolation_dense(dg, cg), jint.dg_cg_interpolation_dense(jdg, jcg), "dense")


@pytest.mark.parametrize("part", list(PARTS))
@pytest.mark.parametrize("p_agg,p_cg", [(0, 1), (1, 4)])
def test_aggdg_cg_interpolation_flags_match_jax(p_agg, p_cg, part):
    agg, jagg = _agg_pair(p_agg, PARTS[part], True)
    cg, jcg = make_cg_mesh(agg.mesh, p_cg), jcg_mesh.make_cg_mesh(jagg.mesh, p_cg)
    for flag in (1, 2):
        l, jl = tint.aggdg_cg_interpolation(agg, cg, flag), jint.aggdg_cg_interpolation(jagg, jcg, flag)
        _close(l.n_win, jl.n_win, f"flag {flag} n_win")
        _close(l.inv_lump, jl.inv_lump, f"flag {flag} inv_lump")
        if l.offsets is not None:
            np.testing.assert_array_equal(l.offsets.numpy(), np.asarray(jl.offsets))
    with pytest.raises(ValueError, match="interp_flag"):
        tint.aggdg_cg_interpolation(agg, cg, 3)
    _close(tint.aggdg_cg_interpolation_dense(agg, cg), jint.aggdg_cg_interpolation_dense(jagg, jcg), "dense")


@pytest.mark.parametrize("p_lo,p_hi", [(1, 2), (2, 4)])
def test_cg_cg_and_dg_dg_interpolation2_match_jax(p_lo, p_hi):
    mesh, jm = _meshes(True, 6)
    _close(tint.cg_cg_interpolation2(make_cg_mesh(mesh, p_lo), make_cg_mesh(mesh, p_hi)),
           jint.cg_cg_interpolation2(jcg_mesh.make_cg_mesh(jm, p_lo), jcg_mesh.make_cg_mesh(jm, p_hi)), "cg_cg2")
    l2 = tint.dg_dg_interpolation2(make_dg_mesh(mesh, p_lo), make_dg_mesh(mesh, p_hi))
    jl2 = jint.dg_dg_interpolation2(jdg_mesh.make_dg_mesh(jm, p_lo), jdg_mesh.make_dg_mesh(jm, p_hi))
    _close(l2.blocks, jl2.blocks, "dg_dg2")


@pytest.mark.parametrize("part", list(PARTS))
@pytest.mark.parametrize("p_agg,p_dg", [(0, 1), (1, 1), (1, 3)])
def test_aggdg_dg_interpolation2_matches_jax(p_agg, p_dg, part):
    agg, jagg = _agg_pair(p_agg, PARTS[part], True, tables=False)
    dg, jdg = make_dg_mesh(agg.mesh, p_dg), jdg_mesh.make_dg_mesh(jagg.mesh, p_dg)
    l2, jl2 = tint.aggdg_dg_interpolation2(agg, dg), jint.aggdg_dg_interpolation2(jagg, jdg)
    _close(l2.blocks, jl2.blocks, "aggdg_dg2 blocks")
    if part == "ragged":
        np.testing.assert_array_equal(np.asarray(l2.sizes), np.asarray(jl2.sizes))


def test_builders_keep_lite_meshes():
    """``make_agg_mesh`` builds tables by default, as the JAX package's
    does; the hierarchy builders ask for lite meshes unless
    ``agg_tables=True``."""
    dev = dict(device="cpu")
    aggs = lambda prob: [m for m in prob.meshes if hasattr(m, "n_agg")]  # noqa: E731
    for prob in (
        poisson_dg_hierarchy(n=64, max_p=2, n_dg=2, n_agg=3, **dev),
        poisson_full_hierarchy(n=32, **dev),
        poisson_switch_hierarchy(n=32, n_coarsen=1, **dev),
        build_problem(HierarchySpec(cg_orders=(2,), n_agg_levels=2), 30, **dev),  # ragged
    ):
        assert aggs(prob) and not any(m.has_tables for m in aggs(prob))
    tabled = build_problem(HierarchySpec(cg_orders=(), dg_orders=(1,), n_agg_levels=2), 64, agg_tables=True, **dev)
    assert all(m.has_tables for m in aggs(tabled))
    lite = build_problem(HierarchySpec(cg_orders=(), dg_orders=(1,), n_agg_levels=2), 64, **dev)
    for a, b in zip(tabled.hierarchy.levels, lite.hierarchy.levels):
        _close(a.a.diag, b.a.diag, "tabled hierarchy operator", rtol=1e-13)
    assert make_agg_mesh(1, create_uniform_mesh(8, 0.0, 1.0), 2).has_tables
