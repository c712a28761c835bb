"""The torch port's device-side coarse chain (``build_dg_hierarchy_device``)
against the host build cast to float32 and against the JAX package's
``build_dg_hierarchy_device``, on the CPU.

The counterparts of ``tests/test_device_setup.py``'s two tests (operators
to 2e-5 of each leaf's max and the Chebyshev bounds to 1e-3 against the
host cast; ``multigrid_mixed`` takes as many steps on both), then every
leaf against the JAX package's on the same inputs, block sizes 1 and 2, to
2e-5 of the leaf's max, and the refusals (block size 3, a non-default
switch, a ragged partition)."""

import functools

import jax
import numpy as np
import pytest
import torch

from agglomerationmultigrid1d_tpu.models.device_setup import build_dg_hierarchy_device as jbuild_device
from agglomerationmultigrid1d_tpu.models.problems import build_problem as jbuild_problem
from agglomerationmultigrid1d_tpu.utils.config import HierarchySpec as JHierarchySpec
from agglomerationmultigrid1d_tpu_torch.mesh import create_uniform_mesh, make_dg_mesh
from agglomerationmultigrid1d_tpu_torch.models import (
    build_dg_hierarchy_device,
    build_problem,
    chebyshev_hierarchy,
    multigrid_mixed,
    prepare_fast_smoothers,
    strip_hierarchy,
)
from agglomerationmultigrid1d_tpu_torch.smoothers.smoother import ChebyshevSmoother
from agglomerationmultigrid1d_tpu_torch.utils import HierarchySpec
from agglomerationmultigrid1d_tpu_torch.utils.precision import hierarchy_astype

N_EL = 512
TOL = 2e-5  # of each leaf's max: float32 chains computed in two orders


def _spec(p):
    return dict(cg_orders=(), dg_orders=(p,), n_agg_levels=4, p_agg=min(p, 1), c_dir=1000.0 * N_EL)


@functools.lru_cache(maxsize=None)
def _problem(p):
    return build_problem(HierarchySpec(**_spec(p)), N_EL, device="cpu")


def _host_h32(prob):
    return prepare_fast_smoothers(chebyshev_hierarchy(hierarchy_astype(strip_hierarchy(prob.hierarchy), torch.float32)))


def _device_h32(prob):
    lv0 = prob.hierarchy.levels[0]
    return build_dg_hierarchy_device(prob.meshes, lv0.a, lv0.g, lv0.d, lv0.c, device="cpu")


def _leaf_close(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, want.shape, got.dtype, want.dtype)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale, err_msg=what)


@pytest.mark.parametrize("p", [1, 0])
def test_device_chain_matches_host_cast(p):
    h_host, h_dev = _host_h32(_problem(p)), _device_h32(_problem(p))
    assert h_dev.n_levels == h_host.n_levels
    for k, (lh, ld) in enumerate(zip(h_host.levels, h_dev.levels)):
        for name in ("lower", "diag", "upper"):
            _leaf_close(getattr(ld.a, name), getattr(lh.a, name), f"level {k} {name}")
        if isinstance(lh.smoother, ChebyshevSmoother):
            sd, sh = ld.smoother, lh.smoother
            assert isinstance(sd, ChebyshevSmoother) and sd.coef is not None
            np.testing.assert_allclose(float(sd.lam_hi), float(sh.lam_hi), rtol=1e-3, err_msg=f"level {k}")
            for name in ("inv", "ml", "mu"):
                _leaf_close(getattr(sd.base, name), getattr(sh.base, name), f"level {k} {name}")
    for tr_d, tr_h in zip(h_dev.transfers, h_host.transfers):
        _leaf_close(tr_d.blocks, tr_h.blocks, "transfer")


@pytest.mark.parametrize("p", [1, 0])
def test_device_hierarchy_solves_like_host(p):
    prob = _problem(p)
    h64, b = chebyshev_hierarchy(prob.hierarchy), prob.b
    res_host = multigrid_mixed(h64, _host_h32(prob), torch.zeros_like(b), b, 40, 1e-10)
    res_dev = multigrid_mixed(h64, _device_h32(prob), torch.zeros_like(b), b, 40, 1e-10)
    assert (res_dev.iterations, res_dev.inner_cycles) == (res_host.iterations, res_host.inner_cycles)
    rel = float(res_dev.res_history[res_dev.iterations - 1]) / float(torch.linalg.vector_norm(b))
    assert rel < 1e-10


def _walk(want, got, path, out):
    if isinstance(want, np.ndarray):
        out.append((path, want, got))
    elif hasattr(want, "_fields"):
        for f in want._fields:
            if f not in ("coef", "ghosts", "plan", "layout"):
                _walk(getattr(want, f), getattr(got, f), f"{path}.{f}", out)
    elif isinstance(want, (tuple, list)):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            _walk(w, g, f"{path}[{i}]", out)
    else:
        assert want is None and got is None, path
    return out


@pytest.mark.parametrize("p", [1, 0], ids=["bs2", "bs1"])
def test_device_chain_matches_jax(p):
    """Every leaf of the levels and transfers, the Chebyshev bounds included,
    against the JAX package's ``build_dg_hierarchy_device`` on the same
    host inputs."""
    jprob = jbuild_problem(JHierarchySpec(**_spec(p)), N_EL, to_device=False)
    jl = jprob.hierarchy.levels[0]
    jh = jax.tree_util.tree_map(np.asarray, jbuild_device(jprob.meshes, jl.a, jl.g, jl.d, jl.c))
    h = _device_h32(_problem(p))
    leaves = _walk((jh.levels, jh.transfers), (h.levels, h.transfers), "", [])
    assert len(leaves) > 30
    for path, want, got in leaves:
        if want.size:
            _leaf_close(got, want, path)


def test_device_build_refusals():
    prob = _problem(1)
    lv0 = prob.hierarchy.levels[0]
    with pytest.raises(ValueError, match="DG-topped"):
        build_dg_hierarchy_device(prob.meshes[1:], lv0.a, lv0.g, lv0.d, lv0.c, device="cpu")
    with pytest.raises(ValueError, match="block sizes 1 and 2"):  # DG p = 2: 3 x 3 blocks
        p2 = build_problem(HierarchySpec(cg_orders=(), dg_orders=(2,), n_agg_levels=1), 64, device="cpu")
        a = p2.hierarchy.levels[0]
        build_dg_hierarchy_device(p2.meshes, a.a, a.g, a.d, a.c, device="cpu")
    ragged = build_problem(HierarchySpec(cg_orders=(), dg_orders=(1,), n_agg_levels=2), 20, device="cpu")
    a = ragged.hierarchy.levels[0]
    with pytest.raises(ValueError, match="uniform partitions"):
        build_dg_hierarchy_device(ragged.meshes, a.a, a.g, a.d, a.c, device="cpu")
    mesh = create_uniform_mesh(8, 0.0, 1.0)
    switched = make_dg_mesh(mesh, 1, switch=np.array([False, False, False, True, True, True, True]))
    with pytest.raises(ValueError, match="default switch"):
        build_dg_hierarchy_device([switched] + prob.meshes[1:], lv0.a, lv0.g, lv0.d, lv0.c, device="cpu")
