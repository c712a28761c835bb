"""Device-side construction of the coarse chain of a DG-topped hierarchy.

The host build (:func:`~.hierarchy.build_dg_hierarchy`) computes every
level's Galerkin products, Schur stiffness and block inverses in float64 on
the host, as the reference does (``mesh_heirarchy.jl:140-181``); at 10^6+
elements that chain is host-bandwidth bound (seconds), while the same
arithmetic is milliseconds of device traffic.

:func:`build_dg_hierarchy_device` therefore splits the setup:

* **host, float64**: the mesh geometry, the finest operators G/D/C/M^-1 and
  the per-level transfer blocks (their coordinate differences such as
  ``x - x_center`` must be formed in float64: at 10^7 elements neighbouring
  centres are a float32 ulp apart);
* **device, float32**: everything after the cast, the whole coarse chain of
  Galerkin products, Schur stiffnesses ``A = C - D M^-1 G``, block-Jacobi
  inverses (closed form, block sizes 1 and 2; the cofactors in float64,
  rounded once), the M-form streams and the Chebyshev bounds (a power
  iteration of a fixed number of steps that never reads the device).

The result is what ``strip_hierarchy`` + ``hierarchy_astype`` +
``prepare_fast_smoothers`` + ``chebyshev_hierarchy`` give from the host
build, up to float32 rounding of the coarse chain (the host path rounds the
exact float64 operators; this path computes in float32).  The counterpart of
``agglomerationmultigrid1d_tpu/models/device_setup.py``.
"""

from __future__ import annotations

import torch

from ..mesh.dg_mesh import DgMesh
from ..mesh.scattered_agg import ScatteredAggMesh
from ..ops.block_diag import BlockDiag, bd_matvec
from ..ops.block_tridiag import BlockTridiag, block_mul, bt_matvec
from ..ops.transfer_ops import BlockProlong, bp_galerkin
from ..smoothers.smoother import BlockJacobiSmoother, ChebyshevSmoother, _inv_windows_2x2
from ..transfer.interpolation import aggdg_aggdg_interpolation, aggdg_dg_interpolation, dg_dg_interpolation
from ..utils.precision import hierarchy_astype
from .hierarchy import BlockLevel, Hierarchy, _coarse_lu, _with_chebyshev_table, schur_stiffness


def _bt_inv_diag(a: BlockTridiag) -> torch.Tensor:
    """The inverses of the diagonal blocks, in closed form, computed in
    float64 on the device and rounded once.  In float32 the cofactor
    determinant of a Dirichlet-penalty block (a rank-one c_dir term, c_dir =
    1000 n) cancels: at 2,097,152 DoF the boundary column's inverse and
    M-form streams then miss the host cast's by up to 1.6e-2 of the leaf's
    max, and the solve takes another outer step."""
    d = a.diag.to(torch.float64)
    if a.block_size == 1:
        inv = 1.0 / d
    elif a.block_size == 2:
        inv = _inv_windows_2x2(d)
    else:
        raise ValueError("the device hierarchy build supports block sizes 1 and 2")
    return inv.to(a.diag.dtype)


def _power_lam_bt(a: BlockTridiag, inv: torch.Tensor, iters: int) -> torch.Tensor:
    """``lambda_max(S A)`` of the block-Jacobi smoother: ``iters`` power steps
    from the start vector of ``hierarchy.chebyshev_hierarchy``, a 0-d tensor
    (no host read)."""
    bs, n = a.block_size, a.n_blocks
    i = torch.arange(bs * n, dtype=a.diag.dtype, device=a.diag.device)
    x = torch.cos(1.7 * i).reshape(bs, n) + 0.5
    x = x / torch.linalg.vector_norm(x.reshape(-1))
    lam = torch.ones((), dtype=a.diag.dtype, device=a.diag.device)
    for _ in range(iters):
        y = bd_matvec(BlockDiag(inv), bt_matvec(a, x))
        lam = torch.linalg.vector_norm(y.reshape(-1))
        x = y / lam
    return lam


def _device_chain(a_fine: BlockTridiag, g, d, c, transfers: tuple, mass_invs: tuple, chebyshev: bool,
                  power_iters: int) -> list:
    """Per level ``(a, inv, ml, mu, lam)``: Galerkin-project G/D/C,
    recombine ``A = C - D M^-1 G`` (``mesh_heirarchy.jl:160-170``), invert
    the diagonal blocks, form the M-form streams and bound the smoothed
    spectrum.  The coarsest entry carries the operator only (it never
    smooths)."""
    out = []
    ops = (g, d, c)
    a = a_fine
    for l, m_inv in zip(transfers, mass_invs):
        inv = _bt_inv_diag(a)
        lam = _power_lam_bt(a, inv, power_iters) if chebyshev else None
        out.append((a, inv, block_mul(inv, a.lower), block_mul(inv, a.upper), lam))
        ops = tuple(bp_galerkin(l, x) for x in ops)
        a = schur_stiffness(*ops, BlockDiag(m_inv))
    out.append((a, None, None, None, None))
    return out


def build_dg_hierarchy_device(
    meshes: list,
    a_fine: BlockTridiag,
    g: BlockTridiag,
    d: BlockTridiag,
    c: BlockTridiag,
    *,
    dtype: torch.dtype = torch.float32,
    chebyshev: bool = True,
    power_iters: int = 20,
    device="cuda",
) -> Hierarchy:
    """A DG-topped float32 hierarchy whose coarse chain is computed on
    ``device``.

    ``meshes`` is the fine ``DgMesh`` and the ``AggMesh`` chain below it
    (uniform partitions, default switch); ``a_fine``, ``g``, ``d``, ``c`` the
    finest float64 operators from the host (``a_fine`` may already be the
    float32 hi part of a float-float pair: it is then used as it is).  The
    result is stripped (no G/D/C) and Chebyshev-wrapped (ratio 4, safety
    1.05, as ``chebyshev_hierarchy``), ready for ``multigrid_mixed``::

        prob = build_problem(spec, n, device="cpu")
        lv0 = prob.hierarchy.levels[0]
        h32 = build_dg_hierarchy_device(prob.meshes, lv0.a, lv0.g, lv0.d, lv0.c)
    """
    device = torch.device(device)
    if not isinstance(meshes[0], DgMesh):
        raise ValueError("the device hierarchy build is for DG-topped chains")
    if meshes[0].u_hat_left is not None:
        raise ValueError("the device hierarchy build supports the default switch only")

    # host float64: the transfer blocks, then the float32 casts
    transfers = []
    for fine_mesh, mesh in zip(meshes[:-1], meshes[1:]):
        if isinstance(mesh, ScatteredAggMesh):
            raise ValueError("the device hierarchy build requires uniform partitions")
        if isinstance(mesh, DgMesh):
            l = dg_dg_interpolation(mesh, fine_mesh)
        elif isinstance(fine_mesh, DgMesh):
            l = aggdg_dg_interpolation(mesh, fine_mesh)
        else:
            l = aggdg_aggdg_interpolation(mesh, fine_mesh)
        if not isinstance(l, BlockProlong):
            raise ValueError("the device hierarchy build requires uniform partitions")
        transfers.append(BlockProlong(l.blocks.to(device=device, dtype=dtype)))
    mass_invs = [m.mass_inv.blocks.to(device=device, dtype=dtype) for m in meshes[1:]]

    def cast(x: BlockTridiag) -> BlockTridiag:
        return BlockTridiag(*(t.to(device=device, dtype=dtype) for t in x))

    chain = _device_chain(cast(a_fine), cast(g), cast(d), cast(c), tuple(transfers), tuple(mass_invs),
                          chebyshev, power_iters)

    e = torch.zeros((0, 0, 0), dtype=dtype, device=device)
    empty = BlockTridiag(e, e, e)
    levels = []
    for a, inv, ml, mu, lam in chain[:-1]:
        s = BlockJacobiSmoother(inv=inv, ml=ml, mu=mu)
        if chebyshev:
            ratio, safety = 4.0, 1.05
            s = ChebyshevSmoother(base=s, lam_lo=lam * safety / ratio, lam_hi=lam * safety)
            s = _with_chebyshev_table(s)  # one host read of the interval per level
        levels.append(BlockLevel(a=a, g=empty, d=empty, c=empty, mass_inv=e, smoother=s))
    a_c = chain[-1][0]
    coarse_level = BlockLevel(a=a_c, g=empty, d=empty, c=empty, mass_inv=e,
                              smoother=BlockJacobiSmoother(inv=_bt_inv_diag(a_c)))
    levels.append(coarse_level)
    coarse = hierarchy_astype(_coarse_lu(coarse_level), dtype)
    return Hierarchy(levels=tuple(levels), transfers=tuple(transfers), coarse=coarse)
