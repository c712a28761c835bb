"""Agglomerated-DG mesh levels (local modal basis on merged base elements).

Agglomerate ``c`` owns the contiguous run of base elements
``offsets[c] .. offsets[c] + sizes[c] - 1``.  A mesh built with
``tables=True`` (the default) carries the per-base-element quadrature
tables, padded to the longest run ``r_max`` with ZERO jacobians so the
padding adds nothing to any quadrature sum:

* ``basis_q``  (m, r_max, n_q, p+1)  the modal basis at the mapped Gauss points
* ``x_quad``   (m, r_max, n_q)       the mapped Gauss points
* ``jacs``     (m, r_max)            the base elements' jacobians

and its mass integrated base element by base element.  A *lite* mesh
(``tables=False``) skips them: on an interval the modal basis
{1, 2(x - xc)/h} integrates in closed form (mass = diag(h, h/3)) and every
transfer is closed-form too, so the hierarchy builders take lite meshes.
Load vectors need the tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..numerics import gauss_quad, modal_basis_vals_batched
from ..ops.block_diag import BlockDiag, bd_inverse
from .dg_mesh import normalize_switch
from .topology import Mesh1D


@dataclasses.dataclass(frozen=True)
class AggMesh:
    p: int  # modal order, 0 or 1
    mesh: Mesh1D  # the BASE topological mesh (geometry provider)
    sizes: np.ndarray  # (m,) base elements per agglomerate
    offsets: np.ndarray  # (m,) first base element of each agglomerate
    sub_sizes: np.ndarray  # (m,) previous-level elements per agglomerate
    sub_offsets: np.ndarray  # (m,) first previous-level element of each agglomerate
    n_agg: int
    boxes: np.ndarray  # (m, 2) bounding boxes [x_left, x_right]
    mass: BlockDiag
    mass_inv: BlockDiag
    # per-interior-vertex switch (m - 1,), as on DgMesh: True = u-hat from the
    # LEFT agglomerate; None = all-default.  Read only where the level
    # assembles its own flux operators (a CG -> agg seam).
    u_hat_left: np.ndarray | None = None
    quad_nodes: np.ndarray | None = None  # (n_q,) Gauss points on [-1, 1]
    quad_weights: np.ndarray | None = None  # (n_q,)
    # the quadrature tables, None on a lite mesh (see the module docstring)
    basis_q: np.ndarray | None = None  # (m, r_max, n_q, p+1)
    x_quad: np.ndarray | None = None  # (m, r_max, n_q)
    jacs: np.ndarray | None = None  # (m, r_max), zero in the padding

    @property
    def n_elements(self) -> int:
        return self.n_agg

    @property
    def n_nodes(self) -> int:
        return self.n_agg * (self.p + 1)

    @property
    def has_tables(self) -> bool:
        """Whether the per-base-element quadrature tables were built."""
        return self.basis_q is not None

    def base_jacobians(self) -> np.ndarray:
        """``(m, r_max)`` jacobians of each agglomerate's base elements, zero
        past ``sizes[c]``; a lite mesh has none."""
        if self.jacs is None:
            raise ValueError(
                "this AggMesh was built with tables=False (hierarchy lite mode); "
                "rebuild with tables=True for quadrature-table access"
            )
        return self.jacs

    @property
    def block_size(self) -> int:
        return self.p + 1

    @property
    def r_max(self) -> int:
        return int(self.sizes.max())

    @property
    def uniform_r(self) -> int | None:
        """Group size if uniform, else None."""
        s = int(self.sizes[0])
        return s if bool((self.sizes == s).all()) else None

    @property
    def sub_uniform_r(self) -> int | None:
        s = int(self.sub_sizes[0])
        return s if bool((self.sub_sizes == s).all()) else None


def _normalize_partition(n: int, partition) -> np.ndarray:
    """Partition -> ``(m,)`` group sizes.  Takes a sequence of group sizes or
    the reference's explicit element-id lists (``agg::Vector{Vector{Int64}}``,
    0-based here), which must be contiguous runs covering ``0 .. n - 1`` in
    order."""
    part = list(partition)
    if part and hasattr(part[0], "__len__"):
        sizes, expect = [], 0
        for group in part:
            ids = np.asarray(group)
            if ids.size == 0 or not np.array_equal(ids, np.arange(expect, expect + ids.size)):
                raise ValueError(
                    "agglomerates must be contiguous, in-order runs of element ids "
                    f"(group starting at {expect} got {ids.tolist()})"
                )
            sizes.append(ids.size)
            expect += ids.size
        sizes = np.asarray(sizes, dtype=np.int64)
    else:
        sizes = np.asarray(part, dtype=np.int64)
    if sizes.min() < 1 or sizes.sum() != n:
        raise ValueError(f"partition sizes {sizes.tolist()} must be >= 1 and sum to {n}")
    return sizes


def make_agg_mesh(
    p: int,
    mesh: Mesh1D,
    r_base: int | None = None,
    *,
    partition=None,
    sub_sizes: np.ndarray | None = None,
    tables: bool = True,
    switch: np.ndarray | None = None,
    allow_trapped: bool = False,
) -> AggMesh:
    """Agglomeration level from the base mesh: ``r_base`` consecutive base
    elements per agglomerate, or an explicit contiguous ``partition`` (group
    sizes, or the reference's lists of element ids).  ``sub_sizes`` records
    how many previous-level elements each agglomerate merges (default: the
    base sizes, i.e. a first level).
    ``tables=False`` builds a lite mesh (no quadrature tables, the mass in
    closed form), as every hierarchy builder does.
    ``switch`` (optional, ``(m - 1,)`` bool over the interior agglomerate
    vertices) is the explicit per-vertex switch of :func:`.dg_mesh.make_dg_mesh`,
    validated the same way."""
    if p not in (0, 1):
        raise ValueError("agglomerated modal basis only implemented for p = 0 and p = 1")
    n_base = mesh.n_elements
    if (r_base is None) == (partition is None):
        raise ValueError("give exactly one of r_base or partition")
    if partition is not None:
        sizes = _normalize_partition(n_base, partition)
    else:
        if n_base % r_base:
            raise ValueError(
                "number of base elements must divide into uniform agglomerates; "
                "pass an explicit partition for ragged sizes"
            )
        sizes = np.full(n_base // r_base, r_base, dtype=np.int64)
    m = sizes.shape[0]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    if sub_sizes is None:
        sub_sizes = sizes.copy()
    sub_offsets = np.concatenate([[0], np.cumsum(sub_sizes)[:-1]])

    qx, qw = gauss_quad(2 * p)
    vx = mesh.vertex_x
    boxes = np.stack([vx[offsets], vx[offsets + sizes]], axis=1)
    h_agg = boxes[:, 1] - boxes[:, 0]

    to_blocks = lambda nij: BlockDiag(torch.from_numpy(np.moveaxis(nij, 0, -1).copy()))  # noqa: E731
    basis_q = x_quad = jacs = None
    if tables:
        # padded (m, r_max) gather of the base elements; a zero jacobian in
        # the padding makes every quadrature contribution of its rows zero
        r_max = int(sizes.max())
        valid = np.arange(r_max)[None, :] < sizes[:, None]
        j_idx = np.minimum(offsets[:, None] + np.arange(r_max)[None, :], n_base - 1)
        centers = np.where(valid, mesh.centers[j_idx], boxes[:, :1] * 0.5 + boxes[:, 1:] * 0.5)
        jacs = np.where(valid, mesh.jacobians[j_idx], 0.0)
        x_quad = centers[:, :, None] + jacs[:, :, None] * qx[None, None, :]
        basis_q = modal_basis_vals_batched(p, boxes, x_quad)
        # mass blocks: sum over base elements of J_b * sum_l w_l phi_i phi_j
        mass = to_blocks(np.einsum("cs,l,csli,cslj->cij", jacs, qw, basis_q, basis_q))
        mass_inv = bd_inverse(mass)
    else:
        # closed form on the interval: {1, xi} is mass-orthogonal, diag(h, h/3)
        mass_nij = np.zeros((m, p + 1, p + 1))
        mass_nij[:, 0, 0] = h_agg
        inv_nij = np.zeros_like(mass_nij)
        inv_nij[:, 0, 0] = 1.0 / h_agg
        if p == 1:
            mass_nij[:, 1, 1] = h_agg / 3.0
            inv_nij[:, 1, 1] = 3.0 / h_agg
        mass, mass_inv = to_blocks(mass_nij), to_blocks(inv_nij)

    return AggMesh(
        p=p,
        mesh=mesh,
        sizes=sizes,
        offsets=offsets,
        sub_sizes=np.asarray(sub_sizes, dtype=np.int64),
        sub_offsets=sub_offsets,
        n_agg=m,
        boxes=boxes,
        mass=mass,
        mass_inv=mass_inv,
        u_hat_left=normalize_switch(switch, m, allow_trapped),
        quad_nodes=qx,
        quad_weights=qw,
        basis_q=basis_q,
        x_quad=x_quad,
        jacs=jacs,
    )


def coarsen_agg_mesh(
    fine: AggMesh, r_sub: int = 2, *, partition=None, tables: bool | None = None
) -> AggMesh:
    """Next agglomeration level, merging ``r_sub`` consecutive fine
    agglomerates (or explicit ``partition`` group sizes, in fine
    agglomerates).  ``tables`` defaults to the fine level's choice."""
    if partition is not None:
        sub = _normalize_partition(fine.n_agg, partition)
    else:
        if fine.n_agg % r_sub:
            raise ValueError(
                "fine agglomerate count must divide by r_sub; pass an explicit "
                "partition for ragged grouping"
            )
        sub = np.full(fine.n_agg // r_sub, r_sub, dtype=np.int64)
    # base-element sizes of each coarse agglomerate = sum of its fine sizes
    ends = np.cumsum(sub)
    starts = ends - sub
    cum = np.concatenate([[0], np.cumsum(fine.sizes)])
    base_sizes = cum[ends] - cum[starts]
    if tables is None:
        tables = fine.has_tables
    return make_agg_mesh(fine.p, fine.mesh, partition=base_sizes, sub_sizes=sub, tables=tables)
