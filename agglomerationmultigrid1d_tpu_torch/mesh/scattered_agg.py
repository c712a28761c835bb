"""Non-contiguous ("scattered") agglomerated-DG mesh levels.

The reference's arbitrary-partition constructors
(``AgglomeratedDgMesh1(mP, agg::Vector{Vector{Int64}}, mesh, baseMesh)`` and
its recursive sibling ``AgglomeratedDgMeshN``): each agglomerate owns an
arbitrary set of base elements.

* the agglomerate's modal basis ``{1, 2 (x - xc) / h}`` lives on the bounding
  box ``[min, max]`` of its members, holes included in the box but in no
  integral;
* every integral sums base element by base element over the members only;
* a base-mesh vertex is an *interface* iff its two neighbouring base
  elements belong to different agglomerates.

A scattered agglomerate couples, through its interface vertices, to every
agglomerate adjacent to any of its runs, so the operators over these meshes
are block-COO (:mod:`..ops.block_coo`).  A strongly interleaved partition
(agglomerates whose boxes span much of the domain) approximates poorly: the
V-cycle contraction degrades and can diverge, in the JAX package as here —
keep scattered agglomerates local.

Everything is host NumPy in float64 and linear in the element count (plus
one stable sort): an element-id partition is validated and turned into an
owner map without a loop over the agglomerates, and a coarser level's owner
map is a composition of two.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from ..numerics import gauss_quad, modal_basis_vals_batched
from ..ops.block_diag import BlockDiag
from .topology import Mesh1D


@dataclasses.dataclass(frozen=True)
class ScatteredAggMesh:
    p: int  # modal order, 0 or 1
    mesh: Mesh1D  # the BASE topological mesh (geometry provider)
    assign: np.ndarray  # (n_base,) owning agglomerate of each base element
    sub_assign: np.ndarray  # (n_prev,) previous-level element -> agglomerate
    n_agg: int
    quad_nodes: np.ndarray  # (n_q,)
    quad_weights: np.ndarray  # (n_q,)
    boxes: np.ndarray  # (m, 2) member bounding boxes
    basis_q: np.ndarray  # (n_base, n_q, p+1) owner basis at mapped Gauss points
    x_quad: np.ndarray  # (n_base, n_q)
    deriv_vals: np.ndarray  # (m, p+1) constant modal derivatives [0, 2/h]
    mass: BlockDiag  # (p+1, p+1, m)
    mass_inv: BlockDiag
    # interfaces: interior base vertices whose two neighbours differ in owner
    iface_left: np.ndarray  # (n_if,) LEFT agglomerate id
    iface_right: np.ndarray  # (n_if,) RIGHT agglomerate id
    iface_x: np.ndarray  # (n_if,) vertex coordinate
    trace_left: np.ndarray  # (n_if, p+1) LEFT owner's basis at the vertex
    trace_right: np.ndarray  # (n_if, p+1)
    # per-interface switch: True = u-hat from the LEFT agglomerate (the
    # default rule); None = all-default
    u_hat_left: np.ndarray | None = None

    @property
    def n_elements(self) -> int:
        return self.n_agg

    @property
    def block_size(self) -> int:
        return self.p + 1

    @property
    def n_nodes(self) -> int:
        return self.n_agg * (self.p + 1)

    @property
    def n_interfaces(self) -> int:
        return self.iface_left.shape[0]

    @property
    def is_contiguous(self) -> bool:
        """True iff every agglomerate is one contiguous run, in order."""
        step = np.diff(self.assign)
        return bool((step != 0).sum() == self.n_agg - 1) and bool((step >= 0).all())


def _flatten_groups(groups) -> tuple[np.ndarray, np.ndarray]:
    """``(ids, lens)``: the groups' element ids concatenated, and each group's
    length.  A 2-d integer array is taken as one group per row."""
    if isinstance(groups, np.ndarray) and groups.ndim == 2:
        return groups.astype(np.int64).ravel(), np.full(groups.shape[0], groups.shape[1], np.int64)
    groups = list(groups)
    lens = np.fromiter((len(g) for g in groups), dtype=np.int64, count=len(groups))
    ids = np.fromiter(itertools.chain.from_iterable(groups), dtype=np.int64, count=int(lens.sum()))
    return ids, lens


def _groups_to_assign(n_base: int, groups) -> np.ndarray:
    """Element-id lists -> ``(n_base,)`` owner map; the groups must partition
    ``0 .. n_base - 1``.  The first offending group (in order) is reported,
    with the JAX package's messages, checked in its order: empty, out of
    range, listed twice in the group, already in an earlier group; then the
    elements in no group."""
    ids, lens = _flatten_groups(groups)
    m = lens.shape[0]
    gid = np.repeat(np.arange(m), lens)
    first_bad = {}  # check -> first group failing it

    def note(check: str, bad_groups: np.ndarray) -> None:
        if bad_groups.size:
            first_bad[check] = int(bad_groups.min())

    note("empty", np.nonzero(lens == 0)[0])
    in_range = (ids >= 0) & (ids < n_base)
    note("range", gid[~in_range])
    # sort the in-range entries by (element, group): equal neighbours are
    # an element listed twice, in one group or in two
    ok = np.nonzero(in_range)[0]
    order = ok[np.lexsort((gid[ok], ids[ok]))]
    e, g = ids[order], gid[order]
    again = np.nonzero(e[1:] == e[:-1])[0] + 1  # later listings of an element
    same = g[again] == g[again - 1]
    note("twice", g[again[same]])
    note("earlier", g[again[~same]])
    if first_bad:
        g_id = min(first_bad.values())
        check = next(c for c in ("empty", "range", "twice", "earlier") if first_bad.get(c) == g_id)
        start = int(lens[:g_id].sum())
        mine = ids[start : start + lens[g_id]]
        if check == "empty":
            raise ValueError(f"agglomerate {g_id} is empty")
        if check == "range":
            raise ValueError(f"agglomerate {g_id} references element out of range 0..{n_base - 1}")
        if check == "twice":
            dup = mine[np.diff(np.sort(mine), prepend=-1) == 0]
            raise ValueError(
                f"element(s) {np.unique(dup).tolist()} listed more than once in agglomerate {g_id}"
            )
        owner = np.full(n_base, m, dtype=np.int64)
        np.minimum.at(owner, ids[: start], gid[: start])
        raise ValueError(
            f"element(s) {mine[owner[mine] < g_id].tolist()} assigned to more than one agglomerate"
        )
    assign = np.full(n_base, -1, dtype=np.int64)
    assign[ids] = gid
    if (assign == -1).any():
        miss = np.nonzero(assign == -1)[0]
        raise ValueError(f"element(s) {miss.tolist()} not in any agglomerate")
    return assign


def _sum_by_owner(values: np.ndarray, assign: np.ndarray, m: int) -> np.ndarray:
    """``out[c, ...] = sum of values[e, ...] over e with assign[e] == c``, in
    element order (``np.add.at``'s sums, at ``np.bincount``'s speed)."""
    flat = values.reshape(values.shape[0], -1)
    out = np.stack([np.bincount(assign, weights=flat[:, j], minlength=m) for j in range(flat.shape[1])], axis=1)
    return out.reshape((m,) + values.shape[1:])


def _build(p: int, mesh: Mesh1D, assign: np.ndarray, sub_assign: np.ndarray, switch) -> ScatteredAggMesh:
    """A scattered level from its owner map (the part of
    :func:`make_scattered_agg_mesh` after validation)."""
    if p not in (0, 1):
        raise ValueError("agglomerated modal basis only implemented for p = 0, 1")
    m = int(assign.max()) + 1
    vx = mesh.vertex_x
    boxes = np.empty((m, 2))
    boxes[:, 0] = np.inf
    boxes[:, 1] = -np.inf
    np.minimum.at(boxes[:, 0], assign, vx[:-1])
    np.maximum.at(boxes[:, 1], assign, vx[1:])

    qx, qw = gauss_quad(2 * p)
    jacs = mesh.jacobians
    x_quad = mesh.centers[:, None] + jacs[:, None] * qx[None, :]  # (n_base, n_q)
    basis_q = modal_basis_vals_batched(p, boxes[assign], x_quad)  # (n_base, n_q, bs)

    # mass: the members' J_e sum_l w_l phi_i phi_j, element by element
    per_el = np.einsum("e,l,eli,elj->eij", jacs, qw, basis_q, basis_q)
    mass_nij = _sum_by_owner(per_el, assign, m)
    mass = np.moveaxis(mass_nij, 0, -1)
    mass_inv = np.moveaxis(np.linalg.inv(mass_nij), 0, -1)

    h_box = boxes[:, 1] - boxes[:, 0]
    deriv_vals = np.zeros((m, 1)) if p == 0 else np.stack([np.zeros(m), 2.0 / h_box], axis=1)

    # interfaces: interior vertices v (between base elements v-1 and v)
    # where the owner changes
    change = np.nonzero(assign[1:] != assign[:-1])[0] + 1
    iface_left = assign[change - 1]
    iface_right = assign[change]
    iface_x = vx[change]
    trace_left = modal_basis_vals_batched(p, boxes[iface_left], iface_x[:, None])[:, 0, :]
    trace_right = modal_basis_vals_batched(p, boxes[iface_right], iface_x[:, None])[:, 0, :]

    if switch is not None:
        switch = np.asarray(switch, dtype=bool)
        if switch.shape != (change.size,):
            raise ValueError(
                f"switch must have one entry per interface ({change.size}), got shape {switch.shape}"
            )
        if switch.all():
            switch = None

    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    return ScatteredAggMesh(
        p=p, mesh=mesh, assign=assign, sub_assign=np.asarray(sub_assign, dtype=np.int64), n_agg=m,
        quad_nodes=qx, quad_weights=qw, boxes=boxes, basis_q=basis_q, x_quad=x_quad,
        deriv_vals=deriv_vals, mass=BlockDiag(t(mass)), mass_inv=BlockDiag(t(mass_inv)),
        iface_left=iface_left, iface_right=iface_right, iface_x=iface_x,
        trace_left=trace_left, trace_right=trace_right, u_hat_left=switch,
    )


def make_scattered_agg_mesh(
    p: int,
    mesh: Mesh1D,
    groups,
    *,
    switch: np.ndarray | None = None,
    sub_assign: np.ndarray | None = None,
) -> ScatteredAggMesh:
    """A first scattered level from explicit element-id lists, the
    reference's ``agg::Vector{Vector{Int64}}`` (0-based here): ``groups[c]``
    is the set of base elements agglomerate ``c`` owns (a 2-d integer array,
    one row per agglomerate, is taken too).  Contiguity is not required (use
    ``make_agg_mesh`` for contiguous runs: its operators stay
    block-tridiagonal).  ``switch`` (optional, ``(n_interfaces,)`` bool, in
    the order of the interface vertices) sets the per-interface flux switch;
    True is the default rule."""
    if p not in (0, 1):
        raise ValueError("agglomerated modal basis only implemented for p = 0, 1")
    assign = _groups_to_assign(mesh.n_elements, groups)
    return _build(p, mesh, assign, assign.copy() if sub_assign is None else sub_assign, switch)


def coarsen_scattered_agg_mesh(fine, groups, *, switch: np.ndarray | None = None) -> ScatteredAggMesh:
    """The next scattered level, merging FINE AGGLOMERATES by arbitrary id
    lists (the reference's recursive ``AgglomeratedDgMeshN``): coarse
    agglomerate ``c`` owns the base elements of its fine agglomerates.
    ``fine`` is a :class:`ScatteredAggMesh` or a contiguous
    :class:`~.agg_mesh.AggMesh`.  The owner map is the composition
    ``g_assign[fine_assign]``, one gather."""
    from .agg_mesh import AggMesh

    if isinstance(fine, AggMesh):
        fine_assign = np.repeat(np.arange(fine.n_agg), fine.sizes)
    else:
        fine_assign = fine.assign
    g_assign = _groups_to_assign(fine.n_agg, groups)
    return _build(fine.p, fine.mesh, g_assign[fine_assign], g_assign, switch)
