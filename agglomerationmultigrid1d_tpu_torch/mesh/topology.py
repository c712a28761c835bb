"""1D topological mesh and boundary conditions (host-side, array-of-structs free).

The reference builds a pointer-linked Vertex/Face graph (``src/meshes.jl``,
``tests/mesh_generator.jl:5-59``) whose only information content in 1D is the
sorted vertex coordinates plus which domain end carries which boundary
condition (``src/boundary_conditions.jl``, ``tests/mesh_generator.jl:61-93``).
We store exactly that as NumPy arrays; everything downstream is derived index
arithmetic (element k spans vertices k, k+1).
"""

from __future__ import annotations

import dataclasses

import numpy as np

DIRICHLET = "dir"
NEUMANN = "neu"


@dataclasses.dataclass(frozen=True)
class Mesh1D:
    """Sorted 1D mesh; element (face) k spans [vertex_x[k], vertex_x[k+1]]."""

    vertex_x: np.ndarray  # (n_el + 1,)

    @property
    def n_elements(self) -> int:
        return self.vertex_x.shape[0] - 1

    @property
    def h(self) -> np.ndarray:
        return np.diff(self.vertex_x)

    @property
    def jacobians(self) -> np.ndarray:
        """h/2 per element (cf. ``src/cg_mesh.jl:32``)."""
        return 0.5 * self.h

    @property
    def centers(self) -> np.ndarray:
        return 0.5 * (self.vertex_x[:-1] + self.vertex_x[1:])

    def ref_map(self, k, xi):
        """Map reference coordinates xi in [-1, 1] into element(s) k."""
        return self.centers[k] + self.jacobians[k] * np.asarray(xi)


def create_uniform_mesh(n: int, xin: float, xout: float) -> Mesh1D:
    """Uniform n-element mesh on [xin, xout] (cf. ``tests/mesh_generator.jl:5-59``)."""
    x = xin + (np.arange(n + 1, dtype=np.float64) / n) * (xout - xin)
    x[0] = xin
    return Mesh1D(vertex_x=x)


def create_graded_mesh(n: int, xin: float, xout: float, ratio: float = 2.0) -> Mesh1D:
    """Geometrically stretched n-element mesh on [xin, xout]: element sizes grow
    by ``ratio**(1/(n-1))`` each, so the last element is ``ratio`` times the
    first.  The reference's ``Mesh`` carries arbitrary vertex positions
    (``src/meshes.jl:11-17``); this is the standard non-uniform fixture."""
    if n < 2 or ratio <= 0:
        raise ValueError("need n >= 2 and ratio > 0")
    q = ratio ** (1.0 / (n - 1))
    h = q ** np.arange(n, dtype=np.float64)
    x = np.concatenate([[0.0], np.cumsum(h)])
    x = xin + (xout - xin) * (x / x[-1])
    x[0], x[-1] = xin, xout
    return Mesh1D(vertex_x=x)


@dataclasses.dataclass(frozen=True)
class BoundaryCondition:
    """Dirichlet/Neumann data at the two domain ends.

    ``left``/``right`` are ``(kind, value)`` with kind in {"dir", "neu"} — the
    reference's ``mBdCond`` pairs (``src/boundary_conditions.jl:2``).
    """

    left: tuple[str, float]
    right: tuple[str, float]

    def __post_init__(self):
        for kind, _ in (self.left, self.right):
            if kind not in (DIRICHLET, NEUMANN):
                raise ValueError(f"unknown boundary kind {kind!r}")

    @property
    def dir_left(self) -> bool:
        return self.left[0] == DIRICHLET

    @property
    def dir_right(self) -> bool:
        return self.right[0] == DIRICHLET

    @property
    def neu_left(self) -> bool:
        return self.left[0] == NEUMANN

    @property
    def neu_right(self) -> bool:
        return self.right[0] == NEUMANN
