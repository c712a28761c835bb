"""The traffic generator: a closed loop of solves, as a time stepper or a
parameter sweep issues them, each from ``x0 = 0``.

A mix file (``traffic/<mix>.json``) names the entry point and its arguments
and the problems its right-hand sides come from (``rhs``): ``problems``
lists each by its source, named by its ``torch`` function, and its
boundary data.  The seed makes no new problem: it draws the order in which
the window cycles through the listed ones and, for each, a sign and a power
of two ``2^e``, ``e`` in ``scale_exp``, that scales its data.  A power of
two scales every vector of a solve exactly, so every seed gives the solver
the same work on other numbers: the spread between seeds is the system's,
not the traffic's.  The benchmark and the reference make the same vectors
from the seed.
"""

from __future__ import annotations

import numpy as np
import torch


class Draw:
    """One problem of the window: its source (a function of a float64
    tensor of points) and boundary data, all scaled by ``scale``."""

    def __init__(self, source, left: float, right: float, scale: float = 1.0):
        self._source, self.scale = source, scale
        self.left, self.right = scale * left, scale * right

    def source(self, x: torch.Tensor) -> torch.Tensor:
        return self._source(x) * self.scale


def problems(rhs: dict) -> list:
    """The mix's ``(source, left, right)`` problems, as it lists them."""
    return [(getattr(torch, p["source"]), float(p["left"]), float(p["right"])) for p in rhs["problems"]]


def draws(rhs: dict, seed: int) -> list:
    """The window's problems for ``seed`` (any whole number): the listed
    problems in a seeded order, each scaled by a seeded sign and power of
    two."""
    rng = np.random.default_rng(int(seed) % 2**64)
    base = problems(rhs)
    lo, hi = rhs["scale_exp"]
    out = []
    for k in rng.permutation(len(base)):
        source, left, right = base[k]
        scale = float(rng.choice([-1.0, 1.0])) * 2.0 ** int(rng.integers(lo, hi + 1))
        out.append(Draw(source, left, right, scale))
    return out


def rhs_vector(prob, d: Draw) -> torch.Tensor:
    """The whole (bs, n) float64 right-hand side of draw ``d`` on a
    reference ``prob``, on ``prob.device``."""
    return torch.cat([prob.rhs_columns(d.source, d.left, d.right, lo, hi) for lo, hi in prob.blocks()], dim=1)
