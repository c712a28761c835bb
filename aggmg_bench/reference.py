"""The plain reference, by name, and the comparisons that decide ``correct``.

A configuration names its reference (``"reference": "<name>"``), a module
``references/<name>.py`` of plain PyTorch and NumPy that works the fine
problem out again from the configuration's ``discretization`` block.  It
imports nothing of the measured package nor of the JAX package, and has:

- ``Problem(disc, dtype=torch.float64, device="cpu")``, whose
  ``blocks()`` are ``(lo, hi)`` column blocks covering ``[0, n)``;
  ``operator_columns(lo, hi)`` the operator's streams for those columns, a
  tuple in the order of the builders' snapshots (``Columns``);
  ``rhs_columns(source, left, right, lo, hi)`` the right-hand side of a
  source (a function of a float64 tensor of points) and boundary data;
  ``matvec_columns(x, lo, hi)`` ``(A x)[:, lo:hi]`` in float64;
- ``direct_solve(op, b)``, a direct solve of the whole operator ``op`` (the
  streams over all columns) in its dtype: the control's solve.

A new family of operators is a new module there, found by name like the
builders and entry points.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def load(name: str, folder: Path = HERE):
    """The reference module ``folder/references/<name>.py``."""
    path = Path(folder) / "references" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_aggmg_reference_{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reference module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Columns:
    """An operator held whole as a tuple of streams (the last axis the
    column), read by column blocks as a reference's ``operator_columns``
    is."""

    def __init__(self, parts):
        self.parts = tuple(parts)

    def columns(self, lo: int, hi: int) -> tuple:
        return tuple(t[..., lo:hi] for t in self.parts)


def relative_residual(prob, x: torch.Tensor, b_of) -> float:
    """``||b - A x|| / ||b||`` in float64 on the reference ``prob``, in
    column blocks; ``b_of(lo, hi)`` gives the right-hand side's columns."""
    num = den = 0.0
    for lo, hi in prob.blocks():
        b = b_of(lo, hi).to(device=prob.device, dtype=torch.float64)
        r = b - prob.matvec_columns(x, lo, hi)
        num += float(torch.sum(r * r))
        den += float(torch.sum(b * b))
    return math.sqrt(num) / math.sqrt(den)


def max_column_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest ``max|got - want|`` of a block column over ``max|want|`` of
    that column (the last axis is the column; a zero column is judged
    against 1)."""
    g = got.to(torch.float64).reshape(-1, got.shape[-1])
    w = want.to(device=got.device, dtype=torch.float64).reshape(-1, want.shape[-1])
    scale = w.abs().amax(dim=0).clamp_min(torch.finfo(torch.float64).tiny)
    scale = torch.where(w.abs().amax(dim=0) > 0, scale, torch.ones_like(scale))
    return float(((g - w).abs().amax(dim=0) / scale).max())
