"""Precision and placement of operator containers.

The containers (``BlockTridiag``, ``BlockPenta``, ``BlockCOO``,
``BlockProlong``, ``ScatteredProlong``, ``BlockLevel``, ``Hierarchy``, ...)
are NamedTuples of tensors and host ints; :func:`tree_map` rebuilds one with
a function applied to every tensor leaf and passes the ints (block counts,
``PaddedBTCoarseSolver.n_dof``) through.  :func:`hierarchy_astype` casts the
floating leaves only, so integer index tensors (a ``BlockCOO``'s rows and
columns, a ``ScatteredProlong``'s owners) keep their type.
"""

from __future__ import annotations

import torch


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of nested NamedTuples / tuples / lists."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def tree_astype(tree, dtype: torch.dtype):
    """Cast every floating tensor leaf of an operator container to ``dtype``."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


def hierarchy_astype(h, dtype: torch.dtype):
    """A copy of a Hierarchy (or any operator container) with every floating
    leaf cast to ``dtype``."""
    return tree_astype(h, dtype)


def tree_to(tree, device):
    """Move every tensor leaf of an operator container to ``device``."""
    return tree_map(lambda t: t.to(device), tree)
