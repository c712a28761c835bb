"""Solver-state checkpoints: the iterate, the iteration counter and the
histories in one ``.npz``, with the JAX package's keys (``x``,
``iteration``, ``res_history``, ``err_history``), so each package reads the
other's files.  The hierarchy setup is deterministic, so a restart from a
checkpoint continues the outer iteration where it stopped.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_solver_state(path: str, x, iteration: int, res_history=None, err_history=None) -> None:
    np.savez(
        path,
        x=_host(x),
        iteration=int(iteration),
        res_history=_host(res_history) if res_history is not None else np.array([]),
        err_history=_host(err_history) if err_history is not None else np.array([]),
    )


def load_solver_state(path: str, device="cuda"):
    """``(x, iteration, res_history, err_history)``: ``x`` on ``device``, the
    histories on the host (as in ``MultigridResult``)."""
    with np.load(path) as data:
        return (
            torch.from_numpy(data["x"]).to(device),
            int(data["iteration"]),
            torch.from_numpy(data["res_history"]),
            torch.from_numpy(data["err_history"]),
        )
