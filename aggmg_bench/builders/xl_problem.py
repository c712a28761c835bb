"""Builder ``xl_problem``: ``models.build_xl_problem(spec, n, **flags)``,
the stencil-inflated build of a uniform-mesh problem on the card (host work
at the stencil's size only).  The problem is the tuple ``(h_low, a_ff,
b_ff, norm_b)``; with ``ff_levels`` the second slot is an ``FFOps`` whose
``a_ffs[0]`` is the fine operator, a ``BTFFStencil`` with ``slim_fine``."""

from __future__ import annotations

import torch

FORM = "xl"


def build(cfg: dict, device):
    from agglomerationmultigrid1d_tpu_torch.models import build_xl_problem
    from agglomerationmultigrid1d_tpu_torch.utils.config import HierarchySpec

    args = cfg["builder_args"]
    spec = HierarchySpec(**{k: tuple(v) if isinstance(v, list) else v for k, v in args["spec"].items()})
    flags = {k: v for k, v in args.items() if k not in ("spec", "n")}
    return build_xl_problem(spec, int(args["n"]), device=device, **flags)


def _fine(prob):
    a = prob[1]
    return a.a_ffs[0] if hasattr(a, "a_ffs") else a


class StencilOperator:
    """A ``BTFFStencil`` (hi + lo joined in float64) on the host: its ``bw``
    boundary columns a side and the one interior column, broadcast."""

    def __init__(self, st):
        def join(hi, lo):
            return tuple(h.detach().to("cpu", torch.float64) + l_.detach().to("cpu", torch.float64)
                         for h, l_ in zip((hi.lower, hi.diag, hi.upper), (lo.lower, lo.diag, lo.upper)))

        self.left, self.mid, self.right = (join(getattr(st, "hi_" + s), getattr(st, "lo_" + s))
                                           for s in ("left", "mid", "right"))
        self.n, self.bw = st.n, st.bw

    def columns(self, lo: int, hi: int) -> tuple:
        out = []
        for left, mid, right in zip(self.left, self.mid, self.right):
            t = mid.expand(*mid.shape[:-1], hi - lo).clone()
            a, b = lo, min(hi, self.bw)
            if b > a:
                t[..., : b - lo] = left[..., a:b]
            a, b = max(lo, self.n - self.bw), hi
            if b > a:
                t[..., a - lo :] = right[..., a - (self.n - self.bw) : b - (self.n - self.bw)]
            out.append(t)
        return tuple(out)


def snapshot(prob) -> dict:
    st = _fine(prob)
    if not hasattr(st, "hi_mid"):
        raise ValueError("the xl_problem snapshot reads a stencil fine operator (slim_fine=True)")
    b_ff = prob[2]
    return dict(operator=StencilOperator(st),
                rhs=b_ff.hi.detach().to("cpu", torch.float64) + b_ff.lo.detach().to("cpu", torch.float64))
