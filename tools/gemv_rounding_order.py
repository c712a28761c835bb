"""In which order does ``torch.einsum`` round the solve path's block
contractions on this device?  For each form (``bd_matvec``'s
``"ijn,jn->in"``, ``bp_prolong``'s ``"jibn,bn->jin"``, one offset of
``bp_restrict``'s ``"ibn,in->bn"`` on a strided slice), dtype and shape, the
einsum's output is compared entry by entry with candidate orders of the
contracted sum, each formed exactly (``block_kernels._fma`` emulates a fused
multiply-add; :func:`candidates`): the share of entries each candidate reproduces is printed, one
JSON line per case, then per form, dtype and length of the contracted sum
the candidates that reproduce every entry of every case.  The hand-written
contraction kernels follow the order found for the contracted lengths the
cells use (``block_kernels._gemv_dot``).

    PYTHONPATH=. python3 tools/gemv_rounding_order.py [--device cuda|cpu] [--small]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from agglomerationmultigrid1d_tpu_torch.ops.kernels.block_kernels import _fma


def _chain(ms, vs, fused: bool):
    acc = ms[0] * vs[0]
    for m, v in zip(ms[1:], vs[1:]):
        acc = _fma(m, v, acc) if fused else acc + m * v
    return acc


def candidates(ms, vs) -> dict:
    """The contracted sum ``sum_j ms[j] vs[j]`` in several orders: one
    chain ascending or descending, with fused or rounded products; two
    fused chains, over ``j < h`` and ``j >= h`` (``split{h}``) or over the
    even and the odd ``j``, added; four rounded products added in pairs."""
    k = len(ms)
    out = {
        "fma_ascending": _chain(ms, vs, True),
        "fma_descending": _chain(ms[::-1], vs[::-1], True),
        "plain_ascending": _chain(ms, vs, False),
        "plain_descending": _chain(ms[::-1], vs[::-1], False),
    }
    for h in range(1, k):
        out[f"split{h}_fma"] = _chain(ms[:h], vs[:h], True) + _chain(ms[h:], vs[h:], True)
    if k >= 3:
        out["even_odd_fma"] = _chain(ms[0::2], vs[0::2], True) + _chain(ms[1::2], vs[1::2], True)
    if k == 4:
        out["plain_pairs"] = (ms[0] * vs[0] + ms[1] * vs[1]) + (ms[2] * vs[2] + ms[3] * vs[3])
    return out


def shares(got: torch.Tensor, cands: dict) -> dict:
    return {name: float((c == got).double().mean()) for name, c in cands.items()}


def rows(mat, vec, out_rows, contracted):
    """``cands[name]`` stacked over the output rows: row ``i`` contracts
    ``mat(i, j)`` with ``vec(j)`` over ``j < contracted``."""
    per_row = [candidates([mat(i, j) for j in range(contracted)], [vec(j) for j in range(contracted)])
               for i in range(out_rows)]
    return {name: torch.stack([r[name] for r in per_row]) for name in per_row[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="small shapes only (a rehearsal)")
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    g = torch.Generator(device=dev).manual_seed(20261018)
    exact = {}  # (form, dtype, contracted length) -> candidates exact in every case so far

    def report(case: dict, contracted: int) -> None:
        print(json.dumps(case), flush=True)
        key = (case["form"], case["dtype"], contracted)
        hit = {k for k, v in case["shares"].items() if v == 1.0}
        exact[key] = exact.get(key, hit) & hit

    sizes = (100, 3072) if a.small else (100, 3072, 49152, 786432, 12582912)
    for dt in (torch.float32, torch.float64):
        def rnd(*s):
            return torch.randn(*s, generator=g, device=dev, dtype=dt)

        for bs in (1, 2, 3, 4):
            for n in sizes + (() if a.small or bs != 2 or dt != torch.float32 else (50331648,)):
                blocks, x = rnd(bs, bs, n), rnd(bs, n)
                got = torch.einsum("ijn,jn->in", blocks, x)
                s = shares(got, rows(lambda i, j: blocks[i, j], lambda j: x[j], bs, bs))
                report({"form": "bd_matvec", "dtype": str(dt), "bs": bs, "n": n, "shares": s}, bs)
                del blocks, x, got
        for r, bs_f, bs_c in ((1, 4, 2), (2, 2, 2), (4, 2, 2), (1, 2, 2), (2, 4, 4), (4, 4, 4), (4, 3, 2), (2, 1, 1)):
            north_star = not a.small and (r, bs_f, bs_c) == (4, 2, 2) and dt == torch.float32
            for n_c in sizes if a.small else sizes[:-1] + ((3145728, 12582912) if north_star else ()):
                blocks, xc = rnd(r, bs_f, bs_c, n_c), rnd(bs_c, n_c)
                got = torch.einsum("jibn,bn->jin", blocks, xc)  # (r, bs_f, n_c)
                cands = [rows(lambda i, b: blocks[j, i, b], lambda b: xc[b], bs_f, bs_c) for j in range(r)]
                s = shares(got, {k: torch.stack([c[k] for c in cands]) for k in cands[0]})
                report({"form": "bp_prolong", "dtype": str(dt), "r": r, "bs_f": bs_f, "bs_c": bs_c, "n_c": n_c,
                        "shares": s}, bs_c)
                rf = rnd(bs_f, r * n_c)
                for j in range(r):
                    v = rf[:, j::r]
                    got = torch.einsum("ibn,in->bn", blocks[j], v)
                    s = shares(got, rows(lambda b, i: blocks[j, i, b], lambda i: v[i], bs_c, bs_f))
                    report({"form": "bp_restrict", "dtype": str(dt), "r": r, "j": j, "bs_f": bs_f, "bs_c": bs_c,
                            "n_c": n_c, "shares": s}, bs_f)
                del blocks, xc, rf, got
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    for (form, dt, k), names in sorted(exact.items()):
        print(json.dumps({"summary": form, "dtype": dt, "contracted": k, "exact_in_every_case": sorted(names)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
