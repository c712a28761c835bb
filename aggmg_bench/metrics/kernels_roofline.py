"""``kernels_roofline``: the hand-written kernels' (K1-K6 of
``csrc/block_kernels.cu``) share of their roofline over every launch in the
traced solves: the sum of the launches' bounds over the sum of their device
times.  A launch's bound is ``roofline.bound`` at its block size and the
block columns it covered, recorded where it was made (``launches.py``) and
paired with the kernel events in launch order.  Nothing to read where no
such kernel ran, or where the records and the events disagree."""

from aggmg_bench import roofline


def read(rec):
    if rec.trace is None:
        return None
    events = sorted((e for e in rec.trace.kernels if roofline.kernel_label(e[0])), key=lambda e: e[1])
    if not events or len(events) != len(rec.launches):
        return None
    bound_ms = time_ms = 0.0
    for (name, _, d), (label, bs, n) in zip(events, rec.launches):
        if roofline.kernel_label(name) != (label, bs):
            return None
        bound_ms += roofline.bound(label, bs, n)[0]
        time_ms += d / 1e6
    return 100.0 * bound_ms / time_ms
