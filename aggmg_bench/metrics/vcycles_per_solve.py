"""``vcycles_per_solve``: V-cycles per solve of the window, every kind the
entry runs (float32 inner, float64, true), from the solver's own returned
counts; the mean over the window's solves."""


def read(rec):
    c = rec.cycles_per_solve
    return sum(c) / len(c) if c else None
