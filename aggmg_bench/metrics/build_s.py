"""``build_s``: seconds of the builder call (host float64 assembly or the
stencil inflation on the card), host clock ending in a synchronize."""


def read(rec):
    return rec.build_s
