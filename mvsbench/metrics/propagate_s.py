"""Seconds of propagation, every ``PMMVS.propagate(it)`` summed
(pipeline/propagate.py, views.py, refine.py, core/grid.py), averaged
over the window's untraced reconstructions."""


def read(r):
    return r.span_seconds("propagate")
