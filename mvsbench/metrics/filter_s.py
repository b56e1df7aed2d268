"""Seconds of the filter passes, every ``PMMVS.filter()`` summed
(pipeline/filters.py), averaged over the window's untraced
reconstructions."""


def read(r):
    return r.span_seconds("filter")
