"""Seconds of seeding (``PMMVS.seed``; pipeline/seed.py), averaged over
the window's untraced reconstructions."""


def read(r):
    return r.span_seconds("seed")
