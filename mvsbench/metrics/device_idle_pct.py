"""Percent of a reconstruction's wall time in which no operation ran on
the card: 1 - the union of the traced reconstruction's device operations
(kernels, copies, fills) over the untraced reconstructions' mean wall
time, which the profiler does not lengthen."""


def read(r):
    if r.busy_s is None or r.recon_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.recon_s)
