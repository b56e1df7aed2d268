"""Seconds of output: every ``PMMVS.write_patches`` (snapshots and the
final PLY and patch file) and ``join_snapshots`` (io/ply.py, io/patch_io.py),
averaged over the window's untraced reconstructions."""


def read(r):
    return r.span_seconds("write")
