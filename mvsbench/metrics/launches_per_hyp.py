"""Device kernels launched during propagation per hypothesis the engine
scored (``RoundStats.total``): the refinement's and the NCC ops' launch
count (pipeline/refine.py, ops/ncc.py)."""

from mvsbench.trace import is_kernel


def read(r):
    hyp = r.counters.get("hypotheses", 0)
    if not r.labelled() or hyp <= 0:
        return None
    n = sum(1 for name, _, _, span in r.ops
            if span is not None and span.startswith("propagate") and is_kernel(name))
    return n / hyp
