"""The window sampler's share of its roofline: the least time of every
launch the reconstruction made (``cuda_ncc.WINDOWS``: launches per form
and batch size; ``roofline.bound``) over the device time of the
sampler's kernels in the trace (ops/cuda_ncc.py, csrc/sample_windows*.cu)."""

from mvsbench.roofline import launches_bound_ms

KERNELS = ("window_kernel", "fused_kernel", "window_grad_kernel")


def read(r):
    ns = sum(dur for name, _, dur, _ in r.ops if any(k in name for k in KERNELS))
    bound_ms = launches_bound_ms(r.windows, r.wsize)
    if ns <= 0 or bound_ms <= 0:
        return None
    return 100.0 * bound_ms * 1e6 / ns
