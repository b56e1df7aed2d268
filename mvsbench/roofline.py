"""Peaks of the card and the least time of the window sampler's work.

The byte and operation counts are a frozen copy of ``chip_smoke.py``'s
``bound`` and its per-sample operation table at commit 9af5b6f: per
window 32 bytes of parameters (view, level, lattice origin and steps),
each output float written once, each touched plane word read once (the
caller passes that count where it has it; the benchmark does not, so
its bound leaves those few bytes out and never overstates a share), and
for the backward 24 bytes of gradients per window; float32 operations
per sample against the float32 peak outside the tensor cores.
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# float32 operations per sample: lattice 8; tap fractions 4; RGB: 4 tap
# weights + 3 channels x 4 taps x (mul + add); luma: 4 taps x 2 mul + 3 add
FLOPS_PER_SAMPLE = {"rgb": 8 + 4 + 4 + 24, "luma": 8 + 4 + 11}
# the backward: lattice 8, fractions 4, slope differences 2, per channel
# 14, the two slopes 2 and the six partial sums 10
GRAD_FLOPS_PER_SAMPLE = {"rgb": 8 + 4 + 2 + 3 * 14 + 2 + 10, "luma": 8 + 4 + 2 + 14 + 2 + 10}


def form_mode(form: str) -> Tuple[str, bool]:
    """The channel mode and direction of a launch form named as the
    sampler's launch counter names it (``ungrouped``, ``luma_grouped``,
    ``grad`` ...)."""
    return ("luma" if form.startswith("luma") else "rgb"), form.endswith("grad")


def bound(nwin: int, mode: str, wsize: int = 7, touched: int = 0,
          grad: bool = False) -> Tuple[float, str, int, int]:
    """Least time (ms) of `nwin` windows of `wsize` on the card, what
    bounds it ("bytes" or "operations"), the bytes and the operations."""
    S = wsize * wsize
    out_floats = nwin * S * (1 if mode == "luma" else 3)
    nbytes = nwin * 32 + touched * 4 + out_floats * 4 + (nwin * 24 if grad else 0)
    flops = nwin * S * (GRAD_FLOPS_PER_SAMPLE if grad else FLOPS_PER_SAMPLE)[mode]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def launches_bound_ms(windows: Dict[str, Dict[int, int]], wsize: int) -> float:
    """Summed least time (ms) of the launches counted per form and batch
    size ({form: {windows: launches}})."""
    total = 0.0
    for form, sizes in windows.items():
        mode, grad = form_mode(form)
        for nwin, count in sizes.items():
            total += count * bound(int(nwin), mode, wsize, grad=grad)[0]
    return total
