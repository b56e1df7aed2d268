"""The frozen byte count against the bound times PERF.md records for the
sampler's two main-path forms (K1: 24,576 windows, 0.00458 ms; K2:
786,432 windows, 0.14564 ms). The benchmark counts no touched plane
words, so its bound sits at most 1 % under those and never above."""

import pytest

from mvsbench import roofline


@pytest.mark.parametrize("nwin,recorded", [(24576, 0.00458), (786432, 0.14564)])
def test_bound_reproduces_recorded(nwin, recorded):
    ms, by, nbytes, flops = roofline.bound(nwin, "rgb")
    assert by == "bytes"
    assert recorded * 0.99 <= ms <= recorded
    assert nbytes == nwin * 32 + nwin * 49 * 3 * 4


def test_touched_words_and_launch_sum():
    ms0 = roofline.bound(1000, "luma")[0]
    assert roofline.bound(1000, "luma", touched=10**6)[0] > ms0
    windows = {"ungrouped": {24576: 2}, "grouped": {786432: 1}}
    total = roofline.launches_bound_ms(windows, 7)
    assert total == pytest.approx(2 * roofline.bound(24576, "rgb")[0]
                                  + roofline.bound(786432, "rgb")[0])
    assert roofline.form_mode("luma_grad") == ("luma", True)
