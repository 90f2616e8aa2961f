"""The yardstick reproduces the kernel table's bounds (PERF.md: K3 at r =
64 and K5 at r = 126 on one 1088x1920 plane)."""

import pytest

from benchlib import roofline


def test_k3_r64():
    assert round(roofline.search_bound_ms("full", 1088, 1920, 64), 4) == \
        1.5565


def test_k5_r126():
    assert round(roofline.search_bound_ms("hier", 1088, 1920, 126), 4) == \
        0.3781


@pytest.mark.parametrize("search", ["full", "hier"])
def test_planes_scale_the_bound(search):
    one = roofline.search_bound_ms(search, 2176, 3840, 126)
    assert roofline.search_bound_ms(search, 2176, 3840, 126, 4) == \
        pytest.approx(4 * one)
