"""The roofline counts against hand-computed values."""

import pytest

from port_bench import roofline


def test_gj_inverse_bound():
    # (128, 1152): 2 n^3 x 128 = 3.9137e11 flops at 67 TFLOP/s
    assert roofline.gj_inverse_s(128, 1152) == pytest.approx(
        2 * 1152 ** 3 * 128 / 67e12)
    ms = roofline.gj_inverse_s(128, 1152) * 1e3
    assert ms == pytest.approx(5.8413, abs=1e-3)
    # (256, 256): 0.1282 ms, flops-bound (bytes 0.0401 ms)
    ms = roofline.gj_inverse_s(256, 256) * 1e3
    assert ms == pytest.approx(0.12821, abs=1e-4)


def test_gj_solve_bound():
    n = 1152
    flops = 128 * (2 * n ** 3 / 3 + 2 * n * n)
    assert roofline.gj_solve_s(128, n) == pytest.approx(flops / 67e12)
    assert roofline.gj_solve_s(128, n) * 1e3 == pytest.approx(1.9522, abs=1e-3)


def test_bandwidth_bound_wins_when_the_work_is_thin():
    # (4096, 32): 4 x 4096 x 2 x 1024 B = 33.5 MB -> 10.0 us at 3.35 TB/s,
    # against 268 MFLOP -> 4.0 us
    assert roofline.gj_inverse_s(4096, 32) == pytest.approx(
        4 * 4096 * 2 * 32 * 32 / 3.35e12)


def test_bmm_bound():
    # the Newton-Schulz product at (4096, 256, 256, 256): 137.4 GFLOP
    ms = roofline.bmm_s(4096, 256, 256, 256) * 1e3
    assert ms == pytest.approx(2.0513, abs=1e-3)
    # a matrix-vector product is bound by its bytes
    assert roofline.bmm_s(4096, 256, 256, 1) == pytest.approx(
        4 * 4096 * (256 * 256 + 256 + 256) / 3.35e12)
