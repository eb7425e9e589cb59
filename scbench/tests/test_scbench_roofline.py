"""The frozen work counts against hand-worked values."""
import pytest

from scbench.roofline import fabric, peaks


def test_fabric_step_work_by_hand():
    # two rows of 1000 words, one live entry each, 1990 words granted:
    # bytes 2 x (16 x 1000 + 4 + 12 + 8); ops 52 x 1990, no lookup
    assert fabric.step_work([1000, 1000], 1990, [1, 1]) == \
        (2 * (16_000 + 4 + 12 + 8), 52 * 1990)
    # 5 live entries: ceil(log2 5) = 3 comparisons a word
    assert fabric.step_work([10], 0, [5]) == (160 + 4 + 60 + 8, 30)
    assert fabric.lookup_ops(10, 1024) == 100


def test_int32_peak_and_least_time():
    assert peaks.int32_ops_per_s(132, 1980.0) == pytest.approx(1.672704e13)
    # 3.35 MB takes 1 us at 3.35 TB/s; 1e6 ops at 1e12/s take 1 us
    assert peaks.least_time_s(3.35e6, 0, 1e12) == pytest.approx(1e-6)
    assert peaks.least_time_s(0, 2e6, 1e12) == pytest.approx(2e-6)
