import pytest

from gpubench.roofline import PEAKS, pass_bound_s, pass_bytes, pass_ops, peaks_for


def test_pass_counts():
    # soc-Epinions1 at d = 64: 8 bytes an edge, 2 x 4 x 64 bytes a state row
    assert pass_bytes(508_837, 75_879, 64) == 8 * 508_837 + 512 * 75_879 == 42_920_744
    assert pass_ops(508_837, 64) == 2 * 508_837 * 64


def test_pass_bound_is_the_larger_term():
    h = PEAKS["H100"]
    b = pass_bound_s(508_837, 75_879, 64, h)
    assert b == pytest.approx(42_920_744 / 3.35e12)  # ~12.8 us, bytes bound
    assert b == pytest.approx(12.81e-6, rel=1e-3)
    road = pass_bound_s(733_846, 264_346, 64, h)
    assert road == pytest.approx((8 * 733_846 + 512 * 264_346) / 3.35e12)
    # a width at which operations bind
    wide = pass_bound_s(1000, 1, 10**6, h)
    assert wide == pytest.approx(pass_ops(1000, 10**6) / h["f32_flops_per_s"])


def test_peaks_by_card_name():
    assert peaks_for("NVIDIA H100 80GB HBM3") is PEAKS["H100"]
    with pytest.raises(KeyError):
        peaks_for("some other card")
