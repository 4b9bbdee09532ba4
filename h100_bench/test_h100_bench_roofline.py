"""The work counts and peaks at small shapes."""
import pytest

from h100_bench import roofline


def test_matern52_build_counts():
    flops, bytes_ = roofline.kbuild_work("matern52_ard", 5, 8, 4, 6)
    assert flops == 5 * 8 * 4 * (4 * 6 + 10)
    assert bytes_ == 4 * ((8 + 4) * 6 + 5 * 7 + 5 * 8 * 4)


def test_gower_build_counts_share_the_distances_over_lanes():
    flops, bytes_ = roofline.kbuild_work("gower_matern52", 5, 8, 8, 6, continuous=4)
    assert flops == 64 * (3 * 4 + 1 * 2) + 5 * 64 * 9 * 6
    assert bytes_ == roofline.kbuild_work("matern52_ard", 5, 8, 8, 6)[1]


def test_cholesky_counts_and_bound():
    flops, bytes_ = roofline.cholesky_work(5, 4096)
    assert flops == pytest.approx(5 * 4096 ** 3 / 3)
    assert bytes_ == 2 * 4 * 5 * 4096 * 4097 // 2
    t, bound = roofline.least_seconds(flops, bytes_)
    assert bound == "flops" and t == pytest.approx(flops / 67e12)


def test_full_size_builds_are_bound_by_bytes():
    for family in ("matern52_ard", "gower_matern52"):
        t, bound = roofline.least_seconds(*roofline.kbuild_work(family, 5, 4096, 4096, 6, 4))
        assert bound == "bytes"
        assert t == pytest.approx(5 * 4096 * 4096 * 4 / 3.35e12, rel=1e-3)


def test_share_is_the_least_time_over_the_measured():
    flops, bytes_ = 67e9, 1.0
    assert roofline.share_pct(flops, bytes_, 2e-3) == pytest.approx(50.0)


def test_unknown_family_has_no_count():
    with pytest.raises(ValueError):
        roofline.kbuild_work("rbf", 1, 2, 2, 1)
