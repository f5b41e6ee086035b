"""Operation counts and peaks."""

import pytest

from portbench.core import flops, peaks


def test_ctc_count_equals_the_recorded_fig5_step():
    # 9,222,248,448,000: chip_smoke.py's count for a fig_5 step at B=2000
    assert flops.ctc_train_flops(2000, 600, 60, 512, 3, 11, 14, 4) == \
        9_222_248_448_000


def test_seq2seq_count_at_the_cell():
    got = flops.seq2seq_train_flops(1224, 200, 24, 100, 500, 10, 3, 9)
    assert got == pytest.approx(2.59e12, rel=1e-3)


def test_gru_layer_work_products():
    fwd_f, fwd_b, bwd_f, bwd_b = flops.gru_layer_work(7, 3, 5, 4)
    assert fwd_f == 2 * 7 * 3 * 12 * (5 + 4)
    assert bwd_f == 2 * 7 * 3 * 12 * (2 * 5 + 2 * 4)
    no_dx = flops.gru_layer_work(7, 3, 5, 4, need_dx=False)
    assert no_dx[2] == 2 * 7 * 3 * 12 * (5 + 2 * 4)
    assert no_dx[3] == bwd_b - 7 * 3 * 5 * 4


def test_least_time_takes_the_larger_bound():
    assert peaks.least_seconds(495e12, 1.0) == pytest.approx(1.0)
    assert peaks.least_seconds(1.0, 3.35e12) == pytest.approx(1.0)
