"""The benchmark's arithmetic on fixed inputs: rooflines, the device's
busy union and idle gaps, the percentile and the rates."""

import numpy as np
import pytest

from portbench import tracing
from portbench.metrics import (_roofline, call_cols_per_s,
                               confirm_busy_s, devbaq_busy_s,
                               device_idle_pct, ingest_busy_s,
                               screen_cols_per_call)
from portbench.roofline import baq_hmm, screen_codes


def test_screen_codes_cost_counts_inputs_outputs_and_dp_steps():
    codes = np.full((2, 128), 255, np.uint8)
    codes[0, :10] = 7
    codes[1, :3] = 9
    nbytes, ops = screen_codes.cost(codes, np.array([2, 40]))
    assert nbytes == 2 * 128 + 2 * 13
    # row 0: 10 steps at kc 2; row 1: 3 steps at kc clipped to 16
    assert ops == 10 * (3 * 2 + 3) + 3 * (3 * 16 + 3)


def test_baq_cost_leaves_out_the_band_rows():
    class T:
        def __init__(self, shape):
            self.shape = shape

    nbytes, ops = baq_hmm.cost(T((32768, 106)), T((32768, 100)))
    assert nbytes == 32768 * (106 + 100 + 400 + 4) + 2 * 32768 * 100 * 4
    assert ops == 32768 * 100 * 15 * 80


def test_roofline_share_takes_the_larger_bound():
    rec = {"roofline": {"f": {"bytes": 3.35e9, "ops": 6.7e9,
                              "kernel_s": 0.004}}}
    # bytes bound 1 ms, ops bound 0.1 ms: 1 ms of 4 ms
    assert _roofline.share(rec, "f") == pytest.approx(25.0)
    rec["roofline"]["f"]["kernel_s"] = None
    assert _roofline.share(rec, "f") is None
    assert _roofline.share(rec, "g") is None


def test_union_and_gaps_of_device_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 12)]
    assert tracing.union_length(iv) == 3 + 1 + 2
    assert tracing.gaps(iv, 0, 11) == [(3, 5), (6, 10)]
    assert tracing.gaps([], 0, 4) == [(0, 4)]
    assert tracing.mean_times_launches([1.0, 3.0], 10) == 20.0
    assert tracing.mean_times_launches([], 10) is None


def test_host_clock_metrics():
    rec = dict(setup_s=5.0, calls=20, window_s=10.0,
               call_s=list(np.arange(1, 21) / 10.0), cols=[1000] * 20)
    assert call_cols_per_s.read(rec) == 2000.0
    assert call_cols_per_s.read(dict(rec, calls=0, cols=[])) is None


def test_stage_metrics_count_each_second_once():
    st = {"ingest.raw": 1.0, "ingest_columns": 3.0, "ingest.columns": 2.0,
          "ingest.extract": 0.5, "ingest.device_baq": 1.0, "confirm": 4.0,
          "exact_dp": 2.0}
    rec = dict(stages=st, calls=2, window_s=10.0, busy_s=1.0,
               dispatch={"columns": 300, "dispatched": 4})
    assert ingest_busy_s.read(rec) == pytest.approx((1 + 3 - 0.5 - 1) / 2)
    assert devbaq_busy_s.read(rec) == pytest.approx(0.75)
    assert confirm_busy_s.read(rec) == pytest.approx(2.0)
    assert screen_cols_per_call.read(rec) == 150
    assert device_idle_pct.read(rec) == pytest.approx(90.0)
    assert devbaq_busy_s.read(dict(rec, stages={"confirm": 1.0})) is None
