"""The port's screen layer (lofreq_tpu_torch/ops/screen.py) against the
reference's JAX screen (lofreq_tpu/ops/screen.py) on the CPU.

Masks must agree except on rows whose f32 log tail lies within 1e-4 of
the f32 threshold: the two DPs round differently at the ulp level (XLA's
fused scan vs torch's separate ops), which only matters at the threshold.
The screen must also stay conservative against the exact host DP.
"""

import os

import numpy as np
import pytest
import torch

from lofreq_tpu.core.poissbin import snpcaller_batch
from lofreq_tpu.core.quals import merge_srcq_mapq_baq_and_bq
from lofreq_tpu.ops import screen as ref_screen
from lofreq_tpu_torch.ops import cuda_poissbin as cp
from lofreq_tpu_torch.ops import screen as S

NEAR = 1e-4


def _codes_inputs(seed, B=1024, S_=128):
    rng = np.random.default_rng(seed)
    codes = rng.integers(16, 160, (B, S_)).astype(np.uint8)
    codes[rng.random((B, S_)) < 0.3] = 255
    depths = rng.integers(1, S_ + 1, B).astype(np.int32)
    ks = rng.integers(1, 25, B).astype(np.int32)
    lt = rng.uniform(-40.0, -1.0, B).astype(np.float32)
    return codes, depths, ks, lt


def _port_tail(codes, ks, lt):
    return cp.screen_codes_torch(
        *(torch.from_numpy(np.ascontiguousarray(a))
          for a in (codes, ks, lt)))[0].numpy()


def _assert_masks_agree(got, want, tail, lt):
    near = np.abs(tail - lt) <= NEAR
    assert got.shape == want.shape and got.dtype == bool
    assert ((got == want) | near).all(), np.nonzero((got != want) & ~near)
    # the inputs exercise both verdicts
    assert 0 < got.sum() < len(got)


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["xla_scan", "pallas_interpret"])
def test_screen_codes_matches_reference(use_pallas):
    """Port screen_codes (codes beyond depth set to 255 on the host) vs the
    reference screen_body (depths masked on the device)."""
    B = 1024 if not use_pallas else 256   # interpret mode is slow
    codes, depths, ks, lt = _codes_inputs(1, B)
    ref_fn = ref_screen._build_screen_fn(use_pallas=use_pallas)
    want = np.asarray(ref_fn(codes, depths, ks, lt, s=128))
    masked = np.where(np.arange(128)[None, :] < depths[:, None], codes,
                      255).astype(np.uint8)
    got = cp.screen_codes(torch.from_numpy(masked), torch.from_numpy(ks),
                          torch.from_numpy(lt))[1].numpy()
    _assert_masks_agree(got, want, _port_tail(masked, ks, lt), lt)


@pytest.fixture(scope="module")
def screen_env():
    """The reference's CPU screen (XLA scan) compiled for [1024, s]."""
    os.environ["LOFREQ_TPU_DEVICE_SCREEN"] = "1"
    try:
        for s in (64, 128):
            assert ref_screen.screen_ready(1024, s, wait_s=600)
        yield
    finally:
        del os.environ["LOFREQ_TPU_DEVICE_SCREEN"]


def test_screen_dispatch_codes_matches_reference(screen_env):
    rng = np.random.default_rng(2)
    B = 700
    codes = np.sort(rng.integers(16, 160, (B, 128)), axis=1).astype(
        np.uint8)
    npad = rng.integers(0, 100, B)   # screen_codes_for pads with 255
    codes[np.arange(128)[None, :] >= 128 - npad[:, None]] = 255
    ks = rng.integers(1, 25, B)
    bonf = rng.integers(3, 300_000, B).astype(np.float64)
    sig = 0.01
    h = ref_screen.screen_dispatch_codes(codes, ks, bonf, sig)
    assert h is not None, "reference screen not compiled"
    want = ref_screen.screen_fetch(h)
    got = S.screen_fetch(S.screen_dispatch_codes(codes, ks, bonf, sig,
                                                 "cpu"))
    lt = np.log(sig * S.MARGIN / bonf).astype(np.float32)
    _assert_masks_agree(got, want, _port_tail(codes, ks, lt), lt)


@pytest.mark.parametrize("D", [50, 300], ids=["shallow", "top_s"])
def test_screen_dispatch_matches_reference(screen_env, D):
    """The prob path: host quantization (top-S partition for deep
    columns, 2.0 pads and rows beyond depth -> 255) then the screen."""
    rng = np.random.default_rng(4 + D)
    B = 600
    depths = rng.integers(1, D + 1, B)
    probs = np.full((B, D), 2.0)
    for i in range(B):
        probs[i, :depths[i]] = 10.0 ** (-rng.integers(10, 41, depths[i])
                                        / 10.0)
    ks = rng.integers(1, 25, B)
    bonf = rng.integers(3, 300_000, B).astype(np.float64)
    sig = 0.01
    h = ref_screen.screen_dispatch(probs, depths, ks, bonf, sig)
    assert h is not None, "reference screen not compiled"
    want = ref_screen.screen_fetch(h)
    got = S.screen_fetch(S.screen_dispatch(probs, depths, ks, bonf, sig,
                                           "cpu"))
    codes = S.quantize_codes(probs, depths)
    assert codes.shape == (B, 64 if D == 50 else 128)
    lt = np.log(sig * S.MARGIN / bonf).astype(np.float32)
    _assert_masks_agree(got, want,
                        _port_tail(codes, np.maximum(ks, 1), lt), lt)


def test_quantize_codes_conservative():
    """decode(code) <= p for every valid prob (the ceil rounding), pads
    and rows beyond depth decode to the identity 0."""
    rng = np.random.default_rng(6)
    B, D = 64, 40
    probs = 10.0 ** (-rng.uniform(0.0, 12.0, (B, D)))
    probs[:, -3:] = 2.0
    depths = rng.integers(0, D - 2, B)
    codes = S.quantize_codes(probs, depths)
    dec = cp.decode_codes(torch.from_numpy(codes)).double().numpy()
    in_depth = np.arange(D)[None, :] < depths[:, None]
    assert (dec[:, :D] <= np.where(in_depth, probs, 0.0) * (1 + 1e-6)).all()
    assert (codes[:, D:] == 255).all()
    assert (codes[:, :D][~in_depth] == 255).all()


def test_screen_is_conservative():
    """Every column the exact DP finds significant survives the port's
    screen (test_device.py:test_screen_is_conservative's inputs)."""
    rng = np.random.default_rng(3)
    B, D = 200, 400
    probs = np.sort(10 ** (-rng.uniform(1.0, 4.5, (B, D))), axis=1)
    depths = rng.integers(50, D + 1, B)
    ks = rng.integers(1, 9, B)
    bonf = np.full(B, 30000.0)
    sig = 0.01
    cand = S.screen_fetch(S.screen_dispatch(probs, depths, ks, bonf, sig,
                                            "cpu"))
    counts = np.zeros((B, 3), dtype=np.int64)
    counts[:, 0] = ks
    pv = snpcaller_batch(probs, depths, counts, bonf, sig)
    with np.errstate(over="ignore"):   # LDBL_MAX p-values * bonf
        sig_mask = (pv[:, 0] * bonf) < sig
    assert sig_mask.any()
    assert not np.any(sig_mask & ~cand)
    assert cand.sum() < B


def test_screen_conservative_vs_exact_planted():
    """Planted variants of varying strength (test_device.py's
    test_device_screen_conservative_vs_exact pattern): the screen keeps
    every column the exact host DP calls and rules out most others."""
    rng = np.random.default_rng(17)
    B, D = 256, 400
    sig, bonf = 0.01, 3000.0
    bq = rng.integers(25, 41, (B, D))
    valid = rng.random((B, D)) < 0.97
    ks = np.zeros(B, np.int64)
    for c in range(0, B, 4):
        k = int(rng.integers(2, 12))
        bq[c, rng.choice(D, k, replace=False)] = 35
        ks[c] = k
    ks[ks == 0] = rng.integers(1, 3, int((ks == 0).sum()))
    depths = valid.sum(axis=1)
    probs = np.full((B, D), 2.0)
    for c in range(B):
        q = bq[c][valid[c]]
        n = len(q)
        probs[c, :n] = np.sort(merge_srcq_mapq_baq_and_bq(
            np.full(n, -1), np.full(n, 60), np.full(n, -1), q))
    cand = S.screen_fetch(S.screen_dispatch(
        probs, depths, ks, np.full(B, bonf), sig, "cpu"))
    counts = np.zeros((B, 3), dtype=np.int64)
    counts[:, 0] = ks
    pv = snpcaller_batch(probs, depths, counts, np.full(B, bonf), sig)
    with np.errstate(over="ignore"):
        called = (pv[:, 0] * bonf) < sig
    assert called.sum() > 20
    assert not (called & ~cand).any()
    assert cand.sum() < B * 0.6


def test_kmax_overflow_rows_are_candidates():
    """k > KMAX: the clipped tail can rule nothing out."""
    B = 32
    probs = np.full((B, 10), 1e-6)
    ks = np.full(B, S.KMAX + 1)
    cand = S.screen_fetch(S.screen_dispatch(
        probs, np.full(B, 10), ks, np.full(B, 1e9), 0.01, "cpu"))
    assert cand.all()


def test_dispatch_stats_count():
    before = dict(S.DISPATCH_STATS)
    codes, _d, ks, _lt = _codes_inputs(8, B=40)
    S.screen_fetch(S.screen_dispatch_codes(codes, ks, np.full(40, 30.0),
                                           0.01, "cpu"))
    assert S.DISPATCH_STATS["dispatched"] == before["dispatched"] + 1
    assert S.DISPATCH_STATS["columns"] == before["columns"] + 40
