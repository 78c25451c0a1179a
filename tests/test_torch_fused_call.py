"""The port's fused column call (kernel K2, lofreq_tpu_torch/ops/fused_call.py
and csrc/fused_call.cuh) against the JAX reference, on the CPU.

1. pack_columns_np byte-equal to the reference's.
2. fused_column_torch against the reference Pallas kernel
   (pallas_fused_call._build_kernel, interpret mode) and the port's
   build_fused_column_call(device="cpu") against the reference's
   build_fused_column_call, at B = 2,048, D = 64 and B = 1,024, D = 96:
   counts, depths, alt_nt, tested and num_tested exact, tails within 1e-4
   where above -80.
3. The port's fused step against the port's unfused step
   (tests/test_fused_device_call.py's tolerances), and the fused screen's
   conservativeness against the exact DP of the port's own core.poissbin.
4. The .cuh body built with g++ into a ctypes shim against
   fused_column_torch, at ragged shapes, read by read and with the depth
   split into T = 1, 2, 4, 8 slices merged in K2's tree, also on tails
   near the floor and on nt4 fields past N; the table decode against
   the expf decode it replaced (a frozen copy in tests/frozen_cuh/), bit
   for bit.
The `gpu`-marked cases hold K2 against its plain version on the card,
check that two launches agree bit for bit, and check the wrapper's input
checks.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from lofreq_tpu.ops import pallas_fused_call as ref_fc
from lofreq_tpu_torch.core.poissbin import snpcaller_batch
from lofreq_tpu_torch.core.quals import merge_srcq_mapq_baq_and_bq
from lofreq_tpu_torch.ops import fused_call as fc
from lofreq_tpu_torch.ops.device_call import build_column_call
from lofreq_tpu_torch.testing import cuh_shims
from test_fused_device_call import _batch

TAIL_TOL = 1e-4
TAIL_FLOOR = -80.0
EXACT_KEYS = ("alt_counts", "alt_raw", "alt_nt", "depths", "tested",
              "num_tested")
SHAPES = ((2048, 64), (1024, 96))
# name -> build kwargs (the filters and the fields in the merge)
CONFS = {
    "baq": dict(use_baq=True),
    "no_baq_sq": dict(use_baq=False, use_sq=True),
    "no_mq": dict(use_mq=False, min_bq=10, min_alt_bq=20),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, Dd, seed, sq=False):
    """test_fused_device_call's batch; with sq, source quals 0..44 on most
    rows (the reference batch has none)."""
    args = list(_batch(B, Dd, seed=seed, depth_frac=0.9))
    if sq:
        rng = np.random.default_rng(seed + 1)
        args[4] = np.where(rng.random((B, Dd)) < 0.8,
                           rng.integers(0, 45, (B, Dd)), -1).astype(np.int16)
    return args


def near_floor_batch(B=256, Dd=2016, seed=21):
    """(packed [Dd, B], ref ids [B]) whose log tails sit near the floor:
    every read of a column at one high quality (bq = BAQ = 36..53, MQ 60,
    so p from about 5e-4 down to 1e-5) and 16..30 planted reads of one alt
    base, so that P(X >= 16) spans about e^-40 to e^-100."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, B).astype(np.int8)
    level = rng.integers(36, 54, B).astype(np.int16)
    bq = np.repeat(level[:, None], Dd, axis=1)
    mq = np.full((B, Dd), 60, np.int16)
    sq = np.full((B, Dd), -1, np.int16)
    nt4 = np.repeat(ref[:, None], Dd, axis=1)
    alt = ((ref + rng.integers(1, 4, B)) % 4).astype(np.int8)
    for c, k in enumerate(rng.integers(16, 31, B)):
        nt4[c, rng.choice(Dd, k, replace=False)] = alt[c]
    packed = fc.pack_columns_np(nt4, bq, bq.copy(), mq, sq,
                                np.ones((B, Dd), bool))
    return packed, ref.astype(np.int32)


def _kernel_kw(conf):
    return {k: conf[k] for k in ("min_bq", "min_alt_bq", "use_baq",
                                 "use_mq", "use_sq") if k in conf}


@pytest.mark.parametrize("seed", [3, 11])
def test_pack_columns_np_matches_reference(seed):
    nt4, bq, baq, mq, sq, valid, _ref, _bonf = _inputs(300, 70, seed,
                                                       sq=True)
    sq[0, :5] = [126, 200, 255, -1, 0]   # the clamp and the missing marks
    mq[1, :3] = [126, 254, 255]
    got = fc.pack_columns_np(nt4, bq, baq, mq, sq, valid)
    want = ref_fc.pack_columns_np(nt4, bq, baq, mq, sq, valid)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert got.flags["C_CONTIGUOUS"]


def _ref_kernel(packed, ref_nt4, conf):
    """The reference Pallas kernel's raw outputs (interpret mode)."""
    from lofreq_tpu import defaults as D

    Dd = packed.shape[0]
    run = ref_fc._build_kernel(
        Dd, ref_fc.TILE_B, conf.get("min_bq", D.DEFAULT_MIN_BQ),
        conf.get("min_alt_bq", D.DEFAULT_MIN_ALT_BQ),
        conf.get("use_baq", True), conf.get("use_mq", True),
        conf.get("use_sq", False))
    return [np.asarray(a) for a in run(packed, ref_nt4)]


CASES = [(s, "baq") for s in SHAPES] + [(SHAPES[1], c) for c in CONFS
                                        if c != "baq"]


@pytest.mark.parametrize("shape,conf", CASES,
                         ids=[f"{b}x{d}-{c}" for (b, d), c in CASES])
def test_fused_column_torch_matches_pallas(shape, conf):
    """The plain version vs the reference kernel: counts and depths exact,
    tails within 1e-4 where above -80."""
    B, Dd = shape
    kw = CONFS[conf]
    args = _inputs(B, Dd, seed=B + Dd, sq=kw.get("use_sq", False))
    packed = fc.pack_columns_np(*args[:6])
    ref_nt4 = args[6].astype(np.int32)
    tail_w, depth_w, acnt_w, araw_w = _ref_kernel(packed, ref_nt4, kw)
    tail, depth, acnt, araw = fc.fused_column_torch(
        torch.from_numpy(packed), torch.from_numpy(ref_nt4), **_kernel_kw(kw))
    np.testing.assert_array_equal(depth.numpy(), depth_w[0].astype(np.int32))
    np.testing.assert_array_equal(acnt.numpy(), acnt_w[:4].T.astype(np.int32))
    np.testing.assert_array_equal(araw.numpy(), araw_w[:4].T.astype(np.int32))
    t, tw = tail.numpy(), tail_w[0]
    above = (t > TAIL_FLOOR) & (tw > TAIL_FLOOR)
    assert above.sum() > B // 2
    assert np.abs(t - tw)[above].max() <= TAIL_TOL


def _assert_step_exact(got, want):
    for k in EXACT_KEYS:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    t_g = got["screen_tail"].numpy()
    t_w = np.asarray(want["screen_tail"])
    m = (t_g > TAIL_FLOOR) & (t_w > TAIL_FLOOR)
    assert np.abs(t_g - t_w)[m].max(initial=0.0) <= TAIL_TOL


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{b}x{d}" for b, d in SHAPES])
def test_fused_step_matches_jax(shape):
    """build_fused_column_call(device="cpu") vs the reference's fused step
    (Pallas in interpret mode), and masks equal off the threshold."""
    B, Dd = shape
    nt4, bq, baq, mq, sq, valid, ref_nt4, bonf = _inputs(B, Dd, seed=Dd)
    packed = fc.pack_columns_np(nt4, bq, baq, mq, sq, valid)
    ref4 = ref_nt4.astype(np.int32)
    want = ref_fc.build_fused_column_call(use_baq=True)(packed, ref4, bonf)
    fused = fc.build_fused_column_call(use_baq=True, device="cpu")
    got = fused(*(torch.from_numpy(a) for a in (packed, ref4, bonf)))
    assert set(got) == set(want)
    _assert_step_exact(got, want)
    lt = np.log(np.float32(0.01 * 1e3)) - np.log(bonf)
    near = np.abs(np.asarray(want["screen_tail"]) - lt) <= TAIL_TOL
    diff = got["candidate"].numpy() != np.asarray(want["candidate"])
    assert not (diff & ~near).any()
    assert got["screen_tail"].dtype == torch.float32


def test_fused_matches_unfused_counts_and_screens():
    """The port's fused step vs the port's unfused step, as
    tests/test_fused_device_call.py holds the reference's: identical
    counts, depths, alt ids and tested columns, tails within atol 1e-2,
    rtol 1e-3 where both are above -80."""
    B, Dd = 2048, 64
    nt4, bq, baq, mq, sq, valid, ref_nt4, bonf = _inputs(B, Dd, seed=3)
    want = build_column_call(use_baq=True, device="cpu")(
        *(torch.from_numpy(a) for a in (nt4, bq, baq, mq, sq, valid,
                                         ref_nt4, bonf)))
    packed = fc.pack_columns_np(nt4, bq, baq, mq, sq, valid)
    got = fc.build_fused_column_call(use_baq=True, device="cpu")(
        torch.from_numpy(packed), torch.from_numpy(ref_nt4.astype(np.int32)),
        torch.from_numpy(bonf))
    for k in EXACT_KEYS:
        assert torch.equal(got[k], want[k]), k
    t_g, t_w = got["screen_tail"].numpy(), want["screen_tail"].numpy()
    m = want["tested"].numpy() & (t_w > TAIL_FLOOR) & (t_g > TAIL_FLOOR)
    assert m.sum() > 0
    assert np.allclose(t_g[m], t_w[m], atol=1e-2, rtol=1e-3)


def test_fused_screen_is_conservative_vs_exact():
    """Every exactly-significant column is a fused-screen candidate (the
    contract that makes screen discards safe), with the exact DP of the
    port's own core.poissbin (test_fused_device_call.py's test, on the
    port)."""
    B, Dd = 1024, 96
    nt4, bq, baq, mq, sq, valid, ref_nt4, bonf = _batch(B, Dd, seed=11)
    rng = np.random.default_rng(99)
    for c in rng.integers(0, B, 40):
        alt = (ref_nt4[c] + 1) % 4
        k = rng.integers(5, 15)
        nt4[c, :k] = alt
        bq[c, :k] = 40
        baq[c, :k] = 50
        mq[c, :k] = 60
        valid[c, :k] = True
    packed = fc.pack_columns_np(nt4, bq, baq, mq, sq, valid)
    out = fc.build_fused_column_call(use_baq=True, device="cpu")(
        torch.from_numpy(packed), torch.from_numpy(ref_nt4.astype(np.int32)),
        torch.from_numpy(bonf))
    cand = out["candidate"].numpy()
    depths = out["depths"].numpy()
    alt_counts = out["alt_counts"].numpy()
    sig = 0.01
    n_sig = 0
    for c in range(B):
        not_n = valid[c] & (nt4[c] != 4)
        keep = not_n & (bq[c] >= 6)
        if not keep.any() or alt_counts[c].max() == 0 or ref_nt4[c] == 4:
            continue
        mq_eff = np.where(mq[c] == 255, -1, mq[c])
        merged = merge_srcq_mapq_baq_and_bq(
            sq[c].astype(np.int64), mq_eff.astype(np.int64),
            baq[c].astype(np.int64), bq[c].astype(np.int64))
        probs = np.sort(merged[keep])
        counts = np.zeros((1, 3), dtype=np.int64)
        counts[0] = alt_counts[c]
        pv = snpcaller_batch(probs[None, :], np.array([int(depths[c])]),
                             counts, np.array([float(bonf[c])]), sig)
        if (pv[0] * bonf[c] < sig).any():
            n_sig += 1
            assert cand[c], f"exactly-significant column {c} screened out"
    assert n_sig > 0
    assert cand.sum() < B


def test_fused_columns_cpu_is_plain_and_not_counted():
    args = _inputs(64, 33, seed=5)
    packed = torch.from_numpy(fc.pack_columns_np(*args[:6]))
    ref4 = torch.from_numpy(args[6].astype(np.int32))
    fc.reset_launch_count()
    got = fc.fused_columns(packed, ref4)
    want = fc.fused_column_torch(packed, ref4)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert fc.launch_count() == 0


def test_fused_step_checks_device(monkeypatch):
    fn = fc.build_fused_column_call(device="cpu")
    with pytest.raises(ValueError):
        fn(torch.zeros(4, 2, dtype=torch.int32, device="meta"),
           torch.zeros(2, dtype=torch.int32), torch.ones(2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        fc.build_fused_column_call()


@pytest.fixture(scope="module")
def fused_shim(tmp_path_factory):
    """fused_call.cuh built by g++ into a ctypes shim
    (lofreq_tpu_torch/testing/cuh_shims.py; -ffp-contract=off, as the
    kernel builds with -fmad=false), reading [D, B] as the kernel does."""
    return cuh_shims.build_fused_shim(
        str(tmp_path_factory.mktemp("fused_shim")))


def _full_conf(conf):
    full = dict(min_bq=6, min_alt_bq=6, use_baq=True, use_mq=True,
                use_sq=False)
    full.update(_kernel_kw(CONFS[conf]))
    return full


def _shim_inputs(B, Dd, conf):
    """test_cuh_body_matches_plain's draw: packed [Dd, B], ref ids with two
    N reference columns."""
    args = _inputs(B, Dd, seed=B, sq=_full_conf(conf)["use_sq"])
    ref4 = args[6].astype(np.int32)
    ref4[:2] = 4   # N reference columns
    return fc.pack_columns_np(*args[:6]), ref4


SEQ_CASES = [(1000, 75, "baq"), (77, 130, "no_baq_sq"), (300, 1, "no_mq")]


@pytest.mark.parametrize("B,Dd,conf", SEQ_CASES)
def test_cuh_body_matches_plain(fused_shim, B, Dd, conf):
    """The kernel's arithmetic, read by read, vs fused_column_torch at
    ragged shapes: counts and depths exact, log tails within 1e-5 absolute
    (expf/logf of libm vs torch)."""
    packed, ref4 = _shim_inputs(B, Dd, conf)
    full = _full_conf(conf)
    tail, depth, acnt, araw = cuh_shims.fused_columns(fused_shim, packed,
                                                      ref4, 0, **full)
    t_p, d_p, a_p, r_p = fc.fused_column_torch(
        torch.from_numpy(packed), torch.from_numpy(ref4), **full)
    np.testing.assert_array_equal(depth, d_p.numpy())
    np.testing.assert_array_equal(acnt, a_p.numpy())
    np.testing.assert_array_equal(araw, r_p.numpy())
    assert np.abs(tail - t_p.numpy()).max() <= 1e-5


# fused_call.cuh as it was when each read decoded its qualities with expf,
# kept frozen in tests/frozen_cuh/, and its g++ shim, read by read: the
# reference the table decode is held to, on whatever libm the host has
FROZEN_CUH = os.path.join(os.path.dirname(__file__), "frozen_cuh")
EXPF_SRC = r'''
#include "fused_call.cuh"
extern "C" void fused_cols(const int32_t *packed_t, const int32_t *ref,
                           float *tail, int32_t *depth, int32_t *acnt,
                           int32_t *araw, long long n, long long d,
                           int min_bq, int min_alt_bq, int use_baq,
                           int use_mq, int use_sq) {
  const LfqFusedConf k = {min_bq, min_alt_bq, use_baq, use_mq, use_sq};
  for (long long i = 0; i < n; ++i)
    lfq_fc_column(packed_t + i, n, d, ref[i], k, tail + i, depth + i,
                  acnt + 4 * i, araw + 4 * i);
}
'''
EXPF_CASES = SEQ_CASES + ["near_floor"]


@pytest.fixture(scope="module")
def expf_shim(tmp_path_factory):
    lib = cuh_shims.build_shim(
        EXPF_SRC, str(tmp_path_factory.mktemp("expf_shim")), "expf_shim",
        include=FROZEN_CUH)
    lib.fused_cols.argtypes = ([ctypes.c_void_p] * 6
                               + [ctypes.c_longlong] * 2
                               + [ctypes.c_int] * 5)
    return lib


def _expf_columns(lib, packed, ref4, min_bq, min_alt_bq, use_baq, use_mq,
                  use_sq):
    Dd, B = packed.shape
    outs = (np.empty(B, np.float32), np.empty(B, np.int32),
            np.empty((B, 4), np.int32), np.empty((B, 4), np.int32))
    lib.fused_cols(packed.ctypes.data, ref4.ctypes.data,
                   *(a.ctypes.data for a in outs), B, Dd, min_bq,
                   min_alt_bq, int(use_baq), int(use_mq), int(use_sq))
    return outs


@pytest.mark.parametrize("case", EXPF_CASES, ids=[str(c) for c in EXPF_CASES])
def test_decode_table_keeps_the_sequential_body(fused_shim, expf_shim, case):
    """The decode table holds the same expf of the same argument, so the
    read-by-read body gives the expf decode's outputs bit for bit."""
    if case == "near_floor":
        packed, ref4 = near_floor_batch()
        full = _full_conf("baq")
    else:
        packed, ref4 = _shim_inputs(*case)
        full = _full_conf(case[2])
    packed = np.ascontiguousarray(packed, np.int32)
    ref4 = np.ascontiguousarray(ref4, np.int32)
    got = cuh_shims.fused_columns(fused_shim, packed, ref4, 0, **full)
    want = _expf_columns(expf_shim, packed, ref4, **full)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("T", (0,) + cuh_shims.SPLITS)
def test_cuh_body_nt4_past_n(fused_shim, T):
    """An nt4 field of 5..7, which the 3-bit field can hold (pack_columns_np
    packs a negative nt4 as 7), is a base of no ACGT id: the body, read by
    read and split, counts it under none, as fused_column_torch does."""
    B, Dd = 512, 75
    args = _inputs(B, Dd, seed=57)
    rng = np.random.default_rng(57)
    args[0] = np.where(rng.random((B, Dd)) < 0.05, -1, args[0])
    packed = fc.pack_columns_np(*args[:6])
    odd = rng.random(packed.shape) < 0.15
    field = rng.integers(5, 8, packed.shape).astype(np.int32) << 28
    packed = np.where(odd, (packed & np.int32(~(7 << 28))) | field,
                      packed).astype(np.int32)
    nt4 = (packed >> 28) & 7
    assert all((nt4 == v).any() for v in (5, 6, 7))
    ref4 = args[6].astype(np.int32)
    got = cuh_shims.fused_columns(fused_shim, packed, ref4, T)
    t_p, *ints = fc.fused_column_torch(torch.from_numpy(packed),
                                       torch.from_numpy(ref4))
    for g, w in zip(got[1:], ints):
        np.testing.assert_array_equal(g, w.numpy())
    above = t_p.numpy() > TAIL_FLOOR
    assert np.abs(got[0] - t_p.numpy())[above].max() <= 1e-5


@pytest.mark.parametrize("conf", list(CONFS) + ["mq_sq"])
def test_decode_tables_follow_the_decode_rules(fused_shim, conf):
    """Each field's table holds exp(q * -ln10/10) of its quality q (to f32
    rounding), 0 for a missing or unused field, and MQ0_ERRPROB for MQ0
    when the MQ is used."""
    use = dict(use_baq=True, use_mq=True, use_sq=False)
    use.update({k: v for k, v in CONFS.get(conf, {}).items() if k in use})
    if conf == "mq_sq":
        use.update(use_sq=True, use_baq=False)
    tabs = cuh_shims.fused_tables(fused_shim, **use)
    arg = np.arange(128, dtype=np.float32) * np.float32(fc.NEG_LN10_10)
    e = np.exp(arg.astype(np.float64))
    assert np.abs(tabs[0] / e - 1).max() <= 2 ** -23   # bq, stored as is
    for row, key in ((1, "use_baq"), (2, "use_mq"), (3, "use_sq")):
        if not use[key]:
            assert not tabs[row].any()
            continue
        assert tabs[row][0] == 0.0   # missing
        want = e[:-1].copy()
        if row == 2:
            want[0] = fc.MQ0_ERRPROB   # stored 1: MQ0
        assert np.abs(tabs[row][1:] / want - 1).max() <= 2 ** -23


SPLIT_DEPTHS = (1, 3, 75, 130, 2016)


@pytest.mark.parametrize("T", cuh_shims.SPLITS)
@pytest.mark.parametrize("Dd", SPLIT_DEPTHS)
def test_split_depth_matches_plain(fused_shim, Dd, T):
    """K2's split body (the depth in T slices, the partials merged in the
    kernel's tree) vs fused_column_torch: counts and depths identical, log
    tails within 1e-5 above the floor; D < T and D not a multiple of T
    leave slices short or empty.  T = 1 is the read-by-read body bit for
    bit."""
    B = 256
    args = _inputs(B, Dd, seed=Dd)
    nt4, bq, valid, ref = args[0], args[1], args[5], args[6]
    nt4[2] = (ref[2] + 1) % 4   # an all-alt column: counts past 255
    bq[2] = 30
    valid[2] = True
    packed = fc.pack_columns_np(*args[:6])
    ref4 = ref.astype(np.int32)
    ref4[:2] = 4
    got = cuh_shims.fused_columns(fused_shim, packed, ref4, T)
    t_p, *ints = fc.fused_column_torch(torch.from_numpy(packed),
                                       torch.from_numpy(ref4))
    for g, w in zip(got[1:], ints):
        np.testing.assert_array_equal(g, w.numpy())
    assert got[2][2].max() == Dd
    above = t_p.numpy() > TAIL_FLOOR
    assert above.sum() >= B // 2
    assert np.abs(got[0] - t_p.numpy())[above].max() <= 1e-5
    if T == 1:
        seq = cuh_shims.fused_columns(fused_shim, packed, ref4, 0)
        assert all(np.array_equal(g, w) for g, w in zip(got, seq))


@pytest.mark.parametrize("T", cuh_shims.SPLITS)
def test_split_depth_near_floor(fused_shim, T):
    """Tails near the floor come from products of small partial cells:
    on near_floor_batch the split body stays within 1e-5 of the plain
    version above -80, and T = 1 is the read-by-read body bit for bit."""
    packed, ref4 = near_floor_batch()
    got = cuh_shims.fused_columns(fused_shim, packed, ref4, T)
    t_p, *ints = fc.fused_column_torch(torch.from_numpy(packed),
                                       torch.from_numpy(ref4))
    for g, w in zip(got[1:], ints):
        np.testing.assert_array_equal(g, w.numpy())
    t_p = t_p.numpy()
    above = t_p > TAIL_FLOOR
    assert ((t_p > TAIL_FLOOR) & (t_p < -60)).sum() >= 40
    assert np.abs(got[0] - t_p)[above].max() <= 1e-5
    if T == 1:
        seq = cuh_shims.fused_columns(fused_shim, packed, ref4, 0)
        assert all(np.array_equal(g, w) for g, w in zip(got, seq))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")


@pytest.mark.gpu
@pytest.mark.parametrize("B,Dd,conf", [(4096, 2016, "baq"),
                                       (1000, 75, "no_baq_sq"),
                                       (1, 1, "no_mq")])
def test_kernel_matches_plain_on_gpu(B, Dd, conf):
    """K2 vs fused_column_torch, both on the card: counts and depths
    exact, log tails within 1e-4 above the floor."""
    _need_card()
    kw = _kernel_kw(CONFS[conf])
    args = _inputs(B, Dd, seed=B, sq=kw.get("use_sq", False))
    packed = torch.from_numpy(fc.pack_columns_np(*args[:6])).cuda()
    ref4 = torch.from_numpy(args[6].astype(np.int32)).cuda()
    before = fc.launch_count()
    got = fc.fused_columns(packed, ref4, **kw)
    torch.cuda.synchronize()
    assert fc.launch_count() == before + 1
    want = fc.fused_column_torch(packed, ref4, **kw)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    t, tw = got[0].cpu().numpy(), want[0].cpu().numpy()
    assert np.isfinite(t).all()
    above = tw > np.log(np.float32(fc.TAIL_FLOOR))
    assert np.abs(t - tw)[above].max(initial=0.0) <= TAIL_TOL


@pytest.mark.gpu
def test_kernel_repeats_bit_for_bit_on_gpu():
    """Two launches on the same inputs agree bit for bit: the partials
    merge in a fixed tree, with no atomics."""
    _need_card()
    packed, ref4 = near_floor_batch(B=4099)
    packed, ref4 = (torch.from_numpy(a).cuda() for a in (packed, ref4))
    a = fc.fused_columns(packed, ref4)
    b = fc.fused_columns(packed, ref4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    t_p = fc.fused_column_torch(packed, ref4)[0]
    above = t_p > TAIL_FLOOR
    assert (a[0] - t_p)[above].abs().max().item() <= TAIL_TOL


@pytest.mark.gpu
def test_kernel_wrapper_rejects_bad_input():
    _need_card()
    packed = torch.zeros((10, 8), dtype=torch.int32, device="cuda")
    ref4 = torch.zeros(8, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):   # int64 stream
        fc.fused_columns(packed.long(), ref4)
    with pytest.raises(ValueError):   # ref on another device
        fc.fused_columns(packed, ref4.cpu())
    with pytest.raises(ValueError):   # non-contiguous stream
        fc.fused_columns(packed.t().contiguous().t(), ref4[:10])
    with pytest.raises(ValueError):   # ref of the wrong length
        fc.fused_columns(packed, ref4[:5])


@pytest.mark.gpu
def test_fused_step_gpu_matches_cpu():
    _need_card()
    nt4, bq, baq, mq, sq, valid, ref_nt4, bonf = _inputs(2048, 300, seed=4)
    packed = fc.pack_columns_np(nt4, bq, baq, mq, sq, valid)
    ins = [torch.from_numpy(a) for a in (packed, ref_nt4.astype(np.int32),
                                         bonf)]
    got = fc.build_fused_column_call()(*(t.cuda() for t in ins))
    want = fc.build_fused_column_call(device="cpu")(*ins)
    for k in EXACT_KEYS:
        assert torch.equal(got[k].cpu(), want[k]), k
    t_g = got["screen_tail"].cpu().numpy()
    t_w = want["screen_tail"].numpy()
    m = (t_g > TAIL_FLOOR) & (t_w > TAIL_FLOOR)
    assert np.abs(t_g - t_w)[m].max(initial=0.0) <= TAIL_TOL
