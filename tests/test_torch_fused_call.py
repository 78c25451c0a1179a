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
   fused_column_torch, at ragged shapes.
The `gpu`-marked cases hold K2 against its plain version on the card and
check the wrapper's input checks.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from lofreq_tpu.ops import pallas_fused_call as ref_fc
from lofreq_tpu_torch import _kernel_build
from lofreq_tpu_torch.core.poissbin import snpcaller_batch
from lofreq_tpu_torch.core.quals import merge_srcq_mapq_baq_and_bq
from lofreq_tpu_torch.ops import fused_call as fc
from lofreq_tpu_torch.ops.device_call import build_column_call
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
    """fused_call.cuh built by g++ into a ctypes shim (-ffp-contract=off,
    as the kernel builds with -fmad=false), reading [D, B] as the kernel
    does."""
    d = tmp_path_factory.mktemp("fused_shim")
    src = d / "shim.cpp"
    src.write_text(
        '#include "fused_call.cuh"\n'
        'extern "C" void fused_cols(const int32_t *packed_t, const int32_t '
        '*ref, float *tail, int32_t *depth, int32_t *acnt, int32_t *araw, '
        'long long n, long long d, int min_bq, int min_alt_bq, int use_baq, '
        'int use_mq, int use_sq) {\n'
        '  const LfqFusedConf k = {min_bq, min_alt_bq, use_baq, use_mq, '
        'use_sq};\n'
        '  for (long long i = 0; i < n; ++i)\n'
        '    lfq_fc_column(packed_t + i, n, d, ref[i], k, tail + i, '
        'depth + i, acnt + 4 * i, araw + 4 * i);\n'
        '}\n')
    so = d / "libshim.so"
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    "-std=c++17", "-I", _kernel_build.CSRC, "-o", str(so),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.fused_cols.argtypes = ([ctypes.c_void_p] * 6
                               + [ctypes.c_longlong] * 2
                               + [ctypes.c_int] * 5)
    return lib


@pytest.mark.parametrize("B,Dd,conf", [(1000, 75, "baq"),
                                       (77, 130, "no_baq_sq"),
                                       (300, 1, "no_mq")])
def test_cuh_body_matches_plain(fused_shim, B, Dd, conf):
    """The kernel's arithmetic vs fused_column_torch at ragged shapes:
    counts and depths exact, log tails within 1e-5 absolute (expf/logf of
    libm vs torch)."""
    kw = _kernel_kw(CONFS[conf])
    args = _inputs(B, Dd, seed=B, sq=kw.get("use_sq", False))
    packed = fc.pack_columns_np(*args[:6])
    ref4 = args[6].astype(np.int32)
    ref4[:2] = 4   # N reference columns
    tail = np.empty(B, np.float32)
    depth = np.empty(B, np.int32)
    acnt = np.empty((B, 4), np.int32)
    araw = np.empty((B, 4), np.int32)
    full = dict(min_bq=6, min_alt_bq=6, use_baq=True, use_mq=True,
                use_sq=False)
    full.update(kw)
    fused_shim.fused_cols(
        packed.ctypes.data, ref4.ctypes.data, tail.ctypes.data,
        depth.ctypes.data, acnt.ctypes.data, araw.ctypes.data, B, Dd,
        full["min_bq"], full["min_alt_bq"], int(full["use_baq"]),
        int(full["use_mq"]), int(full["use_sq"]))
    t_p, d_p, a_p, r_p = fc.fused_column_torch(
        torch.from_numpy(packed), torch.from_numpy(ref4), **full)
    np.testing.assert_array_equal(depth, d_p.numpy())
    np.testing.assert_array_equal(acnt, a_p.numpy())
    np.testing.assert_array_equal(araw, r_p.numpy())
    assert np.abs(tail - t_p.numpy()).max() <= 1e-5


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
