"""The port's device column step (lofreq_tpu_torch/ops/device_call.py), K1's
f32 entry (ops/cuda_poissbin.py:tail_probs) and the port's entry point
against the JAX reference, on the CPU.

1. build_column_call(device="cpu") vs jax.jit of the reference's
   build_column_call on the same numpy batch, over the configurations the
   step has (BAQ on and off, SQ, joint-quality filters, prefix mode, N and
   deletion rows): integer outputs and alt_nt exact, tails within 1e-4
   where above -80, candidate masks equal except within 1e-4 of the
   threshold.
2. tail_probs and poissbin_tail on the CPU vs pallas_poissbin's
   poissbin_tail_pallas in interpret mode; the .cuh body of the kernel
   entry built with g++ into a ctypes shim vs the plain version.
3. entry(device="cpu") vs __graft_entry__.entry().
The `gpu`-marked cases hold the kernel entry against its plain version on
the card and check the wrapper's input checks.
"""

import ctypes
import subprocess

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from lofreq_tpu.ops.device_call import build_column_call as jax_build
from lofreq_tpu.ops.pallas_poissbin import poissbin_tail_pallas
from lofreq_tpu_torch import _kernel_build
from lofreq_tpu_torch.entry import _example_batch, entry
from lofreq_tpu_torch.ops import cuda_poissbin as cp
from lofreq_tpu_torch.ops.device_call import build_column_call
from lofreq_tpu_torch.ops.screen import MARGIN

TAIL_TOL = 1e-4     # |log tail| abs: f32 pow/exp/log ulps of two libraries
TAIL_FLOOR = -80.0  # below it a tail is lost in f32 underflow either way
INT_KEYS = ("alt_counts", "alt_raw", "alt_nt", "depths", "tested",
            "num_tested")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops; the test workers share the
    host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(B, Dd, seed, n_frac=0.0, sq=False):
    """Seeded column batch (numpy): mostly-ref bases, quals of every kind,
    MQ0 and MQ255 rows, 10% missing BAQ, some invalid rows; n_frac of the
    rows N or deletion markers (nt4 = 4)."""
    rng = np.random.default_rng(seed)
    ref_nt4 = rng.integers(0, 4, B).astype(np.int8)
    ref_nt4[:3] = 4   # N reference columns are never tested
    nt4 = np.where(rng.random((B, Dd)) < 0.97, ref_nt4[:, None],
                   rng.integers(0, 5, (B, Dd))).astype(np.int8)
    nt4[rng.random((B, Dd)) < n_frac] = 4
    bq = rng.integers(2, 41, (B, Dd)).astype(np.int16)
    baq = np.where(rng.random((B, Dd)) < 0.1, -1,
                   rng.integers(20, 60, (B, Dd))).astype(np.int16)
    mq = rng.choice(np.array([0, 20, 60, 255], np.int16), (B, Dd),
                    p=[0.01, 0.04, 0.9, 0.05])
    sqv = (rng.integers(-1, 45, (B, Dd)) if sq
           else np.full((B, Dd), -1)).astype(np.int16)
    valid = rng.random((B, Dd)) < 0.9
    # a few strong variant columns, so some columns are candidates
    for c in rng.integers(3, B, B // 16):
        k = int(rng.integers(2, 20))
        nt4[c, :k] = (ref_nt4[c] + 1) % 4
        bq[c, :k] = 40
        valid[c, :k] = True
    bonf = rng.choice(np.array([1.0, 300.0, 30000.0], np.float32), B)
    return nt4, bq, baq, mq, sqv, valid, ref_nt4, bonf


def _log_thresh(sig, bonf):
    return (np.log(np.float32(sig * MARGIN))
            - np.log(np.maximum(bonf.astype(np.float32), 1.0)))


def assert_step_equal(got, want, sig, bonf):
    """The tolerances of the step: integer outputs exact, tails within
    TAIL_TOL where both are above TAIL_FLOOR, candidate masks equal except
    within TAIL_TOL of the threshold."""
    assert set(got) == set(want)
    for k in want:
        g = got[k].cpu().numpy() if torch.is_tensor(got[k]) else got[k]
        w = np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
    for k in INT_KEYS:
        np.testing.assert_array_equal(got[k].cpu().numpy(),
                                      np.asarray(want[k]), err_msg=k)
    t_g = got["screen_tail"].cpu().numpy()
    t_w = np.asarray(want["screen_tail"])
    both = (t_g > TAIL_FLOOR) & (t_w > TAIL_FLOOR)
    assert np.abs(t_g - t_w)[both].max(initial=0.0) <= TAIL_TOL
    near = np.abs(t_w - _log_thresh(sig, bonf)) <= TAIL_TOL
    diff = got["candidate"].cpu().numpy() != np.asarray(want["candidate"])
    assert not (diff & ~near).any()


# name -> (build_column_call kwargs, batch kwargs)
STEP_CASES = {
    "baq": (dict(use_baq=True), {}),
    "no_baq": (dict(use_baq=False), {}),
    "sq": (dict(use_sq=True), dict(sq=True)),
    "no_mq": (dict(use_mq=False, min_bq=10, min_alt_bq=20), {}),
    "min_jq": (dict(min_jq=13, min_alt_jq=17), {}),
    "prefix_s": (dict(s=24), {}),
    "n_del_rows": (dict(use_baq=True), dict(n_frac=0.3)),
    "sig": (dict(sig=0.05), {}),
}


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_column_call_matches_jax(name):
    kw, bkw = STEP_CASES[name]
    args = _batch(512, 96, seed=len(name), **bkw)
    want = jax.jit(jax_build(**kw))(*args)
    got = build_column_call(device="cpu", **kw)(
        *(torch.from_numpy(a) for a in args))
    sig = kw.get("sig", 0.01)
    assert_step_equal(got, want, sig, args[-1])
    # the batch exercises both verdicts
    cand = got["candidate"].numpy()
    assert 0 < cand.sum() < int(got["num_tested"])


def test_column_call_ragged_depth():
    """A depth that is no multiple of anything, B = 1, and a depth of 1."""
    for B, Dd in ((1, 75), (33, 1), (100, 75)):
        args = _batch(B, Dd, seed=B + Dd)
        want = jax.jit(jax_build(use_baq=True))(*args)
        got = build_column_call(device="cpu")(
            *(torch.from_numpy(a) for a in args))
        assert_step_equal(got, want, 0.01, args[-1])


def test_column_call_cpu_is_plain_and_not_counted():
    cp.reset_launch_count()
    args = _batch(64, 40, seed=2)
    build_column_call(device="cpu")(*(torch.from_numpy(a) for a in args))
    assert cp.launch_count("tail_probs") == 0
    assert cp.launch_count("screen_codes") == 0


def test_column_call_checks_device_and_kmax(monkeypatch):
    with pytest.raises(ValueError):
        build_column_call(kmax=8, device="cpu")
    fn = build_column_call(device="cpu")
    args = [torch.from_numpy(a) for a in _batch(8, 8, seed=1)]
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError):
        fn(*args)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        build_column_call()


def _tail_inputs(seed, B, Dd):
    """Seeded probs [B, D] f32 with pads, valid mask, ks 0..24."""
    rng = np.random.default_rng(seed)
    probs = rng.uniform(1e-4, 5e-2, (B, Dd)).astype(np.float32)
    probs[rng.random((B, Dd)) < 0.05] = 0.0
    valid = rng.random((B, Dd)) < 0.9
    ks = rng.integers(0, 25, B)
    return probs, valid, ks


@pytest.mark.parametrize("B,Dd", [(128, 64), (200, 75), (1, 1)])
def test_poissbin_tail_matches_pallas_interpret(B, Dd):
    """poissbin_tail (through tail_probs, the plain version on the CPU) vs
    the reference's Pallas kernel in interpret mode: the same f32
    recurrence, so 1e-5 relative."""
    probs, valid, ks = _tail_inputs(B + Dd, B, Dd)
    want = poissbin_tail_pallas(probs, valid, ks)
    got = cp.poissbin_tail(torch.from_numpy(probs), torch.from_numpy(valid),
                           torch.from_numpy(ks)).numpy()
    assert got.dtype == np.float32 and got.shape == (B,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_tail_probs_cpu_is_plain_and_not_counted():
    probs, valid, ks = _tail_inputs(4, 32, 20)
    p = torch.from_numpy(np.where(valid, probs, 2.0).astype(np.float32))
    kc = torch.from_numpy(np.clip(ks, 1, cp.KMAX).astype(np.int32))
    cp.reset_launch_count()
    assert torch.equal(cp.tail_probs(p, kc), cp.tail_torch(p, kc))
    assert cp.launch_count("tail_probs") == 0


@pytest.fixture(scope="module")
def tail_shim(tmp_path_factory):
    """The .cuh column body of tail_probs_kernel built by g++ into a ctypes
    shim (-ffp-contract=off, as the kernels build with -fmad=false)."""
    d = tmp_path_factory.mktemp("tail_shim")
    src = d / "shim.cpp"
    src.write_text(
        '#include "poissbin_screen.cuh"\n'
        'extern "C" void tail_cols(const float *probs_t, const int32_t *kc, '
        'float *out, long long n, long long d) {\n'
        '  for (long long i = 0; i < n; ++i)\n'
        '    out[i] = lfq_tail_column(probs_t + i, n, d, kc[i]);\n'
        '}\n')
    so = d / "libshim.so"
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    "-std=c++17", "-I", _kernel_build.CSRC, "-o", str(so),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.tail_cols.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
    return lib


@pytest.mark.parametrize("B,Dd", [(300, 75), (64, 257)])
def test_tail_cuh_body_matches_plain(tail_shim, B, Dd):
    """The kernel's arithmetic (the .cuh, reading [D, B] as the kernel does)
    vs tail_torch on the same probs, pads and out-of-range values included:
    within 1e-5 absolute (logf of libm vs torch)."""
    probs, valid, ks = _tail_inputs(B * Dd, B, Dd)
    probs = np.where(valid, probs, 2.0).astype(np.float32)
    probs[0, :3] = [-0.5, 1.2, 1.5]   # clipped, clipped, kept as 1.0
    kc = np.clip(ks, 1, cp.KMAX).astype(np.int32)
    probs_t = np.ascontiguousarray(probs.T)
    out = np.empty(B, np.float32)
    tail_shim.tail_cols(probs_t.ctypes.data, kc.ctypes.data,
                        out.ctypes.data, B, Dd)
    want = cp.tail_torch(torch.from_numpy(probs),
                         torch.from_numpy(kc)).numpy()
    assert np.abs(out - want).max() <= 1e-5
    assert (want > TAIL_FLOOR).sum() > B // 2


def test_entry_matches_graft_entry():
    """entry(device="cpu") on its example batch vs __graft_entry__.entry()
    through jax.jit: the same draws, the same outputs."""
    fn, args = entry(device="cpu")
    rfn, rargs = graft.entry()
    for a, r in zip(args, rargs):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), r)
    want = jax.jit(rfn)(*rargs)
    assert_step_equal(fn(*args), want, 0.01, rargs[-1])
    assert int(want["num_tested"]) > 0


def test_entry_batch_is_graft_batch():
    for seed in (0, 5):
        for a, r in zip(_example_batch(B=64, D=40, seed=seed),
                        graft._example_batch(B=64, D=40, seed=seed)):
            assert a.dtype == r.dtype and np.array_equal(a, r)


def test_entry_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        entry()


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")


@pytest.mark.gpu
@pytest.mark.parametrize("B,Dd", [(4096, 2016), (1000, 75), (1, 1)])
def test_tail_kernel_matches_plain_on_gpu(B, Dd):
    """K1's f32 entry vs tail_torch, both on the card: log tails within
    1e-4 above the floor."""
    _need_card()
    probs, valid, ks = _tail_inputs(B, B, Dd)
    p = torch.from_numpy(np.where(valid, probs, 2.0).astype(
        np.float32)).cuda()
    kc = torch.from_numpy(np.clip(ks, 1, cp.KMAX).astype(np.int32)).cuda()
    before = cp.launch_count("tail_probs")
    got = cp.tail_probs(p, kc)
    torch.cuda.synchronize()
    assert cp.launch_count("tail_probs") == before + 1
    want = cp.tail_torch(p, kc).cpu().numpy()
    got = got.cpu().numpy()
    assert np.isfinite(got).all()
    above = want > np.log(np.float32(cp.TAIL_FLOOR))
    assert np.abs(got - want)[above].max(initial=0.0) <= TAIL_TOL


@pytest.mark.gpu
def test_tail_kernel_wrapper_rejects_bad_input():
    _need_card()
    p = torch.rand(8, 10, device="cuda")
    kc = torch.ones(8, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):   # f64 probs
        cp.tail_probs(p.double(), kc)
    with pytest.raises(ValueError):   # int64 kc
        cp.tail_probs(p, kc.long())
    with pytest.raises(ValueError):   # kc on another device
        cp.tail_probs(p, kc.cpu())
    with pytest.raises(ValueError):   # no reads
        cp.tail_probs(p[:, :0], kc)


@pytest.mark.gpu
def test_column_call_gpu_matches_cpu():
    """The step on the card (K1) vs the step on the CPU (plain)."""
    _need_card()
    args = _batch(2048, 300, seed=9)
    before = cp.launch_count("tail_probs")
    got = build_column_call()(*(torch.from_numpy(a).cuda() for a in args))
    assert cp.launch_count("tail_probs") == before + 1
    want = build_column_call(device="cpu")(
        *(torch.from_numpy(a) for a in args))
    want = {k: v.numpy() for k, v in want.items()}
    assert_step_equal(got, want, 0.01, args[-1])
