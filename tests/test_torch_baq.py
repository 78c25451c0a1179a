"""The port's device BAQ (lofreq_tpu_torch/ops/baq_torch.py, cuda_baq.py,
device_baq.py and csrc/baq_hmm.cuh) against the reference's.

1. The plain PyTorch HMM against lofreq_tpu.ops.baq_jax._build (XLA on
   the CPU) and against the Pallas kernels K3/K4 in interpret mode.
2. The plain HMM plus extract_baq against the exact C BAQ, and its
   decision margins against the C BAQ's flips.
3. The kernels' per-read body (csrc/baq_hmm.cuh, plain C++ under g++)
   against the plain version, through a ctypes shim that walks the
   kernels' grid, dead reads of the last block included, and the
   generic backward pass against the half-warp body it replaced (a frozen
   copy in tests/frozen_cuh/), bit for bit.
4. The port's runner on the CPU against the reference's runner (JAX on
   the CPU) on lfq_extract_reads output of a simulated BAM.
5. `gpu`-marked: K3/K4 and the runner on the card against the plain
   versions.

Tolerances: q within +-1 everywhere and identical on >= 99.9% of bases,
st identical on >= 99.9%, where the two sides take f32 sums, products and
logs in another order (XLA vs torch, a Toeplitz product vs doubling,
butterfly sums over 16 band lanes vs sums over the window); a phred flips
only where the pre-truncation value sits at an integer boundary.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from lofreq_tpu.io.bam import BamRead
from lofreq_tpu.ops.baq_hmm import realn_batch
from lofreq_tpu.ops.baq_jax import _build as jax_build
from lofreq_tpu.ops.baq_jax import extract_baq
from lofreq_tpu.ops.pallas_baq import baq_pallas
from lofreq_tpu_torch import _kernel_build
from lofreq_tpu_torch.ops import baq_torch, cuda_baq, device_baq
from lofreq_tpu_torch.ops.baq_torch import (_BASECODE, _Q2P, baq_batch,
                                            baq_hmm_torch)
from lofreq_tpu_torch.testing import cuh_shims

SHARE = 0.999


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops; with the test workers sharing
    the host's cores, one intra-op thread per worker avoids oversubscribing
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hmm_inputs(seed, B, L, Lr=128, lref_lo=None):
    """Seeded (refw, query, qualp, l_ref) as test_baq_jax.py:70-77 makes
    them: reads copied from their window at offset 5 with 5% errors."""
    rng = np.random.default_rng(seed)
    refw = rng.integers(0, 4, (B, Lr)).astype(np.int32)
    query = np.array([refw[b, 5:5 + L] for b in range(B)], np.int32)
    err = rng.random((B, L)) < 0.05
    query[err] = rng.integers(0, 4, err.sum())
    qualp = (10 ** (-rng.integers(15, 41, (B, L)) / 10)).astype(np.float32)
    lo = L + 8 if lref_lo is None else lref_lo
    l_ref = rng.integers(lo, Lr, B).astype(np.int32)
    return refw, query, qualp, l_ref


def _plain(refw, query, qualp, l_ref, **kw):
    out = baq_hmm_torch(*(torch.from_numpy(np.ascontiguousarray(a))
                          for a in (refw, query, qualp, l_ref)), **kw)
    return [t.numpy() for t in out]


def _assert_close(q, st, q_ref, st_ref):
    assert q.shape == q_ref.shape and st.shape == st_ref.shape
    assert np.abs(q.astype(np.int64) - q_ref).max() <= 1
    assert (q == q_ref).mean() >= SHARE, (q == q_ref).mean()
    assert (st == st_ref).mean() >= SHARE, (st == st_ref).mean()


# (seed, B, L): test_baq_jax.py's inputs, L = 100 again, and L = 75 (not a
# multiple of 8, so Pallas pads its row chunks)
CASES = [(4, 128, 100), (8, 128, 100), (5, 128, 75)]


@pytest.mark.parametrize("seed,B,L", CASES)
def test_plain_matches_baq_jax(seed, B, L):
    import jax.numpy as jnp

    refw, query, qualp, l_ref = _hmm_inputs(seed, B, L)
    qj, sj, *_ = jax_build(L, 128, 7)(
        jnp.asarray(refw), jnp.asarray(query), jnp.asarray(qualp),
        jnp.asarray(l_ref))
    q, st = _plain(refw, query, qualp, l_ref)
    assert q.dtype == np.int32 and st.dtype == np.int32
    _assert_close(q, st, np.asarray(qj), np.asarray(sj))


@pytest.mark.parametrize("seed,B,L", CASES)
def test_plain_matches_pallas_interpret(seed, B, L):
    refw, query, qualp, l_ref = _hmm_inputs(seed, B, L)
    qp, sp = baq_pallas(refw, query, qualp, l_ref)
    q, st = _plain(refw, query, qualp, l_ref)
    _assert_close(q, st, np.asarray(qp), np.asarray(sp))


def test_plain_margins_match_baq_jax():
    """The margin branch (want_margin) against baq_jax's: margins within
    1e-4 (f32 log and division in another order)."""
    import jax.numpy as jnp

    refw, query, qualp, l_ref = _hmm_inputs(6, 64, 100)
    qj, sj, mqj, msj, _ = jax_build(100, 128, 7, want_margin=True)(
        jnp.asarray(refw), jnp.asarray(query), jnp.asarray(qualp),
        jnp.asarray(l_ref))
    q, st, mq, ms = _plain(refw, query, qualp, l_ref, want_margin=True)
    _assert_close(q, st, np.asarray(qj), np.asarray(sj))
    assert np.abs(mq - np.asarray(mqj)).max() <= 1e-4
    assert np.abs(ms - np.asarray(msj)).max() <= 1e-4


def _sim_reads(seed, B, L, n_err, qlo):
    """B seeded all-match reads of length L on a random genome, as
    test_baq_jax.py builds them, with the exact C BAQ tags attached."""
    rng = np.random.default_rng(seed)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 60 * B + 500)
    ref = genome.tobytes()
    reads = []
    for i in range(B):
        pos = int(rng.integers(10, len(ref) - L - 10))
        r = BamRead()
        r.qname = f"r{i}"
        r.tid = 0
        r.pos = pos
        seq = genome[pos:pos + L].copy()
        for _ in range(int(rng.integers(0, n_err))):
            seq[int(rng.integers(0, L))] = rng.choice(
                np.frombuffer(b"ACGT", np.uint8))
        r.seq = seq.tobytes()
        r.qual = rng.integers(qlo, 41, L).astype(np.uint8)
        r.set_cigar_string(f"{L}M")
        reads.append(r)
    realn_batch(reads, ref, baq=True, ext_baq=True, idaq=False)
    c_bq = np.stack([np.frombuffer(r.get_tag("lb").encode("latin-1"),
                                   np.uint8) for r in reads]).astype(np.int64)
    return ref, reads, c_bq - 33


def test_plain_extract_matches_c():
    """baq_batch (plain on the CPU) + extract_baq vs the exact C BAQ, as
    test_baq_jax.py:test_baq_jax_matches_c holds the JAX path."""
    L, B = 100, 64
    ref, reads, c_bq = _sim_reads(17, B, L, 4, 10)
    infos = [(r.pos, r.seq, r.qual, max(r.pos - 3, 0),
              min(r.pos + L + 3, len(ref))) for r in reads]
    q, st = baq_batch(infos, ref, device="cpu")
    t_bq = np.stack([extract_baq(q[i], st[i], infos[i][0], infos[i][3])
                     for i in range(B)]).astype(np.int64)
    diff = np.abs(c_bq - t_bq)
    assert (diff == 0).mean() > 0.97, (diff == 0).mean()
    assert diff.max() <= 2


def test_plain_flips_only_at_truncation_boundaries():
    """Plain (f32) vs exact C BAQ: every read with a flipped base holds a
    base within 1e-3 of a phred boundary or of a MAP tie, the deviation
    model behind BAQ_SCREEN_DELTA (test_baq_jax.py:87-154)."""
    L, B = 100, 512
    ref, reads, c_bq = _sim_reads(23, B, L, 6, 5)
    refa = np.frombuffer(ref, np.uint8)
    codes = np.empty((B, L), np.int32)
    qualp = np.empty((B, L), np.float32)
    lr = np.empty(B, np.int32)
    d0 = np.empty(B, np.int32)
    refw = np.full((B, 128), 4, np.int32)
    for i, r in enumerate(reads):
        codes[i] = _BASECODE[np.frombuffer(r.seq, np.uint8)]
        qualp[i] = _Q2P[np.asarray(r.qual)]
        b = max(r.pos - 3, 0)
        e = min(r.pos + L + 3, len(ref))
        lr[i] = e - b
        d0[i] = r.pos - b
        refw[i, :e - b] = _BASECODE[refa[b:e]]
    q, st, mq, ms = _plain(refw, codes, qualp, lr, want_margin=True)
    dev_bq = device_baq.extract_baq_torch(
        torch.from_numpy(q), torch.from_numpy(st),
        torch.from_numpy(d0)).numpy()
    flips = dev_bq != c_bq
    assert flips.mean() < 0.01
    near_read = ((mq < 1e-3) | (ms < 1e-3)).any(axis=1)
    assert not np.any(flips.any(axis=1) & ~near_read)


@pytest.mark.parametrize("ext", [True, False])
def test_extract_baq_torch_matches_numpy(ext):
    """The runner's torch extraction vs baq_jax.extract_baq, exactly."""
    rng = np.random.default_rng(2)
    B, L = 40, 50
    q = rng.integers(0, 120, (B, L)).astype(np.int32)
    d0 = rng.integers(0, 4, B).astype(np.int32)
    diag = d0[:, None] + np.arange(L)[None, :]
    st = ((diag + rng.integers(-1, 2, (B, L)) * (rng.random((B, L)) < 0.1))
          << 2) | (rng.random((B, L)) < 0.05)
    st = st.astype(np.int32)
    got = device_baq.extract_baq_torch(
        torch.from_numpy(q), torch.from_numpy(st), torch.from_numpy(d0),
        ext).numpy()
    want = np.stack([extract_baq(q[i], st[i], int(d0[i]), 0, ext=ext)
                     for i in range(B)])
    assert got.dtype == np.uint8
    assert np.array_equal(got, want)


def test_baq_hmm_cpu_is_plain_and_not_counted():
    ins = [torch.from_numpy(a) for a in _hmm_inputs(3, 16, 40, Lr=60)]
    cuda_baq.reset_launch_count()
    q, st = cuda_baq.baq_hmm(*ins)
    qp, sp = baq_hmm_torch(*ins)
    assert torch.equal(q, qp) and torch.equal(st, sp)
    assert cuda_baq.launch_count() == {"baq_fwd": 0, "baq_bwd": 0}


@pytest.fixture(scope="module")
def cuh_shim(tmp_path_factory):
    """csrc/baq_hmm.cuh built by g++ into a ctypes shim
    (lofreq_tpu_torch/testing/cuh_shims.py): K3's grid of 8 reads per
    block, the dead reads of the last block on the last real read's
    inputs, into [n, L, 16] scratch, then K4's one read per thread, both
    on the register band type (-ffp-contract=off, as the kernels build
    with -fmad=false)."""
    return cuh_shims.build_baq_shim(str(tmp_path_factory.mktemp("baq_shim")))


def _shim(lib, refw, query, qualp, l_ref):
    return cuh_shims.baq_grid(lib, refw, query, qualp, l_ref)


# (seed, B ragged against 8 reads per block, L, Lr, smallest l_ref)
SHIM_CASES = [(4, 128, 100, 128, 108), (11, 301, 100, 110, 100),
              (5, 203, 75, 90, 70), (12, 37, 151, 170, 160)]


@pytest.mark.parametrize("seed,B,L,Lr,lref_lo", SHIM_CASES)
def test_cuh_body_matches_plain(cuh_shim, seed, B, L, Lr, lref_lo):
    """The kernels' per-read body vs the plain version: l_ref below the
    window, ragged read counts, L = 75 and a 151 bp read (any L, not a
    fixed 128-lane window)."""
    ins = _hmm_inputs(seed, B, L, Lr=Lr, lref_lo=lref_lo)
    q, st = _shim(cuh_shim, *ins)
    q_p, st_p = _plain(*ins)
    _assert_close(q, st, q_p, st_p)
    # st's k is the 0-based window lane: the MAP state of an unchanged
    # read sits on the diagonal 5 + i (the reads start at lane 5)
    on_diag = (st >> 2) == 5 + np.arange(L)[None, :]
    assert on_diag.mean() > 0.95


@pytest.mark.parametrize("seed,B,L,Lr,lref_lo", SHIM_CASES)
def test_cuh_forward_matches_plain(cuh_shim, seed, B, L, Lr, lref_lo):
    """K3's per-read body alone vs the plain forward pass in K3's band
    layout (forward_band_torch): scaled rows within 1e-6 absolute (they
    lie in [0, 1]) and row scales within 1e-5 relative, f32 sums and the
    D chain taken in another order; lane 15 is never written non-zero."""
    refw, query, qualp, l_ref = (
        np.ascontiguousarray(a) for a in _hmm_inputs(seed, B, L, Lr=Lr,
                                                     lref_lo=lref_lo))
    refw, query = refw.astype(np.uint8), query.astype(np.uint8)
    fm = np.full((B, L, 16), np.nan, np.float32)
    fi = np.full((B, L, 16), np.nan, np.float32)
    fs = np.full((B, L), np.nan, np.float32)
    cuh_shim.baq_fwd_rows(refw.ctypes.data, query.ctypes.data,
                          qualp.ctypes.data, l_ref.ctypes.data, B, L, Lr,
                          fm.ctypes.data, fi.ctypes.data, fs.ctypes.data)
    pm, pi, ps = (t.numpy() for t in cuda_baq.baq_forward(
        *(torch.from_numpy(a) for a in (refw, query, qualp, l_ref))))
    assert pm.shape == (B, L, 16) and ps.shape == (B, L)
    assert np.abs(fm - pm).max() <= 1e-6
    assert np.abs(fi - pi).max() <= 1e-6
    assert np.abs(fs / ps - 1).max() <= 1e-5
    assert not fm[:, :, 15].any() and not pm[:, :, 15].any()


def _degenerate_inputs():
    """Windows shorter than the read (empty bands, all-zero rows), N codes
    in read and window."""
    rng = np.random.default_rng(9)
    B, L, Lr = 64, 30, 40
    refw = rng.integers(0, 5, (B, Lr)).astype(np.uint8)
    refw[:4] = 4
    query = rng.integers(0, 5, (B, L)).astype(np.uint8)
    qualp = (10 ** (-rng.integers(2, 41, (B, L)) / 10)).astype(np.float32)
    l_ref = rng.integers(1, Lr + 1, B).astype(np.int32)
    return refw, query, qualp, l_ref


def test_cuh_body_degenerate_rows(cuh_shim):
    """Windows shorter than the read (empty bands, all-zero rows, whose
    MAP is window lane 0), N codes in read and window: exact agreement."""
    refw, query, qualp, l_ref = _degenerate_inputs()
    L = query.shape[1]
    q, st = _shim(cuh_shim, refw, query, qualp, l_ref)
    q_p, st_p = _plain(refw, query, qualp, l_ref)
    assert np.array_equal(q, q_p) and np.array_equal(st, st_p)
    assert (l_ref < L - 7).any() and (st_p[l_ref < L - 7, -1] == 0).all()


# baq_hmm.cuh as it was when K4 ran one half-warp per read, kept frozen in
# tests/frozen_cuh/, and its g++ shim walking the same grid as BAQ_SRC:
# the reference the generic backward pass is held to, on whatever libm
# the host has (both shims call the same expf and logf)
FROZEN_CUH = os.path.join(os.path.dirname(__file__), "frozen_cuh")
HALF_WARP_SRC = r'''
#include <vector>
#include "baq_hmm.cuh"
extern "C" void baq_grid(const uint8_t *refw, const uint8_t *query,
                         const float *qualp, const int32_t *l_ref,
                         long long n, int L, int Lr, int32_t *q,
                         int32_t *st) {
  const LfqBaqConsts c = lfq_baq_consts(L);
  const long long n_pad = (n + 7) / 8 * 8;
  std::vector<float> fm(n_pad * L * 16), fi(n_pad * L * 16), fs(n_pad * L);
  for (int pass = 0; pass < 2; ++pass)
    for (long long r = 0; r < n_pad; ++r) {
      const bool live = r < n;
      const long long b = live ? r : n - 1;
      const long long rows = b * L;
      if (pass == 0)
        lfq_baq_forward(refw + b * Lr, Lr, l_ref[b], query + rows,
            qualp + rows, L, c, &fm[rows * 16], &fi[rows * 16], &fs[rows],
            live);
      else
        lfq_baq_backward(refw + b * Lr, Lr, l_ref[b], query + rows,
            qualp + rows, L, c, &fm[rows * 16], &fi[rows * 16], &fs[rows],
            q + rows, st + rows, live);
    }
}
'''


@pytest.fixture(scope="module")
def half_warp_shim(tmp_path_factory):
    lib = cuh_shims.build_shim(
        HALF_WARP_SRC, str(tmp_path_factory.mktemp("half_warp_shim")),
        "half_warp_shim", include=FROZEN_CUH)
    lib.baq_grid.argtypes = ([ctypes.c_void_p] * 4
                             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                             + [ctypes.c_void_p] * 2)
    return lib


HALF_WARP_CASES = SHIM_CASES + ["degenerate"]


@pytest.mark.parametrize("case", HALF_WARP_CASES,
                         ids=[str(c) for c in HALF_WARP_CASES])
def test_generic_backward_equals_half_warp_body(cuh_shim, half_warp_shim,
                                                case):
    """The backward pass written once for both band types, on the register
    type K4 runs, gives the q and st of the half-warp body's g++ form bit
    for bit, on SHIM_CASES and on the degenerate rows: the order of every
    multiply and add is kept."""
    if case == "degenerate":
        ins = _degenerate_inputs()
    else:
        seed, B, L, Lr, lref_lo = case
        ins = _hmm_inputs(seed, B, L, Lr=Lr, lref_lo=lref_lo)
    q, st = _shim(cuh_shim, *ins)
    q0, st0 = _shim(half_warp_shim, *ins)
    np.testing.assert_array_equal(q, q0)
    np.testing.assert_array_equal(st, st0)


def _extract(bam, fa_len, region_len):
    """lfq_extract_reads of the port's native library over one region of
    a simulated BAM: the eligible reads' (codes, quals, pos, xb, xe), as
    the port's native_ingest hands them to the runner."""
    from lofreq_tpu_torch.io.bam import BamReader
    from lofreq_tpu_torch.pileup.engine import PileupConf
    from lofreq_tpu_torch.pileup.native_ingest import (
        _conf_struct, get_lib, raw_records_for_region)

    rdr = BamReader(bam)
    raw = raw_records_for_region(rdr, 0, 0, region_len)
    cs = _conf_struct(PileupConf(), 0, 0, region_len)
    lib = get_lib()
    buf = np.frombuffer(raw, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    bufp = buf.ctypes.data_as(u8p)
    counts = np.zeros(5, dtype=np.int64)
    lib.lfq_ingest_count(bufp, ctypes.c_int64(len(raw)), ctypes.byref(cs),
                         counts.ctypes.data_as(i64p))
    n = int(counts[0])
    L = lib.lfq_mode_read_len(bufp, ctypes.c_int64(len(raw)),
                              ctypes.byref(cs))
    elig = np.zeros(n, np.uint8)
    pos, xb, xe = (np.empty(n, np.int64) for _ in range(3))
    lq = np.empty(n, np.int32)
    codes = np.empty((n, L), np.uint8)
    quals = np.empty((n, L), np.uint8)
    lib.lfq_extract_reads.restype = ctypes.c_int64
    k = lib.lfq_extract_reads(
        bufp, ctypes.c_int64(len(raw)), ctypes.byref(cs),
        ctypes.c_int64(fa_len), ctypes.c_int32(L), elig.ctypes.data_as(u8p),
        pos.ctypes.data_as(i64p),
        lq.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        codes.ctypes.data_as(u8p), quals.ctypes.data_as(u8p),
        xb.ctypes.data_as(i64p), xe.ctypes.data_as(i64p))
    assert k == n
    idx = np.nonzero(elig)[0]
    return codes[idx], quals[idx], pos[idx], xb[idx], xe[idx]


@pytest.fixture(scope="module")
def sim_bam(tmp_path_factory):
    """A simulated 15 kb BAM at 30x with insertion reads (ineligible) and
    its reference."""
    from simulate import simulate

    from lofreq_tpu.io.fasta import Fasta

    d = tmp_path_factory.mktemp("baq_runner")
    art = simulate(str(d), genome_len=15000, depth=30, seed=13,
                   indels=((0.5, 1, 3, "ins"),))
    return art["bam"], Fasta(art["fa"]).fetch(art["chrom"])


@pytest.fixture(scope="module")
def extracted(sim_bam):
    bam, ref = sim_bam
    return ref, _extract(bam, len(ref), 15000)


@pytest.mark.parametrize("ext", [True, False])
def test_runner_cpu_matches_reference_runner(extracted, ext):
    """The port's runner (plain HMM on the CPU) vs the reference's runner
    (baq_jax on JAX's CPU backend) on the same extracted reads: the final
    u8 BAQ within +-1 on >= 99.9% of bases.  Under 5000 reads, so the
    reference runner does not rate itself."""
    from lofreq_tpu.ops.device_baq import DeviceBaqRunner as RefRunner

    ref, (codes, quals, pos, xb, xe) = extracted
    assert 1000 < len(codes) < 5000
    before = dict(device_baq.RUN_STATS)
    got = device_baq.DeviceBaqRunner(ext_baq=ext, device="cpu").run(
        ref, codes, quals, pos, xb, xe)
    want = RefRunner(ext_baq=ext).run(ref, codes, quals, pos, xb, xe)
    assert want is not None
    assert got.dtype == np.uint8 and got.shape == codes.shape
    diff = np.abs(got.astype(np.int64) - want)
    assert (diff <= 1).mean() >= SHARE, (diff <= 1).mean()
    assert (diff == 0).mean() >= 0.99
    assert got.max() <= 93
    assert device_baq.RUN_STATS["reads"] - before["reads"] == len(codes)
    assert device_baq.RUN_STATS["batches"] - before["batches"] == -(
        -len(codes) // device_baq.TILE_B_CPU)


def test_runner_defaults_to_the_card(extracted, monkeypatch):
    """DeviceBaqRunner() names the card: on a host without one it raises,
    naming --device cpu, instead of running on the CPU; asked for the CPU
    it gives the reference runner's BAQ (the case above, ext_baq on)."""
    from lofreq_tpu.ops.device_baq import DeviceBaqRunner as RefRunner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        device_baq.DeviceBaqRunner()
    ref, (codes, quals, pos, xb, xe) = extracted
    got = device_baq.DeviceBaqRunner(device="cpu").run(ref, codes, quals,
                                                        pos, xb, xe)
    want = RefRunner().run(ref, codes, quals, pos, xb, xe)
    diff = np.abs(got.astype(np.int64) - want)
    assert (diff <= 1).mean() >= SHARE and (diff == 0).mean() >= 0.99


def test_count_extracted_reads(sim_bam):
    """The extraction counter sees every eligible read that the port's
    lfq_extract_reads flags, and leaves the library as it found it."""
    from lofreq_tpu_torch._native_build import get_native_lib

    bam, ref = sim_bam
    orig = get_native_lib().lfq_extract_reads
    with device_baq.count_extracted_reads() as counted:
        codes = _extract(bam, len(ref), 15000)[0]
    assert counted == {"eligible": len(codes), "windows": 1}
    assert len(codes) > 1000
    assert get_native_lib().lfq_extract_reads is orig


def test_get_runner_caches_per_device_and_ext():
    a = device_baq.get_runner(ext_baq=True, device="cpu")
    assert device_baq.get_runner(ext_baq=True, device="cpu") is a
    b = device_baq.get_runner(ext_baq=False, device="cpu")
    assert b is not a and not b.ext_baq
    assert a.tile == device_baq.TILE_B_CPU


def test_baq_sources_are_built():
    assert "baq_hmm.cu" in _kernel_build.SRCS
    assert "baq_hmm.cuh" in _kernel_build.DEPS
    assert "-fmad=false" in _kernel_build.NVCC_FLAGS


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")


@pytest.mark.gpu
@pytest.mark.parametrize("seed,B,L,Lr", [(3, 4096, 100, 128),
                                         (4, 1000, 75, 90),
                                         (5, 1, 151, 170)])
def test_kernels_match_plain_on_gpu(seed, B, L, Lr):
    """K3/K4 vs the plain version, both on the card."""
    _need_card()
    refw, query, qualp, l_ref = _hmm_inputs(seed, B, L, Lr=Lr,
                                            lref_lo=L + 4)
    ins = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (
        refw.astype(np.uint8), query.astype(np.uint8), qualp, l_ref)]
    before = cuda_baq.launch_count()
    q, st = cuda_baq.baq_hmm(*ins)
    torch.cuda.synchronize()
    after = cuda_baq.launch_count()
    assert after["baq_fwd"] == before["baq_fwd"] + 1
    assert after["baq_bwd"] == before["baq_bwd"] + 1
    q_p, st_p = baq_hmm_torch(*ins)
    _assert_close(q.cpu().numpy(), st.cpu().numpy(), q_p.cpu().numpy(),
                  st_p.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("seed,B,L,Lr", [(3, 4096, 100, 106),
                                         (4, 1000, 75, 81)])
def test_forward_kernel_matches_plain_on_gpu(seed, B, L, Lr):
    """K3 alone vs the plain forward pass in its band layout, both on the
    card: rows within 1e-5 absolute, scales within 1e-5 relative."""
    _need_card()
    refw, query, qualp, l_ref = _hmm_inputs(seed, B, L, Lr=Lr,
                                            lref_lo=L + 4)
    ins = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (
        refw.astype(np.uint8), query.astype(np.uint8), qualp, l_ref)]
    before = cuda_baq.launch_count()
    fm, fi, fs = cuda_baq.baq_forward(*ins)
    torch.cuda.synchronize()
    after = cuda_baq.launch_count()
    assert after["baq_fwd"] == before["baq_fwd"] + 1
    assert after["baq_bwd"] == before["baq_bwd"]
    pm, pi, ps = baq_torch.forward_band_torch(*ins)
    assert (fm - pm).abs().max().item() <= 1e-5
    assert (fi - pi).abs().max().item() <= 1e-5
    assert (fs / ps - 1).abs().max().item() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("seed,B,L,Lr", [(3, 4096, 100, 106),
                                         (4, 1000, 75, 81),
                                         (5, 33, 151, 170)])
def test_kernels_match_host_body_on_gpu(cuh_shim, seed, B, L, Lr):
    """K3 + K4 on the card against the headers' g++ form, bit for bit: K4
    runs the same generic backward pass on the same register band type,
    and K3's half-warp rows equal the g++ form's."""
    _need_card()
    refw, query, qualp, l_ref = _hmm_inputs(seed, B, L, Lr=Lr,
                                            lref_lo=L + 4)
    ins = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (
        refw.astype(np.uint8), query.astype(np.uint8), qualp, l_ref)]
    q, st = cuda_baq.baq_hmm(*ins)
    q_h, st_h = _shim(cuh_shim, refw, query, qualp, l_ref)
    assert np.array_equal(q.cpu().numpy(), q_h)
    assert np.array_equal(st.cpu().numpy(), st_h)


@pytest.mark.gpu
def test_kernel_wrapper_rejects_bad_input():
    _need_card()
    refw, query, qualp, l_ref = (
        torch.from_numpy(np.ascontiguousarray(a)).cuda()
        for a in _hmm_inputs(1, 8, 20, Lr=40))
    with pytest.raises(ValueError):   # int32 codes
        cuda_baq.baq_hmm(refw, query.to(torch.uint8), qualp, l_ref)
    with pytest.raises(ValueError):   # l_ref on another device
        cuda_baq.baq_hmm(refw.to(torch.uint8), query.to(torch.uint8), qualp,
                         l_ref.cpu())
    with pytest.raises(ValueError):   # non-contiguous query
        cuda_baq.baq_hmm(refw.to(torch.uint8),
                         query.to(torch.uint8).t().contiguous().t(), qualp,
                         l_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("ext", [True, False])
def test_runner_gpu_matches_cpu(extracted, ext):
    """The runner on the card (K3/K4) vs the runner on the CPU (plain)."""
    _need_card()
    ref, (codes, quals, pos, xb, xe) = extracted
    before = cuda_baq.launch_count()["baq_fwd"]
    got = device_baq.DeviceBaqRunner(ext_baq=ext, device="cuda").run(
        ref, codes, quals, pos, xb, xe)
    assert cuda_baq.launch_count()["baq_fwd"] > before
    want = device_baq.DeviceBaqRunner(ext_baq=ext, device="cpu").run(
        ref, codes, quals, pos, xb, xe)
    diff = np.abs(got.astype(np.int64) - want)
    assert (diff <= 1).mean() >= SHARE and (diff == 0).mean() >= 0.99


def test_module_names():
    """The plain module keeps its own copies of the reference's HMM
    parameters and of its base and q2p tables, equal to them."""
    from lofreq_tpu.ops import baq_jax

    for name in ("PAR_D", "PAR_E", "EI", "EM"):
        assert getattr(baq_torch, name) == getattr(baq_jax, name)
    for name in ("_BASECODE", "_Q2P"):
        a, b = getattr(baq_torch, name), getattr(baq_jax, name)
        assert a is not b and a.dtype == b.dtype and np.array_equal(a, b)
