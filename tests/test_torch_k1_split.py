"""K1's Hopper design (csrc/poissbin_screen.cuh, csrc/poissbin_screen.cu)
on the CPU, and its two kernels on the card.

On the CPU the header's bodies are built by g++ into ctypes shims
(lofreq_tpu_torch/testing/cuh_shims.py) and held
1. to a frozen copy of the header as it was when screen_codes_kernel ran
   one thread per column (tests/frozen_cuh/poissbin_screen.cuh, never
   edited): the split column at T = 1 and the f32 column lfq_tail_column,
   array for array, on the host's own libm;
2. to the plain version screen_codes_torch at T = 2, 4 and 8 (the merge
   reorders rounding): log tails within 1e-5, masks equal except within
   1e-5 of the threshold, over S = 16, 48, 128, on random rows, rows with
   ks > KMAX, all-pad rows and rows whose tails sit near the 1e-37 floor;
3. the decode table to lfq_decode for all 256 codes.
The `gpu`-marked cases hold the kernels to those g++ forms on the card:
tail_probs on the column step's [B, D] layout, on a row-sliced view and
on a transposed view (the one layout it copies), within 2 f32 ulps of
lfq_tail_column; screen_codes within 1e-5 of the split form at T = 8,
two launches identical bit for bit.
"""

import ctypes
import math
import os

import numpy as np
import pytest
import torch

from chip_smoke import TAIL_ULPS, ulps
from lofreq_tpu_torch.ops import cuda_poissbin as cp
from lofreq_tpu_torch.testing import cuh_shims

SPLIT_TOL = 1e-5     # |log tail| of a split column vs the plain version
WIDTHS = (16, 48, 128)
KINDS = ("random", "ks_over_kmax", "all_pad", "near_floor")
LOG_FLOOR = float(np.log(np.float32(cp.TAIL_FLOOR)))

# poissbin_screen.cuh as it was before the split, kept frozen in
# tests/frozen_cuh/, and its g++ shim with cuh_shims.SCREEN_SRC's entries
# (screen_cols runs the serial column whatever T)
FROZEN_CUH = os.path.join(os.path.dirname(__file__), "frozen_cuh")
FROZEN_SRC = r'''
#include "poissbin_screen.cuh"
extern "C" void screen_cols(const uint8_t *codes, const int32_t *ks,
                            const float *lt, float *tail, uint8_t *mask,
                            long long n, int s, int T) {
  (void)T;
  for (long long i = 0; i < n; ++i)
    mask[i] = lfq_screen_column(codes + i * s, s, ks[i], lt[i], tail + i);
}
extern "C" void tail_cols(const float *probs, long long ld,
                          const int32_t *kc, float *tail, long long n,
                          long long d) {
  for (long long i = 0; i < n; ++i)
    tail[i] = lfq_tail_column(probs + i * ld, 1, d, kc[i]);
}
extern "C" void decode_direct(float *out) {
  for (unsigned c = 0; c < 256; ++c) out[c] = lfq_decode(c);
}
'''


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    return cuh_shims.build_screen_shim(str(tmp_path_factory.mktemp("k1")))


@pytest.fixture(scope="module")
def frozen(tmp_path_factory):
    lib = cuh_shims.build_shim(
        FROZEN_SRC, str(tmp_path_factory.mktemp("k1_frozen")), "k1_frozen",
        include=FROZEN_CUH)
    lib.screen_cols.argtypes = ([ctypes.c_void_p] * 5
                                + [ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_int])
    lib.tail_cols.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                              + [ctypes.c_void_p] * 2
                              + [ctypes.c_longlong] * 2)
    lib.decode_direct.argtypes = [ctypes.c_void_p]
    return lib


def screen_rows(kind: str, S: int, B: int = 384, seed: int = 0):
    """Seeded (codes [B, S] u8, ks [B] i32, log_thresh [B] f32) of one kind:
    random codes 16..159 with 30% pad; the same with every ks above KMAX;
    three rows in four of pad codes only (the identity: a tail of 0, the
    floor); and rows at one code level per row, ks 16, whose tails
    P(X >= 16) sit around e^-85, the 1e-37 floor."""
    rng = np.random.default_rng(seed + 1000 * S + 97 * KINDS.index(kind))
    codes = rng.integers(16, 160, (B, S)).astype(np.uint8)
    codes[rng.random((B, S)) < 0.3] = cp.CODE_PAD
    ks = rng.integers(1, 25, B).astype(np.int32)
    lt = rng.uniform(-40.0, -1.0, B).astype(np.float32)
    if kind == "ks_over_kmax":
        ks = rng.integers(cp.KMAX + 1, 40, B).astype(np.int32)
    elif kind == "all_pad":
        codes[:] = cp.CODE_PAD
        codes[: B // 4] = rng.integers(16, 160, (B // 4, S))
    elif kind == "near_floor":
        # log P(X >= 16) ~ log C(S, 16) + 16 log p at p = 2^(-code/8)
        log_p = (-85.0 - math.lgamma(S + 1) + math.lgamma(17)
                 + math.lgamma(S - 15)) / 16
        level = -8.0 * log_p / math.log(2.0)
        rows = np.rint(level + rng.uniform(-6.0, 6.0, (B, 1))
                       + rng.integers(-3, 4, (B, S)))
        codes = np.clip(rows, 0, 254).astype(np.uint8)
        ks = np.full(B, cp.KMAX, np.int32)
        lt = rng.uniform(-90.0, -80.0, B).astype(np.float32)
    return codes, ks, lt


CASES = [(k, s) for k in KINDS for s in WIDTHS]
IDS = [f"{k}-S{s}" for k, s in CASES]


@pytest.mark.parametrize("kind,S", CASES, ids=IDS)
def test_split_t1_is_the_frozen_serial_column(shim, frozen, kind, S):
    """T = 1 is one slice stepped from the identity through the decode
    table: the serial column of the frozen header, bit for bit."""
    codes, ks, lt = screen_rows(kind, S)
    tail, mask = cuh_shims.screen_columns(shim, codes, ks, lt, 1)
    want, want_mask = cuh_shims.screen_columns(frozen, codes, ks, lt, 0)
    np.testing.assert_array_equal(tail, want)
    np.testing.assert_array_equal(mask, want_mask)
    # the current serial column is the frozen one too
    serial, _ = cuh_shims.screen_columns(shim, codes, ks, lt, 0)
    np.testing.assert_array_equal(serial, want)


@pytest.mark.parametrize("T", (2, 4, 8))
@pytest.mark.parametrize("kind,S", CASES, ids=IDS)
def test_split_matches_plain(shim, kind, S, T):
    """The split column, merged in the kernel's tree, against
    screen_codes_torch: log tails within 1e-5 (the merge reorders
    rounding; libm's exp2f and logf against torch's add ulps), masks equal
    except within 1e-5 of the threshold."""
    codes, ks, lt = screen_rows(kind, S)
    tail, mask = cuh_shims.screen_columns(shim, codes, ks, lt, T)
    tail_p, mask_p = cp.screen_codes_torch(
        *(torch.from_numpy(a) for a in (codes, ks, lt)))
    tail_p, mask_p = tail_p.numpy(), mask_p.numpy()
    assert np.isfinite(tail).all()
    assert np.abs(tail - tail_p).max() <= SPLIT_TOL
    near = np.abs(tail_p - lt) <= SPLIT_TOL
    assert ((mask == mask_p) | near).all()
    if kind == "ks_over_kmax":
        assert mask.all()
    if kind == "all_pad":
        # a pad row is the identity: P(X >= kc) = 0, the floor
        pad = (codes == cp.CODE_PAD).all(axis=1)
        assert pad.sum() >= len(pad) // 2 and (tail[pad] == LOG_FLOOR).all()
    if kind == "near_floor":
        # the rows reach the floor from both sides
        assert ((tail_p > LOG_FLOOR) & (tail_p < LOG_FLOOR + 5)).sum() > 20
        assert (tail_p == LOG_FLOOR).sum() > 20


@pytest.mark.parametrize("kind,S", [("random", 48), ("random", 128),
                                    ("near_floor", 128)])
def test_split_is_deterministic_and_differs_only_by_rounding(shim, kind, S):
    """The merge tree is fixed: a second run gives the same bits; T = 8 and
    T = 1 differ by rounding only (within 1e-5); where the first slice
    holds the whole row (S <= 128 / T) the merges with the identity are
    exact."""
    codes, ks, lt = screen_rows(kind, S)
    a, _ = cuh_shims.screen_columns(shim, codes, ks, lt, 8)
    b, _ = cuh_shims.screen_columns(shim, codes, ks, lt, 8)
    np.testing.assert_array_equal(a, b)
    serial, _ = cuh_shims.screen_columns(shim, codes, ks, lt, 1)
    assert np.abs(a - serial).max() <= SPLIT_TOL
    # the largest T whose first slice holds the whole row
    T = max(t for t in cuh_shims.SCREEN_SPLITS if 128 // t >= S)
    one, _ = cuh_shims.screen_columns(shim, codes, ks, lt, T)
    np.testing.assert_array_equal(one, serial)


def test_decode_table_is_lfq_decode(shim, frozen):
    """The table screen_codes_kernel fills holds lfq_decode of every code
    (the frozen header's direct decode), 255 -> 0, bit for bit."""
    table = cuh_shims.decode_table(shim)
    direct = np.empty(256, np.float32)
    frozen.decode_direct(direct.ctypes.data)
    np.testing.assert_array_equal(table.view(np.int32),
                                  direct.view(np.int32))
    assert table[cp.CODE_PAD] == 0.0
    want = np.exp2(-np.arange(255) / 8.0)
    assert np.abs(table[:255] / want - 1).max() <= 2 * 2.0 ** -23


def _probs(B, D, seed):
    """Seeded probs [B, D] f32 with pads (> 1.5), values outside [0, 1]
    for the clip, and zeros; kc [B] i32 in [1, KMAX]."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.0, 0.08, (B, D)).astype(np.float32)
    u = rng.random((B, D))
    p[u < 0.1] = 2.0
    p[(u >= 0.1) & (u < 0.12)] = -0.25
    p[(u >= 0.12) & (u < 0.13)] = 1.25
    p[(u >= 0.13) & (u < 0.16)] = 0.0
    kc = rng.integers(1, cp.KMAX + 1, B).astype(np.int32)
    return p, kc


@pytest.mark.parametrize("B,D,pad", [(1, 1, 0), (100, 75, 0), (64, 2016, 0),
                                     (300, 33, 5), (129, 64, 3)])
def test_tail_column_is_the_frozen_one(shim, frozen, B, D, pad):
    """lfq_tail_column, the form tail_probs_kernel runs, is unchanged: the
    same tails as the frozen header's, on rows `pad` floats apart beyond
    D (a row-sliced layout) too."""
    p, kc = _probs(B, D + pad, seed=B + D)
    view = p[:, :D]
    got = cuh_shims.tail_columns(shim, view, kc)
    want = np.empty(B, np.float32)
    frozen.tail_cols(p.ctypes.data, D + pad, kc.ctypes.data,
                     want.ctypes.data, B, D)
    np.testing.assert_array_equal(got, want)
    plain = cp.tail_torch(torch.from_numpy(np.ascontiguousarray(view)),
                          torch.from_numpy(kc)).numpy()
    assert np.abs(got - plain).max() <= 1e-5


@pytest.mark.parametrize("shape", [(4, 7), (1, 7), (7, 1)])
def test_row_stride_takes_the_step_layout(shape):
    """tail_probs' layout rule: a contiguous [B, D] and row-sliced views go
    in as they are; a transposed view of a [D, B] tensor is copied unless
    a dimension has size 1."""
    B, D = shape
    x = torch.zeros(B, D + 3)
    assert cp.row_stride(x[:, :D].contiguous()) == D
    assert cp.row_stride(x[:, 1:1 + D]) == (D + 3 if B > 1 else D)
    t = torch.zeros(D, B).t()
    assert (cp.row_stride(t) is None) == (B > 1 and D > 1)
    expanded = torch.zeros(1, D).expand(B, D)   # row stride 0
    assert (cp.row_stride(expanded) is None) == (B > 1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["contiguous", "row_sliced", "t_view"])
@pytest.mark.parametrize("D", [1, 75, 2016])
@pytest.mark.parametrize("B", [1, 1000, 65536])
def test_tail_probs_layouts_on_gpu(shim, B, D, layout):
    """K1-f32 on the card within 2 f32 ulps of lfq_tail_column (g++): the
    same DP operations in the same order, only logf differs.  The step's
    [B, D] layout and a row-sliced view launch with no copy; a transposed
    view of a [D, B] tensor is copied once (counted)."""
    _card()
    p, kc = _probs(B, D + 3, seed=7 + B + D)
    if layout == "contiguous":
        probs = torch.from_numpy(np.ascontiguousarray(p[:, :D])).cuda()
    elif layout == "row_sliced":
        probs = torch.from_numpy(p).cuda()[:, 1:1 + D]
    else:
        probs = torch.from_numpy(np.ascontiguousarray(p[:, :D].T)).cuda().t()
    kc_t = torch.from_numpy(kc).cuda()
    cp.reset_launch_count()
    got = cp.tail_probs(probs, kc_t)
    torch.cuda.synchronize()
    assert cp.launch_count("tail_probs") == 1
    copied = layout == "t_view" and B > 1 and D > 1
    assert cp.layout_copy_count() == int(copied)
    want = cuh_shims.tail_columns(shim, probs.cpu().numpy(), kc, workers=8)
    got = got.cpu().numpy()
    assert np.isfinite(got).all()
    assert ulps(got, want).max() <= TAIL_ULPS


@pytest.mark.gpu
@pytest.mark.parametrize("S", [16, 128])
@pytest.mark.parametrize("B", [1, 48, 292, 4096])
def test_screen_codes_on_gpu(shim, B, S):
    """screen_codes on the card within 1e-5 of the split form at T = 8
    (g++: the same slices, steps and merge tree; CUDA's exp2f and logf
    against libm's), masks equal except within 1e-5 of the threshold, and
    two launches identical bit for bit."""
    _card()
    codes, ks, lt = screen_rows("random", S, B=B, seed=11)
    dev = [torch.from_numpy(a).cuda() for a in (codes, ks, lt)]
    cp.reset_launch_count()
    t1, m1 = cp.screen_codes(*dev)
    t2, m2 = cp.screen_codes(*dev)
    torch.cuda.synchronize()
    assert cp.launch_count() == 2
    assert torch.equal(t1, t2) and torch.equal(m1, m2)
    want, want_mask = cuh_shims.screen_columns(shim, codes, ks, lt, 8)
    tail = t1.cpu().numpy()
    assert np.abs(tail - want).max() <= SPLIT_TOL
    near = np.abs(want - lt) <= SPLIT_TOL
    assert ((m1.cpu().numpy() == want_mask) | near).all()
