"""The kernels' bodies built for the host: csrc/poissbin_screen.cuh (K1),
csrc/baq_hmm.cuh (K3/K4) and csrc/fused_call.cuh (K2) compiled by g++
into ctypes shims.

The CPU tests hold these shims against the plain PyTorch versions, and
chip_smoke.py holds the kernels on the card against them.  g++ builds
with -ffp-contract=off, as the kernels build with -fmad=false, so both
round every multiply and add on its own.

    lib = build_screen_shim(workdir)
    tail, mask = screen_columns(lib, codes, ks, log_thresh, T=8)
    tail = tail_columns(lib, probs, kc)
    lib = build_baq_shim(workdir)
    q, st = baq_grid(lib, refw, query, qualp, l_ref)
    lib = build_fused_shim(workdir)
    tail, depth, acnt, araw = fused_columns(lib, packed_t, ref_nt4, T=8)
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .._kernel_build import CSRC

GXX_FLAGS = ["-O2", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17",
             "-Wall", "-Werror"]

# screen_cols: T = 0 runs the serial column (lfq_screen_column), T = 1, 2,
# 4, 8 the split column and its merge tree (lfq_screen_column_split).
# tail_cols reads [n, d] rows `ld` floats apart, as tail_probs_kernel does.
SCREEN_SRC = r'''
#include "poissbin_screen.cuh"
extern "C" void screen_cols(const uint8_t *codes, const int32_t *ks,
                            const float *lt, float *tail, uint8_t *mask,
                            long long n, int s, int T) {
  for (long long i = 0; i < n; ++i)
    mask[i] = T == 0
        ? lfq_screen_column(codes + i * s, s, ks[i], lt[i], tail + i)
        : lfq_screen_column_split(codes + i * s, s, ks[i], lt[i], T,
                                  tail + i);
}
extern "C" void tail_cols(const float *probs, long long ld,
                          const int32_t *kc, float *tail, long long n,
                          long long d) {
  for (long long i = 0; i < n; ++i)
    tail[i] = lfq_tail_column(probs + i * ld, 1, d, kc[i]);
}
extern "C" void decode_table(float *out) { lfq_fill_decode_table(out, 0, 1); }
'''

# baq_grid walks K3's grid (8 reads per block, the dead reads of the last
# block on the last real read's inputs, writing nothing) into [n, L, 16]
# scratch, then runs the backward pass on every read, as K4 does.
# baq_fwd_rows runs the forward pass alone.
BAQ_SRC = r'''
#include <vector>
#include "baq_hmm.cuh"
extern "C" void baq_grid(const uint8_t *refw, const uint8_t *query,
                         const float *qualp, const int32_t *l_ref,
                         long long n, int L, int Lr, int32_t *q,
                         int32_t *st) {
  const LfqBaqConsts c = lfq_baq_consts(L);
  const long long n_pad = (n + 7) / 8 * 8;
  std::vector<float> fm(n_pad * L * 16), fi(n_pad * L * 16), fs(n_pad * L);
  for (long long r = 0; r < n_pad; ++r) {
    const bool live = r < n;
    const long long b = live ? r : n - 1;
    const long long rows = b * L;
    lfq_baq_forward<LfqBand16>(refw + b * Lr, Lr, l_ref[b], query + rows,
        qualp + rows, L, c, &fm[rows * 16], &fi[rows * 16], &fs[rows],
        live);
  }
  for (long long b = 0; b < n; ++b) {
    const long long rows = b * L;
    LfqRowsDirect<LfqBand16> z{&fm[rows * 16], &fi[rows * 16]};
    lfq_baq_backward<LfqBand16>(refw + b * Lr, Lr, l_ref[b], query + rows,
        qualp + rows, L, c, z, &fs[rows], q + rows, st + rows, true);
  }
}
extern "C" void baq_fwd_rows(const uint8_t *refw, const uint8_t *query,
                             const float *qualp, const int32_t *l_ref,
                             long long n, int L, int Lr, float *fm,
                             float *fi, float *fs) {
  const LfqBaqConsts c = lfq_baq_consts(L);
  for (long long b = 0; b < n; ++b)
    lfq_baq_forward<LfqBand16>(refw + b * Lr, Lr, l_ref[b], query + b * L,
        qualp + b * L, L, c, fm + b * L * 16, fi + b * L * 16, fs + b * L,
        true);
}
'''

# fused_cols reads [D, B] as K2 does: T = 0 runs the sequential body
# (lfq_fc_column), T = 1, 2, 4, 8 the split-depth body and its merge tree.
FUSED_SRC = r'''
#include "fused_call.cuh"
extern "C" void fused_cols(const int32_t *packed_t, const int32_t *ref,
                           float *tail, int32_t *depth, int32_t *acnt,
                           int32_t *araw, long long n, long long d, int T,
                           int min_bq, int min_alt_bq, int use_baq,
                           int use_mq, int use_sq) {
  const LfqFusedConf k = {min_bq, min_alt_bq, use_baq, use_mq, use_sq};
  LfqFcTables t;
  lfq_fc_fill_tables(t, k);
  for (long long i = 0; i < n; ++i) {
    if (T == 0)
      lfq_fc_column(packed_t + i, n, d, ref[i], k, t, tail + i, depth + i,
                    acnt + 4 * i, araw + 4 * i);
    else
      lfq_fc_split_column(packed_t + i, n, d, T, ref[i], k, t, tail + i,
                          depth + i, acnt + 4 * i, araw + 4 * i);
  }
}
extern "C" void fused_tables(int use_baq, int use_mq, int use_sq,
                             float *out) {
  const LfqFusedConf k = {0, 0, use_baq, use_mq, use_sq};
  LfqFcTables t;
  lfq_fc_fill_tables(t, k);
  for (int f = 0; f < LFQ_FC_NQ; ++f) {
    out[f] = t.bq[f];
    out[LFQ_FC_NQ + f] = t.baq[f];
    out[2 * LFQ_FC_NQ + f] = t.mq[f];
    out[3 * LFQ_FC_NQ + f] = t.sq[f];
  }
}
'''

SPLITS = (1, 2, 4, 8)   # T of lfq_fc_split_column (LFQ_FC_TMAX = 8)


def build_shim(src: str, workdir: str, name: str,
               include: str = CSRC) -> ctypes.CDLL:
    """`src` built by g++ with `include` on its header path, loaded."""
    os.makedirs(workdir, exist_ok=True)
    cpp = os.path.join(workdir, f"{name}.cpp")
    so = os.path.join(workdir, f"lib{name}.so")
    with open(cpp, "w") as fh:
        fh.write(src)
    proc = subprocess.run(["g++", *GXX_FLAGS, "-I", include, "-o", so, cpp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {name}:\n{proc.stderr}")
    return ctypes.CDLL(so)


SCREEN_SPLITS = (1, 2, 4, 8)   # T of lfq_screen_column_split


def build_screen_shim(workdir: str) -> ctypes.CDLL:
    lib = build_shim(SCREEN_SRC, workdir, "screen_shim")
    lib.screen_cols.argtypes = ([ctypes.c_void_p] * 5
                                + [ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_int])
    lib.tail_cols.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                              + [ctypes.c_void_p] * 2
                              + [ctypes.c_longlong] * 2)
    lib.decode_table.argtypes = [ctypes.c_void_p]
    return lib


def screen_columns(lib, codes, ks, log_thresh, T: int = 8):
    """(log tail [B] f32, candidate mask [B] bool) of the host-built K1
    body over u8 codes [B, S]: T = 0 the serial column, else the row split
    into T slices and merged (T = 8 is screen_codes_kernel's split)."""
    if T not in (0,) + SCREEN_SPLITS:
        raise ValueError(f"T must be 0 or one of {SCREEN_SPLITS}, got {T}")
    codes = np.ascontiguousarray(codes, np.uint8)
    ks = np.ascontiguousarray(ks, np.int32)
    lt = np.ascontiguousarray(log_thresh, np.float32)
    B, S = codes.shape
    tail = np.empty(B, np.float32)
    mask = np.empty(B, np.uint8)
    lib.screen_cols(codes.ctypes.data, ks.ctypes.data, lt.ctypes.data,
                    tail.ctypes.data, mask.ctypes.data, B, S, int(T))
    return tail, mask.astype(bool)


def tail_columns(lib, probs, kc, workers: int = 1):
    """log tail [B] f32 of the host-built K1 f32 body (lfq_tail_column)
    over probs [B, D] f32 read by rows, kc [B] int32; `workers` threads
    take row blocks (a ctypes call releases the GIL)."""
    probs = np.ascontiguousarray(probs, np.float32)
    kc = np.ascontiguousarray(kc, np.int32)
    B, D = probs.shape
    tail = np.empty(B, np.float32)
    step = max(1, -(-B // max(1, workers)))

    def run(lo):
        hi = min(B, lo + step)
        lib.tail_cols(probs[lo:hi].ctypes.data, D, kc[lo:hi].ctypes.data,
                      tail[lo:hi].ctypes.data, hi - lo, D)

    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        list(pool.map(run, range(0, B, step)))
    return tail


def decode_table(lib):
    """The decode table [256] f32 that screen_codes_kernel fills."""
    out = np.empty(256, np.float32)
    lib.decode_table(out.ctypes.data)
    return out


def build_baq_shim(workdir: str) -> ctypes.CDLL:
    lib = build_shim(BAQ_SRC, workdir, "baq_shim")
    lib.baq_grid.argtypes = ([ctypes.c_void_p] * 4
                             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                             + [ctypes.c_void_p] * 2)
    lib.baq_fwd_rows.argtypes = lib.baq_grid.argtypes + [ctypes.c_void_p]
    return lib


def baq_grid(lib, refw, query, qualp, l_ref):
    """(q, st) [B, L] int32 of the host-built K3 + K4 bodies."""
    refw, query = (np.ascontiguousarray(a, np.uint8) for a in (refw, query))
    qualp = np.ascontiguousarray(qualp, np.float32)
    l_ref = np.ascontiguousarray(l_ref, np.int32)
    B, Lr = refw.shape
    L = query.shape[1]
    q = np.full((B, L), -1, np.int32)
    st = np.full((B, L), -1, np.int32)
    lib.baq_grid(refw.ctypes.data, query.ctypes.data, qualp.ctypes.data,
                 l_ref.ctypes.data, B, L, Lr, q.ctypes.data, st.ctypes.data)
    return q, st


def build_fused_shim(workdir: str) -> ctypes.CDLL:
    lib = build_shim(FUSED_SRC, workdir, "fused_shim")
    lib.fused_cols.argtypes = ([ctypes.c_void_p] * 6
                               + [ctypes.c_longlong] * 2
                               + [ctypes.c_int] * 6)
    lib.fused_tables.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib


def fused_tables(lib, use_baq=True, use_mq=True, use_sq=False):
    """The decode tables [4, 128] f32 (bq, BAQ, MQ and SQ field values)."""
    out = np.empty((4, 128), np.float32)
    lib.fused_tables(int(use_baq), int(use_mq), int(use_sq), out.ctypes.data)
    return out


def fused_columns(lib, packed_t, ref_nt4, T: int = 0, min_bq=6,
                  min_alt_bq=6, use_baq=True, use_mq=True, use_sq=False):
    """(log tail [B] f32, depth [B] int32, kept-alt and raw-alt counts
    [B, 4] int32) of the host-built K2 body over packed_t [D, B]: T = 0
    read by read, else the depth split into T slices and merged."""
    if T not in (0,) + SPLITS:
        raise ValueError(f"T must be 0 or one of {SPLITS}, got {T}")
    packed_t = np.ascontiguousarray(packed_t, np.int32)
    ref = np.ascontiguousarray(ref_nt4, np.int32)
    Dd, B = packed_t.shape
    tail = np.empty(B, np.float32)
    depth = np.empty(B, np.int32)
    acnt = np.empty((B, 4), np.int32)
    araw = np.empty((B, 4), np.int32)
    lib.fused_cols(packed_t.ctypes.data, ref.ctypes.data, tail.ctypes.data,
                   depth.ctypes.data, acnt.ctypes.data, araw.ctypes.data, B,
                   Dd, int(T), int(min_bq), int(min_alt_bq), int(use_baq),
                   int(use_mq), int(use_sq))
    return tail, depth, acnt, araw
