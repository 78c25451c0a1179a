"""Loader for the native (C) exact-math library.

Builds csrc/*.c into a shared library on first use (gcc is part of the
supported environment) and exposes ctypes bindings.  The build is cached
next to the sources keyed on mtime.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ._native_build import get_native_lib

_lock = threading.Lock()
_lib = None

_i64 = ctypes.POINTER(ctypes.c_int64)
_f64 = ctypes.POINTER(ctypes.c_double)
_f32 = ctypes.POINTER(ctypes.c_float)


def get_lib():
    global _lib
    with _lock:
        if _lib is None:
            lib = get_native_lib()
            lib.lfq_poissbin_dp_batch.argtypes = [
                _f64, _i64, _i64, _f64, ctypes.c_double,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _f64, _i64,
            ]
            lib.lfq_tailsum_batch.argtypes = [
                _f64, _i64, _i64, ctypes.c_int64, ctypes.c_int64, _f64,
            ]
            for name in ("lfq_log_vec", "lfq_log1p_vec", "lfq_exp_vec"):
                getattr(lib, name).argtypes = [_f64, ctypes.c_int64, _f64]
            lib.lfq_phred2prob_vec.argtypes = [_i64, ctypes.c_int64, _f64]
            lib.lfq_sort_errprobs.argtypes = [_f64, ctypes.c_int64]
            lib.lfq_sort_errprobs_batch.argtypes = [
                _f64, _i64, ctypes.c_int64, ctypes.c_int64,
            ]
            lib.lfq_pack_probs_batch.argtypes = [
                _f64, _i64, _i64, _i64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _f64,
            ]
            lib.lfq_pack_probs_batch_f32.argtypes = [
                _f32, _i64, _i64, _i64,
                ctypes.c_int64, ctypes.c_int64, _f32,
            ]
            _lib = lib
    return _lib


def _ptr(a, typ):
    return a.ctypes.data_as(typ)


def poissbin_dp_batch(probs, depths, ks, bonf, sig):
    """Native batch DP. probs [B,Dmax] f64 C-contiguous; returns
    (state [B,Kmax+1], n_done [B])."""
    lib = get_lib()
    probs = np.ascontiguousarray(probs, dtype=np.float64)
    depths = np.ascontiguousarray(depths, dtype=np.int64)
    ks = np.ascontiguousarray(ks, dtype=np.int64)
    B, Dmax = probs.shape
    bonf = np.ascontiguousarray(
        np.broadcast_to(np.asarray(bonf, dtype=np.float64), (B,))
    )
    Kmax = int(ks.max()) if B else 0
    state = np.empty((B, Kmax + 1), dtype=np.float64)
    n_done = np.empty(B, dtype=np.int64)
    if B:
        lib.lfq_poissbin_dp_batch(
            _ptr(probs, _f64), _ptr(depths, _i64), _ptr(ks, _i64),
            _ptr(bonf, _f64), float(sig), B, Dmax, Kmax,
            _ptr(state, _f64), _ptr(n_done, _i64),
        )
    return state, n_done


def tailsum_batch(state, starts, ks):
    lib = get_lib()
    state = np.ascontiguousarray(state, dtype=np.float64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ks = np.ascontiguousarray(ks, dtype=np.int64)
    B, KP1 = state.shape
    out = np.empty(B, dtype=np.float64)
    if B:
        lib.lfq_tailsum_batch(
            _ptr(state, _f64), _ptr(starts, _i64), _ptr(ks, _i64),
            B, KP1 - 1, _ptr(out, _f64),
        )
    return out


def sort_errprobs(probs):
    """In-place glibc qsort with the reference's absolute-DBL_EPSILON
    comparator (utils.c:66-76).  Near-ties keep a pivot-dependent order
    that np.sort cannot reproduce; the DP accumulates in array order, so
    this is observable in the last ulps of p-values.  Returns its input
    (contiguous f64 copy if conversion was needed)."""
    lib = get_lib()
    probs = np.ascontiguousarray(probs, dtype=np.float64)
    if probs.size:
        lib.lfq_sort_errprobs(_ptr(probs, _f64), probs.size)
    return probs


def sort_errprobs_batch(probs, depths):
    """Row-wise eps-comparator qsort of the first depths[b] entries of a
    [B, Dmax] C-contiguous f64 matrix, in place."""
    lib = get_lib()
    assert probs.dtype == np.float64 and probs.flags.c_contiguous
    depths = np.ascontiguousarray(depths, dtype=np.int64)
    B, Dmax = probs.shape
    if B:
        lib.lfq_sort_errprobs_batch(_ptr(probs, _f64), _ptr(depths, _i64),
                                    B, Dmax)
    return probs


def pack_probs_batch(flat_probs, starts, depths, cols, out, sort):
    """Threaded gather of CSR err probs into the preallocated [B, Dmax]
    matrix `out` (tail-padded with 2.0), optionally row-sorting with the
    reference's eps-comparator qsort.  Byte-identical to gather +
    sort_errprobs_batch at any thread count (rows are independent)."""
    lib = get_lib()
    assert out.dtype == np.float64 and out.flags.c_contiguous
    flat_probs = np.ascontiguousarray(flat_probs, dtype=np.float64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    depths = np.ascontiguousarray(depths, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    B, Dmax = out.shape
    if B:
        lib.lfq_pack_probs_batch(
            _ptr(flat_probs, _f64), _ptr(starts, _i64), _ptr(depths, _i64),
            _ptr(cols, _i64), B, Dmax, 1 if sort else 0, _ptr(out, _f64),
        )
    return out


def pack_probs_batch_f32(flat_probs, starts, depths, cols, out):
    """f32 variant of pack_probs_batch (screening mode: order-free
    probs that never reach the exact DP — no sort path)."""
    lib = get_lib()
    assert out.dtype == np.float32 and out.flags.c_contiguous
    flat_probs = np.ascontiguousarray(flat_probs, dtype=np.float32)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    depths = np.ascontiguousarray(depths, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    B, Dmax = out.shape
    if B:
        lib.lfq_pack_probs_batch_f32(
            _ptr(flat_probs, _f32), _ptr(starts, _i64), _ptr(depths, _i64),
            _ptr(cols, _i64), B, Dmax, _ptr(out, _f32),
        )
    return out


def libm_log(x):
    lib = get_lib()
    x = np.ascontiguousarray(x, dtype=np.float64)
    out = np.empty_like(x)
    lib.lfq_log_vec(_ptr(x, _f64), x.size, _ptr(out, _f64))
    return out
