"""ctypes bridge to the native batched BAQ/IDAQ engine (csrc/baq.c)."""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from .. import defaults as D

# HMM parameters (illumina profile, kprobaln_ext.c:50)
PAR_D = 0.00001
PAR_E = 0.4

from .._native_build import get_native_lib

_lock = threading.Lock()
_lib = None

_u8 = ctypes.POINTER(ctypes.c_uint8)
_u32 = ctypes.POINTER(ctypes.c_uint32)
_i64 = ctypes.POINTER(ctypes.c_int64)
_ch = ctypes.c_char_p


def _get_lib():
    global _lib
    with _lock:
        if _lib is None:
            lib = get_native_lib()
            lib.lfq_baq_batch.argtypes = [
                _ch, ctypes.c_int64, ctypes.c_int64,
                _i64, _u32, _i64, _ch, _u8, _i64,
                _u8, _u8, ctypes.c_int, ctypes.c_double, ctypes.c_double,
                _u8, _u8, _u8, _u8,
            ]
            _lib = lib
    return _lib


def realn_batch_raw(raws, want_baq, want_idaq, ref: bytes, ext_baq=True):
    """Run the banded HMM for a batch of RAW record blocks.

    Returns (flags u8[n], baq_out, iaq_out, daq_out, out_start i64[n+1]):
    read i's tag bytes live at out_start[i]:out_start[i]+l_seq of the
    respective buffer when the matching flag bit (1=lb 2=ai 4=ad) is set.
    """
    from ..io import bam as bamio

    lib = _get_lib()
    n = len(raws)
    if n == 0:
        z = np.zeros(0, np.uint8)
        return z, z, z, z, np.zeros(1, np.int64)
    pos = np.empty(n, dtype=np.int64)
    cigar_start = np.zeros(n + 1, dtype=np.int64)
    seq_start = np.zeros(n + 1, dtype=np.int64)
    cig_parts = []
    nib_parts = []
    nib_off = np.empty(n + 1, dtype=np.int64)
    nib_off[0] = 0
    qual_parts = []
    for i, buf in enumerate(raws):
        f = bamio.raw_fields(buf)
        pos[i] = f[1]
        cigar_off, n_cigar, seq_off, qual_off, aux_off, l_seq = \
            bamio.raw_layout(buf)
        cigar_start[i + 1] = cigar_start[i] + n_cigar
        seq_start[i + 1] = seq_start[i] + l_seq
        cig_parts.append(buf[cigar_off:seq_off])
        nib_parts.append(buf[seq_off:qual_off])
        nib_off[i + 1] = nib_off[i] + (qual_off - seq_off)
        qual_parts.append(buf[qual_off:aux_off])
    cigars = np.frombuffer(b"".join(cig_parts), dtype=np.uint32)
    # one table lookup decodes every read's bases; per-read slices then
    # drop the odd trailing nibble
    expanded = bamio.seq_lut16()[
        np.frombuffer(b"".join(nib_parts), dtype=np.uint8)].tobytes()
    seqs = b"".join(
        expanded[2 * int(nib_off[i]):
                 2 * int(nib_off[i]) + int(seq_start[i + 1] - seq_start[i])]
        for i in range(n))
    quals = np.frombuffer(b"".join(qual_parts), dtype=np.uint8)
    want_baq = np.ascontiguousarray(want_baq, dtype=np.uint8)
    want_idaq = np.ascontiguousarray(want_idaq, dtype=np.uint8)

    total = int(seq_start[-1]) + n  # +1 NUL per read
    baq_out = np.zeros(total, dtype=np.uint8)
    iaq_out = np.zeros(total, dtype=np.uint8)
    daq_out = np.zeros(total, dtype=np.uint8)
    flags = np.zeros(n, dtype=np.uint8)
    lib.lfq_baq_batch(
        ref, len(ref), n,
        pos.ctypes.data_as(_i64),
        cigars.ctypes.data_as(_u32),
        cigar_start.ctypes.data_as(_i64),
        seqs,
        quals.ctypes.data_as(_u8),
        seq_start.ctypes.data_as(_i64),
        want_baq.ctypes.data_as(_u8),
        want_idaq.ctypes.data_as(_u8),
        1 if ext_baq else 0, PAR_D, PAR_E,
        baq_out.ctypes.data_as(_u8),
        iaq_out.ctypes.data_as(_u8),
        daq_out.ctypes.data_as(_u8),
        flags.ctypes.data_as(_u8),
    )
    out_start = seq_start + np.arange(n + 1, dtype=np.int64)
    return flags, baq_out, iaq_out, daq_out, out_start


def realn_batch(reads, ref: bytes, baq=True, ext_baq=True, idaq=True):
    """Run the banded HMM for a batch of reads; attach lb/ai/ad tags."""
    lib = _get_lib()
    n = len(reads)
    if n == 0:
        return
    pos = np.array([r.pos for r in reads], dtype=np.int64)
    cigar_start = np.zeros(n + 1, dtype=np.int64)
    seq_start = np.zeros(n + 1, dtype=np.int64)
    for i, r in enumerate(reads):
        cigar_start[i + 1] = cigar_start[i] + len(r.cigar)
        seq_start[i + 1] = seq_start[i] + r.l_qseq
    cigars = np.concatenate(
        [np.asarray(r.cigar, dtype=np.uint32) for r in reads]
    ) if cigar_start[-1] else np.zeros(0, dtype=np.uint32)
    seqs = b"".join(r.seq for r in reads)
    quals = np.concatenate(
        [np.asarray(r.qual, dtype=np.uint8) for r in reads]
    ) if seq_start[-1] else np.zeros(0, dtype=np.uint8)
    want_baq = np.array(
        [baq and r.get_tag(D.BAQ_TAG) is None for r in reads], dtype=np.uint8
    )
    want_idaq = np.full(n, 1 if idaq else 0, dtype=np.uint8)

    total = int(seq_start[-1]) + n  # +1 NUL per read
    baq_out = np.zeros(total, dtype=np.uint8)
    iaq_out = np.zeros(total, dtype=np.uint8)
    daq_out = np.zeros(total, dtype=np.uint8)
    flags = np.zeros(n, dtype=np.uint8)

    lib.lfq_baq_batch(
        ref, len(ref), n,
        pos.ctypes.data_as(_i64),
        cigars.ctypes.data_as(_u32),
        cigar_start.ctypes.data_as(_i64),
        seqs,
        quals.ctypes.data_as(_u8),
        seq_start.ctypes.data_as(_i64),
        want_baq.ctypes.data_as(_u8),
        want_idaq.ctypes.data_as(_u8),
        1 if ext_baq else 0, PAR_D, PAR_E,
        baq_out.ctypes.data_as(_u8),
        iaq_out.ctypes.data_as(_u8),
        daq_out.ctypes.data_as(_u8),
        flags.ctypes.data_as(_u8),
    )

    for i, r in enumerate(reads):
        lo = int(seq_start[i]) + i
        hi = lo + r.l_qseq
        if flags[i] & 1:
            r.set_tag(D.BAQ_TAG, "Z",
                      baq_out[lo:hi].tobytes().decode("latin-1"))
        if flags[i] & 2:
            r.set_tag(D.AI_TAG, "Z",
                      iaq_out[lo:hi].tobytes().decode("latin-1"))
        if flags[i] & 4:
            r.set_tag(D.AD_TAG, "Z",
                      daq_out[lo:hi].tobytes().decode("latin-1"))
