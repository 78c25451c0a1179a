"""Quality merging — the reference's error model (snpcaller.c:302-341):

  P_joint = PM + (1-PM)*PS + (1-PM)(1-PS)*PBAQ + (1-PM)(1-PS)(1-PBAQ)*PB

with -1 meaning "unknown" (prob 0) and MQ==0 mapped to MQ0_ERRPROB.
Float64 with the same operation order, so results are bit-identical.
"""

from __future__ import annotations

import numpy as np

from ..defaults import MQ0_ERRPROB
from .phred import phred_to_prob


def _q_to_p(q: np.ndarray) -> np.ndarray:
    """-1 -> 0.0, else phred->prob."""
    q = np.asarray(q)
    return np.where(q == -1, 0.0, phred_to_prob(np.maximum(q, 0)))


def merge_srcq_mapq_baq_and_bq(sq, mq, baq, bq) -> np.ndarray:
    """Vectorized merge; all inputs int arrays with -1 == NA.

    Note: callers must already have mapped MQ 255 -> -1 (see
    plp_to_errprobs, snpcaller.c:451-453).  Dispatches to the native C
    kernel (bit-identical, ~20x faster than the numpy rendition below).
    """
    import ctypes

    from ..pileup.native_ingest import get_lib

    sq = np.ascontiguousarray(sq, dtype=np.int32)
    mq = np.ascontiguousarray(mq, dtype=np.int32)
    baq = np.ascontiguousarray(baq, dtype=np.int32)
    bq = np.ascontiguousarray(bq, dtype=np.int32)
    n = sq.size
    out = np.empty(n, dtype=np.float64)
    lib = get_lib()
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.lfq_merge_quals(
        sq.ctypes.data_as(i32p), mq.ctypes.data_as(i32p),
        baq.ctypes.data_as(i32p), bq.ctypes.data_as(i32p),
        ctypes.c_int64(n), ctypes.c_double(MQ0_ERRPROB),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out.reshape(np.asarray(sq).shape)


def merge_srcq_mapq_baq_and_bq_py(sq, mq, baq, bq) -> np.ndarray:
    """Pure-numpy rendition (executable documentation / cross-check)."""
    sp = _q_to_p(sq)
    mq = np.asarray(mq)
    mp = np.where(mq == -1, 0.0, np.where(mq == 0, MQ0_ERRPROB,
                                          phred_to_prob(np.maximum(mq, 0))))
    bap = _q_to_p(baq)
    bp = _q_to_p(bq)
    return (
        mp
        + (1.0 - mp) * sp
        + (1.0 - mp) * (1.0 - sp) * bap
        + (1.0 - mp) * (1.0 - sp) * (1.0 - bap) * bp
    )
