"""Phred <-> probability conversions with C-identical semantics.

Mirrors the macros in the reference's utils.h:42-48:
  PHREDQUAL_TO_PROB(q) = pow(10, -q/10)          (INT_MAX -> DBL_MIN)
  PROB_TO_PHREDQUAL(p) = (int)(-10 * log10l(p))  (truncation toward zero)
  PROB_TO_PHREDQUAL_SAFE(p): p <= 0 -> INT_MAX

A lookup table built with libm pow() guarantees bit-identical doubles
(numpy's vectorized pow may differ in the last ulp).
"""

from __future__ import annotations

import math

import numpy as np

INT_MAX = 2**31 - 1
DBL_MIN = 2.2250738585072014e-308
DBL_EPSILON = 2.220446049250313e-16
DBL_MAX = 1.7976931348623157e308
LOGZERO = -1e100
# x86 long double limits (matches C LDBL_MIN/LDBL_MAX used in snpcaller.c)
LDBL_MIN = np.finfo(np.longdouble).tiny
LDBL_MAX = np.finfo(np.longdouble).max

_TABLE_SIZE = 1 << 17
_PHRED2PROB = np.array(
    [math.pow(10.0, -1.0 * q / 10.0) for q in range(_TABLE_SIZE)],
    dtype=np.float64
)


def phred_to_prob(q):
    """Vectorized PHREDQUAL_TO_PROB. q may be negative? callers guarantee >=0
    except INT_MAX handling."""
    q = np.asarray(q, dtype=np.int64)
    out = np.where(
        q == INT_MAX,
        DBL_MIN,
        _PHRED2PROB[np.clip(q, 0, _TABLE_SIZE - 1)],
    )
    # exact fallback for out-of-table (never phred > 131071 in practice)
    return out


def phred_to_prob_scalar(q: int) -> float:
    if q == INT_MAX:
        return DBL_MIN
    return math.pow(10.0, -1.0 * q / 10.0)


def prob_to_phred(p) -> int:
    """PROB_TO_PHREDQUAL on a scalar (long-double log10)."""
    return int(-10.0 * np.log10(np.longdouble(p)))


def prob_to_phred_safe(p) -> int:
    if p <= 0.0:
        return INT_MAX
    return int(-10.0 * np.log10(np.longdouble(p)))


def prob_to_phred_vec(p: np.ndarray) -> np.ndarray:
    """Vectorized PROB_TO_PHREDQUAL (truncation toward zero)."""
    with np.errstate(divide="ignore"):
        v = -10.0 * np.log10(np.asarray(p, dtype=np.longdouble))
    return np.trunc(v).astype(np.int64)


def prob_to_phred_safe_vec(p: np.ndarray) -> np.ndarray:
    p = np.asarray(p)
    out = np.full(p.shape, INT_MAX, dtype=np.int64)
    pos = p > 0.0
    if np.any(pos):
        out[pos] = prob_to_phred_vec(p[pos])
    return out
