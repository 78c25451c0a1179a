"""Multiple-testing correction: Bonferroni, Holm-Bonferroni, Benjamini-
Hochberg FDR, with the same numerics and tie handling as the reference
(multtest.c:65-187) — validated against the R results embedded there
(multtest.c:219-241).
"""

from __future__ import annotations

import numpy as np

MTC_NONE = 0
MTC_BONF = 1
MTC_HOLMBONF = 2
MTC_FDR = 3

MTC_TYPE_STR = ["MTC_NONE", "MTC_BONF", "MTC_HOLMBONF", "MTC_FDR"]


def mtc_str_to_type(t: str) -> int:
    if t in ("bonf", "bonferroni"):
        return MTC_BONF
    if t in ("holm", "holmbonf", "holm-bonf", "holmbonferroni"):
        return MTC_HOLMBONF
    if t == "fdr":
        return MTC_FDR
    return -1


def mtc_type_to_str(mtc_type: int) -> str:
    return MTC_TYPE_STR[mtc_type][4:].lower()


def bonf_corr(data: np.ndarray, num_tests: int) -> np.ndarray:
    """In-place-style Bonferroni: multiply by the factor (multtest.c:65)."""
    data = np.asarray(data, dtype=np.float64)
    fac = len(data) if num_tests < 1 else num_tests
    return data * float(fac)


def holm_bonf_corr(data: np.ndarray, alpha: float, num_tests: int) -> np.ndarray:
    """Holm step-down; only p-values whose corrected value would be below
    alpha are actually corrected (multtest.c:90-135)."""
    data = np.asarray(data, dtype=np.float64).copy()
    size = len(data)
    order = np.argsort(data, kind="stable")
    lp = size if num_tests < 1 else num_tests
    pp = data[order[0]] if size else 0.0
    for rank, i in enumerate(order):
        p = data[i]
        if p != pp:
            lp = (size - rank) if num_tests < 1 else (num_tests - rank)
            pp = p
        tp = p * 1.0 / lp
        if tp < alpha:
            data[i] = p * lp
    return data


def fdr(data: np.ndarray, alpha: float, num_tests: int):
    """Benjamini-Hochberg. Returns indices of rejected (significant) tests.

    Matches the reference exactly including the single-precision cast of the
    test count in the threshold comparison (multtest.c:169:
    ``iarr[i-1].p < alpha*i/(float)n``).
    """
    data = np.asarray(data, dtype=np.float64)
    size = len(data)
    if size == 0:
        return np.zeros(0, dtype=np.int64)
    n = size if num_tests < 1 else num_tests
    order = np.argsort(data, kind="stable")
    sorted_p = data[order]
    nf = np.float64(np.float32(n))
    nrejected = 0
    for i in range(size, 0, -1):
        if sorted_p[i - 1] < np.float64(alpha * i) / nf:
            nrejected = i
            break
    return order[:nrejected].copy()
