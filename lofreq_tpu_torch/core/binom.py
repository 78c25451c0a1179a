"""Binomial cdf/sf.  The reference wraps cdflib's cdfbin (binom.c:52-92) and
documents it as "identical to scipy.stats.binom.sf" (binom.c:131-132), so we
use scipy directly.
"""

from __future__ import annotations

from scipy.stats import binom as _binom


def binom_cdf_sf(num_trials: int, num_success: int, prob_success: float):
    """Returns (P, Q): cdf at num_success and its complement, as cdfbin."""
    p = float(_binom.cdf(num_success, num_trials, prob_success))
    q = float(_binom.sf(num_success, num_trials, prob_success))
    return p, q
