"""Fisher's exact test on a 2x2 table (two-tailed), used for strand bias.

Same tail-accumulation contract as samtools' kt_fisher_exact (the reference
links it as fet.c; call site lofreq_call.c:126): hypergeometric pmf via
lgamma, incremental ratio updates with periodic exact recomputation, and the
0.99999999 / 1.00000001 tolerance band when accumulating tables as extreme as
the observed one.  Implemented here from the algorithm definition in Python.
"""

from __future__ import annotations

from math import exp, lgamma


def _lbinom(n: int, k: int) -> float:
    if k == 0 or n == k:
        return 0.0
    return lgamma(n + 1) - lgamma(k + 1) - lgamma(n - k + 1)


def _hypergeo(n11: int, n1_: int, n_1: int, n: int) -> float:
    return exp(_lbinom(n1_, n11) + _lbinom(n - n1_, n_1 - n11) - _lbinom(n, n_1))


class _HGAcc:
    """Incremental hypergeometric evaluator with the same refresh rule as the
    samtools implementation (recompute exactly when n11 % 11 == 0 or at the
    distribution edge)."""

    __slots__ = ("n11", "n1_", "n_1", "n", "p")

    def __init__(self):
        self.n11 = self.n1_ = self.n_1 = self.n = 0
        self.p = 0.0

    def calc(self, n11, n1_=0, n_1=0, n=0) -> float:
        if n1_ or n_1 or n:
            self.n11, self.n1_, self.n_1, self.n = n11, n1_, n_1, n
        else:
            if n11 % 11 and n11 + self.n - self.n1_ - self.n_1:
                if n11 == self.n11 + 1:
                    self.p *= (
                        (self.n1_ - self.n11) / n11
                        * (self.n_1 - self.n11)
                        / (n11 + self.n - self.n1_ - self.n_1)
                    )
                    self.n11 = n11
                    return self.p
                if n11 == self.n11 - 1:
                    self.p *= (
                        self.n11 / (self.n1_ - n11)
                        * (self.n11 + self.n - self.n1_ - self.n_1)
                        / (self.n_1 - n11)
                    )
                    self.n11 = n11
                    return self.p
            self.n11 = n11
        self.p = _hypergeo(self.n11, self.n1_, self.n_1, self.n)
        return self.p


def fisher_exact(n11: int, n12: int, n21: int, n22: int):
    """Returns (prob_of_table, left_pv, right_pv, two_tailed_pv)."""
    n1_ = n11 + n12
    n_1 = n11 + n21
    n = n11 + n12 + n21 + n22
    mx = min(n_1, n1_)
    mn = n1_ + n_1 - n
    if mn < 0:
        mn = 0
    if mn == mx:
        return 1.0, 1.0, 1.0, 1.0
    aux = _HGAcc()
    q = aux.calc(n11, n1_, n_1, n)
    # left tail
    p = aux.calc(mn)
    left = 0.0
    i = mn + 1
    while p < 0.99999999 * q:
        left += p
        p = aux.calc(i)
        i += 1
    i -= 1
    if p < 1.00000001 * q:
        left += p
    else:
        i -= 1
    # right tail
    p = aux.calc(mx)
    right = 0.0
    j = mx - 1
    while p < 0.99999999 * q:
        right += p
        p = aux.calc(j)
        j -= 1
    j += 1
    if p < 1.00000001 * q:
        right += p
    else:
        j += 1
    two = left + right
    if two > 1.0:
        two = 1.0
    if abs(i - n11) < abs(j - n11):
        right = 1.0 - left + q
    else:
        left = 1.0 - right + q
    return q, left, right, two


def strand_bias_qual(ref_fw: int, ref_rv: int, alt_fw: int, alt_rv: int) -> int:
    """Phred-scaled two-tailed Fisher p-value as in report_var
    (lofreq_call.c:119-129): INT_MAX when ref is absent and alt is entirely
    on one strand."""
    from .phred import INT_MAX, prob_to_phred_safe

    if (ref_fw + ref_rv) == 0 and (alt_fw == 0 or alt_rv == 0):
        return INT_MAX
    _, _, _, two = fisher_exact(ref_fw, ref_rv, alt_fw, alt_rv)
    return prob_to_phred_safe(two)
