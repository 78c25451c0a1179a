"""The exact Poisson-binomial DP, seconds per call: the `exact_dp` stage
(call/caller.py: _snpcaller_with_screen, on the confirm threads), summed
over threads."""

from portbench.metrics._notes import stage_s


def read(rec):
    return stage_s(rec, "exact_dp")
