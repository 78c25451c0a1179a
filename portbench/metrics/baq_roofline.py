"""K3 + K4 (`baq_fwd_kernel`, `baq_bwd_kernel`): share of the roofline of
every device BAQ batch of the traced window (roofline/baq_hmm.py)."""

from portbench.metrics._roofline import share


def read(rec):
    return share(rec, "baq_hmm")
