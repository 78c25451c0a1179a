"""Bytes the device BAQ copies to the card and back, MB (1e6 B) per call:
the `bytes` of the runner's `devbaq.h2d` (its six host-to-card copies)
and `devbaq.d2h` (the final BAQ back) spans (metrics/_spans.py).  Reads
nothing where the device BAQ does not run."""

from portbench.metrics import _spans


def read(rec):
    w = _spans.window()
    if w is None:
        return None
    return _spans.copy_mb_per_call(w[0], w[1], rec["calls"])
