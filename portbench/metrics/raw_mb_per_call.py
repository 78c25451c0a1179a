"""Raw BAM records handed to the window builds, MB (1e6 B) per call: the
`bytes` that the port's window raw fetch notes on each `ingest.raw` span
(lofreq_tpu_torch/pileup/native_ingest.py: raw_records_for_region, on
the raw prefetch thread), read through metrics/_spans.py.  Reads nothing
where the program notes no bytes on those spans."""

from portbench.metrics import _spans


def noted_mb_per_call(spans, dropped, calls, keys):
    """MB per call of the attributes `keys`, summed over every
    `ingest.raw` span that notes them all; None where the window's roots
    do not stand for its calls or no span notes them."""
    if _spans.roots(spans, dropped, calls) is None:
        return None
    noted = [s.attrs for s in spans if s.name == "ingest.raw" and s.attrs
             and all(k in s.attrs for k in keys)]
    if not noted:
        return None
    return sum(a[k] for a in noted for k in keys) / 1e6 / calls


def read(rec):
    w = _spans.window()
    if w is None:
        return None
    return noted_mb_per_call(w[0], w[1], rec["calls"], ("bytes",))
