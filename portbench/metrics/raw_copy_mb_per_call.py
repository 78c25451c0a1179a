"""What the window raw fetch copied and newly allocated to hand out its
records, MB (1e6 B) per call: the `copied` and `fresh` bytes noted on
each `ingest.raw` span (raw_mb_per_call's spans).  Reads nothing where
the program notes neither."""

from portbench.metrics import _spans
from portbench.metrics.raw_mb_per_call import noted_mb_per_call


def read(rec):
    w = _spans.window()
    if w is None:
        return None
    return noted_mb_per_call(w[0], w[1], rec["calls"], ("copied", "fresh"))
