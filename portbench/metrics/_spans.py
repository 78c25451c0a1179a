"""The port's own spans of the traced window (lofreq_tpu_torch's
core/stagetimer.py), as the call_* and devbaq_copy readers read them.

run.py resets the tracer before the window and the profiler bounds it,
so `stagetimer.spans()` then holds the window's calls alone.  A reader
gives None where the program keeps no spans (a tree without the tracer),
where spans were dropped, or where the window's `call` roots are not one
per call of the record.

The calling thread's wall splits into five parts, which per call sum to
the duration of its root span `call`: the waits on the window builds
(`ingest_wait`), the batch calls (`call.batch`), the waits on the
confirms (`confirm_wait`), the output (`filter`, `vcf_write`), and the
root's self time (what none of its children on that thread covers)."""

PARTS = {"ingest_wait": ("ingest_wait",), "batch": ("call.batch",),
         "confirm_wait": ("confirm_wait",),
         "output": ("filter", "vcf_write")}


def window():
    """(spans, dropped) of the tracer, or None where the program has none."""
    try:
        from lofreq_tpu_torch.core import stagetimer

        return stagetimer.spans(), stagetimer.dropped()
    except (ImportError, AttributeError):
        return None


def roots(spans, dropped, calls):
    """The window's `call` roots, or None where they cannot stand for the
    record's calls."""
    if dropped or not calls:
        return None
    rs = [s for s in spans if s.name == "call" and s.parent is None]
    return rs if len(rs) == calls else None


def split(spans, dropped, calls):
    """Seconds per call of each part of the calling thread's wall, and
    `own` (the roots' self time), or None."""
    rs = roots(spans, dropped, calls)
    if rs is None:
        return None
    on_caller = {(r.id, r.thread) for r in rs}
    ns = dict.fromkeys(PARTS, 0)
    for s in spans:
        if (s.parent, s.thread) in on_caller:
            for part, names in PARTS.items():
                if s.name in names:
                    ns[part] += s.t1 - s.t0
    ns["own"] = sum(r.self_ns for r in rs)
    return {k: v / 1e9 / calls for k, v in ns.items()}


def part(rec, name):
    """One part of split(), per call, for the record's window."""
    w = window()
    if w is None:
        return None
    parts = split(w[0], w[1], rec["calls"])
    return None if parts is None else parts[name]


def copy_mb_per_call(spans, dropped, calls):
    """MB (1e6 B) the device BAQ moved to and from the card per call: the
    `bytes` of every `devbaq.h2d` and `devbaq.d2h` span; None where none
    ran."""
    if roots(spans, dropped, calls) is None:
        return None
    moved = [s.attrs["bytes"] for s in spans
             if s.name in ("devbaq.h2d", "devbaq.d2h")
             and s.attrs and "bytes" in s.attrs]
    if not moved:
        return None
    return sum(moved) / 1e6 / calls
