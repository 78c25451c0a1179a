"""Share of the traced window in which no kernel, copy or set ran on the
card: 100 (1 - the union of the profiler's device intervals / the
window)."""


def read(rec):
    if not rec["window_s"]:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
