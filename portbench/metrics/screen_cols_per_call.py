"""Columns the prescreen left for the device sub-screen, per call: the
port's own count of the columns of every screen dispatch
(ops/screen.DISPATCH_STATS["columns"])."""


def read(rec):
    d, calls = rec.get("dispatch"), rec["calls"]
    if not calls or d is None:
        return None
    return d["columns"] / calls
