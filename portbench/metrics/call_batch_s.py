"""The calling thread's batch calls (`call.batch`, around
call_vars_batch), seconds per call: the window's column statistics, the
packing and the prescreen, and the device sub-screen where it is not
left to the confirm (metrics/_spans.py)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.part(rec, "batch")
