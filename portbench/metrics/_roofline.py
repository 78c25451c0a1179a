"""Share of a kernel function's roofline, shared by the *_roofline
readers: the least time the card could take for the bytes and f32
operations counted from the function's arguments (roofline/<function>.py,
at the peaks of roofline/peaks.json), over the device time of its
kernels (the mean launch the profiler saw times the program's launch
count)."""

import json
import os

_PEAKS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "roofline", "peaks.json")


def share(rec, function):
    r = rec["roofline"].get(function)
    if not r or not r["kernel_s"]:
        return None
    with open(_PEAKS) as fh:
        peaks = json.load(fh)
    least = max(r["bytes"] / peaks["hbm_bytes_per_s"],
                r["ops"] / peaks["f32_ops_per_s"])
    if least <= 0:
        return None
    return 100.0 * least / r["kernel_s"]
