"""Lightweight per-stage wall-clock accounting for the call pipeline.

The reference has no per-stage tracing; we add it as an aux subsystem
(SURVEY §5) so the host:device throughput split is measurable (ingest
wait vs column building vs screen vs exact DP vs indels).  Overhead is
one perf_counter pair per window/chunk — negligible at that granularity.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

times: dict[str, float] = defaultdict(float)
counts: dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def stage(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        times[name] += time.perf_counter() - t0
        counts[name] += 1


def report() -> dict[str, float]:
    """Cumulative seconds per stage since the last reset."""
    return {k: round(v, 3) for k, v in sorted(times.items())}


def reset() -> None:
    times.clear()
    counts.clear()
