"""The port's tracer: wall seconds per stage, always; spans while tracing.

Every `with stage(name):` adds its wall seconds to `times[name]`, under a
lock, so the sums are exact when the window workers, the raw prefetcher
and the confirm threads close stages at once.  `report()` prints them
(`call --verbose`).  That part costs what a pair of clock reads costs,
plus one check of whether tracing is on.

Tracing is on while a torch.profiler records in this process (the
benchmark's `--trace 1` run, `call --profile DIR`), or inside `traced()`
(tests).  Then each stage is also a span, kept in memory and read by
`spans()`: its name, the id of the call it belongs to, its own id and
its parent's (the enclosing span on the same thread; a worker thread's
first span of a call takes the call's root span), the thread, its start
and end (`time.perf_counter_ns`), the thread CPU it used
(`time.thread_time_ns`), its self time (its duration less what its
children on its own thread cover) and the attributes `note()` gave it.
Under a profiler each span also opens `torch.profiler.record_function`
of its name, so the host's stages sit on the profiler's timeline beside
the kernels and copies; the first traced span after `reset()` records an
anchor event (`ANCHOR`) whose start on `perf_counter_ns` `anchor_ns()`
keeps, to map span times onto the profiler's; `chrome_events` places
the spans in a profiler's chrome trace so.

A call's root span is opened by `call()` (call_pipeline.call_and_filter,
and run_call when it runs alone); its id rides in a context variable, so
work submitted under `contextvars.copy_context()` carries it to other
threads.  The list holds at most MAX_SPANS; spans past it are counted by
`dropped()`.  `reset()` clears the sums, the spans and the anchor.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
from collections import defaultdict
from time import perf_counter_ns as _now
from time import thread_time_ns as _cpu_now

import torch.autograd.profiler as _profiler

MAX_SPANS = 1 << 18
ANCHOR = "stagetimer.anchor"
WARM = "stagetimer.thread"

times: dict[str, float] = defaultdict(float)

_lock = threading.Lock()
_anchor_lock = threading.Lock()
_spans: list = []
_dropped = 0
_anchor_ns = None
_forced = 0                      # traced() blocks open
_ids = itertools.count(1)        # span ids
_call_ids = itertools.count(1)   # call ids
_local = threading.local()       # .stack: the thread's open spans;
                                 # .ranged: it has opened a profiler range
# (call id, root span id or None) of the call this context works for
_CALL = contextvars.ContextVar("lofreq_call", default=None)


class Span:
    """One traced stage; times in nanoseconds."""

    __slots__ = ("name", "call", "id", "parent", "thread", "t0", "t1",
                 "cpu_ns", "self_ns", "attrs", "_cpu0", "_child_ns")

    def __repr__(self):
        return (f"Span({self.name!r}, call={self.call}, id={self.id}, "
                f"parent={self.parent}, thread={self.thread}, "
                f"dur_ns={self.t1 - self.t0}, self_ns={self.self_ns}, "
                f"cpu_ns={self.cpu_ns}, attrs={self.attrs})")


def tracing() -> bool:
    """Whether stages are recorded as spans now."""
    return bool(_forced) or _profiler._is_profiler_enabled


@contextlib.contextmanager
def traced():
    """Record spans inside the block, with or without a profiler (for
    tests; nests, and holds for every thread while open)."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def _add(name: str, ns: int) -> None:
    with _lock:
        times[name] += ns / 1e9


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _warm() -> None:
    """The first profiler range a thread opens sets the thread up, of
    the order of a millisecond, and is stamped late: open one of no use
    first, so that the thread's spans and the anchor map closely."""
    with _profiler.record_function(WARM):
        pass
    _local.ranged = True


def _anchor() -> None:
    global _anchor_ns
    with _anchor_lock:
        if _anchor_ns is None:
            _warm()    # also the profiler's first range is slow to stamp
            t = _now()
            with _profiler.record_function(ANCHOR):
                pass
            _anchor_ns = t


@contextlib.contextmanager
def _span(name: str, call=None):
    """A traced stage.  call: (call id, None) opens a call's root."""
    global _dropped
    stack = _stack()
    sp = Span()
    sp.name = name
    sp.id = next(_ids)
    ctx = call or _CALL.get()
    sp.call = ctx[0] if ctx else None
    if call is not None:
        sp.parent = None
    elif stack:
        sp.parent = stack[-1].id
    else:
        sp.parent = ctx[1] if ctx else None
    sp.thread = threading.get_native_id()
    sp.attrs = None
    sp._child_ns = 0
    token = _CALL.set((sp.call, sp.id)) if call is not None else None
    prof = _profiler._is_profiler_enabled
    if prof and _anchor_ns is None:
        _anchor()
    if prof and not getattr(_local, "ranged", False):
        _warm()
    stack.append(sp)
    sp._cpu0 = _cpu_now()
    sp.t0 = _now()
    try:
        if prof:
            with _profiler.record_function(name):
                yield sp
        else:
            yield sp
    finally:
        sp.t1 = _now()
        sp.cpu_ns = _cpu_now() - sp._cpu0
        dur = sp.t1 - sp.t0
        sp.self_ns = dur - sp._child_ns
        # a generator may close out of order: drop this span wherever
        # it sits
        if stack and stack[-1] is sp:
            stack.pop()
        elif sp in stack:
            stack.remove(sp)
        if stack and stack[-1].id == sp.parent:
            stack[-1]._child_ns += dur
        if token is not None:
            _CALL.reset(token)
        with _lock:
            times[name] += dur / 1e9
            if len(_spans) < MAX_SPANS:
                _spans.append(sp)
            else:
                _dropped += 1


@contextlib.contextmanager
def stage(name: str):
    if not (_forced or _profiler._is_profiler_enabled):
        t0 = _now()
        try:
            yield
        finally:
            _add(name, _now() - t0)
        return
    with _span(name):
        yield


@contextlib.contextmanager
def call():
    """The root span `call` of one call, with a new call id; inside an
    open call (run_call within call_and_filter) it opens nothing."""
    if _CALL.get() is not None:
        yield
        return
    cid = next(_call_ids)
    if not tracing():
        token = _CALL.set((cid, None))
        t0 = _now()
        try:
            yield
        finally:
            _add("call", _now() - t0)
            _CALL.reset(token)
        return
    with _span("call", call=(cid, None)):
        yield


def note(**attrs) -> None:
    """Attributes of the thread's innermost open span (nothing when no
    span is traced)."""
    stack = getattr(_local, "stack", None)
    if stack:
        sp = stack[-1]
        if sp.attrs is None:
            sp.attrs = {}
        sp.attrs.update(attrs)


def spans() -> list:
    """The spans closed since the last reset(), in the order they closed."""
    with _lock:
        return list(_spans)


def dropped() -> int:
    """Spans left out of spans() because the list was full."""
    return _dropped


def anchor_ns():
    """perf_counter_ns of the ANCHOR event, or None before one."""
    return _anchor_ns


def chrome_events(anchor_ts_us: float) -> list:
    """spans() as chrome-trace complete events on a profiler trace's
    timeline, given the trace time (us) of its ANCHOR event; one row per
    thread under the process "stagetimer", each event's args its call,
    span and parent ids, thread CPU, self time and attributes."""
    base = anchor_ns()
    if base is None:
        return []
    out = []
    for sp in spans():
        args = dict(call=sp.call, span=sp.id, parent=sp.parent,
                    cpu_us=sp.cpu_ns / 1e3, self_us=sp.self_ns / 1e3)
        args.update(sp.attrs or {})
        out.append(dict(ph="X", cat="stagetimer", name=sp.name,
                        pid="stagetimer", tid=sp.thread,
                        ts=anchor_ts_us + (sp.t0 - base) / 1e3,
                        dur=(sp.t1 - sp.t0) / 1e3, args=args))
    return out


def report() -> dict[str, float]:
    """Cumulative seconds per stage since the last reset."""
    with _lock:
        return {k: round(v, 3) for k, v in sorted(times.items())}


def reset() -> None:
    global _dropped, _anchor_ns
    with _lock:
        times.clear()
        _spans.clear()
        _dropped = 0
        _anchor_ns = None
