"""The traced run's instruments: stage spans, kernel-function costs and
the device trace, gathered into the record that portbench/metrics read.

Everything here is the benchmark's own instrumentation of the program,
installed only in a `--trace 1` run:
  * each `core.stagetimer.stage` of the port also becomes a host span
    (name, start, end), so idle gaps on the device can be named by the
    stage the host was in;
  * each roofline/<function>.py names the port function that issues its
    kernels (HOOK); a wrapper adds up the bytes and operations of every
    call, counted from the call's own arguments;
  * torch.profiler records the device: kernels, copies and sets, whose
    union over time is the busy time.
"""

from __future__ import annotations

import contextlib
import importlib
import threading
import time

import torch


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo, hi):
    """The idle (start, end) stretches of [lo, hi] outside the intervals."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def mean_times_launches(durations, launches: int):
    """Device seconds of a kernel: the mean of the launches the profiler
    saw, times the launches the program counted (the profiler drops some
    records).  None when it saw none."""
    if not durations or launches <= 0:
        return None
    return sum(durations) / len(durations) * launches


class Tracer:
    """Installs the instruments; `record()` gives the metrics' input."""

    def __init__(self, roofline_modules: dict):
        self.roofline = roofline_modules          # name -> module
        self.spans = []                            # (name, t0, t1) host
        self.costs = {n: [0.0, 0.0] for n in roofline_modules}
        self._lock = threading.Lock()
        self._undo = []
        self.prof = None
        self.t_mark = None

    # -- instruments -----------------------------------------------------
    def install(self):
        from lofreq_tpu_torch.core import stagetimer

        orig_stage = stagetimer.stage
        spans, lock = self.spans, self._lock

        @contextlib.contextmanager
        def stage(name):
            t0 = time.perf_counter()
            try:
                with orig_stage(name):
                    yield
            finally:
                t1 = time.perf_counter()
                with lock:
                    spans.append((name, t0, t1))

        stagetimer.stage = stage
        self._undo.append((stagetimer, "stage", orig_stage))
        for name, mod in self.roofline.items():
            target = importlib.import_module(mod.HOOK[0])
            orig = getattr(target, mod.HOOK[1])
            setattr(target, mod.HOOK[1], self._costed(name, mod, orig))
            self._undo.append((target, mod.HOOK[1], orig))

    def _costed(self, name, mod, orig):
        acc, lock = self.costs[name], self._lock

        def wrapper(*args, **kw):
            nbytes, ops = mod.cost(*args, **kw)
            with lock:
                acc[0] += nbytes
                acc[1] += ops
            return orig(*args, **kw)

        return wrapper

    def uninstall(self):
        for obj, attr, orig in reversed(self._undo):
            setattr(obj, attr, orig)
        self._undo.clear()

    # -- the traced window ----------------------------------------------
    def start(self):
        for mod in self.roofline.values():
            mod.reset()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        # a host event whose trace time is known on the host's clock
        with torch.profiler.record_function("portbench.mark"):
            self.t_mark = time.perf_counter()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def record(self, calls: int, window_s: float, t_open: float,
               t_close: float) -> dict:
        """The metrics' input.  t_open, t_close: the window on the host's
        clock (perf_counter)."""
        from torch.autograd import DeviceType

        events = self.prof.events()
        dev, mark = [], None
        for e in events:
            if e.name == "portbench.mark" and mark is None:
                mark = e.time_range.start
            if e.device_type == DeviceType.CUDA:
                dev.append((e.name, e.time_range.start, e.time_range.end))
        # host seconds -> trace microseconds
        shift = (mark if mark is not None else 0.0) - self.t_mark * 1e6
        lo, hi = t_open * 1e6 + shift, t_close * 1e6 + shift
        ivals = [(max(s, lo), min(e, hi)) for _n, s, e in dev
                 if e > lo and s < hi]
        busy_s = union_length(ivals) / 1e6
        by_name = {}
        for n, s, e in dev:
            by_name.setdefault(n, []).append((e - s) / 1e6)
        roof = {}
        for name, mod in self.roofline.items():
            launches = mod.launches()
            secs, seen = 0.0, True
            for k, n_launch in launches.items():
                durs = [d for kn, ds in by_name.items() if k in kn
                        for d in ds]
                t = mean_times_launches(durs, n_launch)
                if n_launch and t is None:
                    seen = False
                secs += t or 0.0
            roof[name] = dict(bytes=self.costs[name][0],
                              ops=self.costs[name][1], launches=launches,
                              kernel_s=secs if seen and secs > 0 else None)
        stages = {}
        for n, t0, t1 in self.spans:
            if t1 > t_open and t0 < t_close:
                stages[n] = stages.get(n, 0.0) + (t1 - t0)
        return dict(calls=calls, window_s=window_s, busy_s=busy_s,
                    stages=stages, roofline=roof,
                    breakdown=self._breakdown(by_name, ivals, lo, hi,
                                              shift))

    def _breakdown(self, by_name, ivals, lo, hi, shift):
        top = sorted(((n, sum(ds)) for n, ds in by_name.items()),
                     key=lambda kv: -kv[1])[:10]
        spans = [(n, t0 * 1e6 + shift, t1 * 1e6 + shift)
                 for n, t0, t1 in self.spans]
        named = []
        for s, e in sorted(gaps(ivals, lo, hi), key=lambda g: g[0] - g[1])[:10]:
            best, best_ov = "no stage", 0.0
            for n, a, b in spans:
                ov = min(b, e) - max(a, s)
                if ov > best_ov:
                    best, best_ov = n, ov
            named.append([best, (e - s) / 1e6])
        return {"device_ops": [[n[:120], v] for n, v in top],
                "idle_gaps": named}
