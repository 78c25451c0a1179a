"""The port's tracer (lofreq_tpu_torch/core/stagetimer.py): wall sums per
stage, always and exact under threads; spans with call ids, parents,
self time, thread CPU and attributes while tracing; the profiler's
timeline; and the spans of a whole `call_and_filter` on a small
simulated BAM, the device BAQ's copies among them."""

import collections
import inspect
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lofreq_tpu_torch import cli as port_cli
from lofreq_tpu_torch.call.caller import VarcallConf
from lofreq_tpu_torch.core import stagetimer
from lofreq_tpu_torch.ops import device_baq
from lofreq_tpu_torch.pipelines.call_pipeline import call_and_filter, run_call
from lofreq_tpu_torch.testing.simulate_fast import simulate_fast

# the calling thread's five parts: names of the root's children there
CALLER_PARTS = {"ingest_wait", "call.batch", "confirm_wait", "filter",
                "vcf_write"}


@pytest.fixture(autouse=True)
def _clean_tracer():
    stagetimer.reset()
    yield
    stagetimer.reset()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _by_name(spans):
    out = collections.defaultdict(list)
    for s in spans:
        out[s.name].append(s)
    return out


def test_stages_nest_and_self_time_leaves_out_children():
    with stagetimer.traced():
        with stagetimer.stage("t.outer"):
            time.sleep(0.002)
            with stagetimer.stage("t.inner"):
                time.sleep(0.003)
            with stagetimer.stage("t.inner"):
                time.sleep(0.001)
    sp = _by_name(stagetimer.spans())
    (outer,) = sp["t.outer"]
    inner = sp["t.inner"]
    assert [s.parent for s in inner] == [outer.id, outer.id]
    assert outer.parent is None and outer.call is None
    children = sum(s.t1 - s.t0 for s in inner)
    assert outer.self_ns == outer.t1 - outer.t0 - children
    assert all(s.self_ns == s.t1 - s.t0 for s in inner)
    assert outer.self_ns >= 2_000_000
    assert {s.thread for s in inner + [outer]} == {threading.get_native_id()}
    assert stagetimer.times["t.inner"] == pytest.approx(children / 1e9)


def test_tracing_off_records_no_spans_and_the_sums_still_come_out():
    assert not stagetimer.tracing()
    with stagetimer.call():
        with stagetimer.stage("t.off"):
            stagetimer.note(bytes=1)
            time.sleep(0.001)
    assert stagetimer.spans() == [] and stagetimer.dropped() == 0
    assert stagetimer.times["t.off"] >= 0.001
    assert stagetimer.times["call"] >= stagetimer.times["t.off"]
    assert set(stagetimer.report()) == {"call", "t.off"}


def test_a_profiler_turns_tracing_on():
    with profile(activities=[ProfilerActivity.CPU]):
        assert stagetimer.tracing()
        with stagetimer.stage("t.on"):
            pass
    with stagetimer.stage("t.after"):
        pass
    assert [s.name for s in stagetimer.spans()] == ["t.on"]
    assert set(stagetimer.times) == {"t.on", "t.after"}


def _check_on_timeline(prof, spans):
    """Every span has a profiler range of its name which, mapped through
    the anchor, lies within the span to 100 us; and the ranges start
    where their spans do, to a median of 50 us.  (The range opens just
    after the span's clock is read; now and then the profiler stamps it
    a millisecond late.)"""
    import statistics

    events = list(prof.events())
    (anchor,) = [e for e in events if e.name == stagetimer.ANCHOR]
    shift_us = anchor.time_range.start - stagetimer.anchor_ns() / 1e3
    assert spans
    errs = []
    for sp in spans:
        t0, t1 = sp.t0 / 1e3 + shift_us, sp.t1 / 1e3 + shift_us
        inside = [e.time_range.start - t0 for e in events
                  if e.name == sp.name and e.time_range.start >= t0 - 100
                  and e.time_range.end <= t1 + 100]
        assert inside, sp
        errs.append(min(inside, key=abs))
    assert statistics.median(abs(e) for e in errs) < 50.0, errs


def test_spans_sit_on_the_profiler_timeline_on_the_calling_thread():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with stagetimer.stage("t.outer"):
                with stagetimer.stage("t.inner"):
                    time.sleep(0.001)
    spans = stagetimer.spans()
    assert len(spans) == 10
    _check_on_timeline(prof, spans)


def test_spans_of_other_threads_sit_on_the_timeline_when_all_are_profiled():
    """torch.profiler records ranges that other threads open only with
    profile_all_threads (as `call --profile` asks); then every thread's
    spans are on the timeline too."""
    from torch._C._profiler import _ExperimentalConfig

    def work():
        for _ in range(3):
            with stagetimer.stage("t.worker"):
                time.sleep(0.001)

    cfg = _ExperimentalConfig(profile_all_threads=True)
    ts = [threading.Thread(target=work) for _ in range(2)]
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=cfg) as prof:
        with stagetimer.stage("t.main"):
            # one at a time: a thread that waits for the interpreter lock
            # between a span's start and its range's would widen the gap
            for t in ts:
                t.start()
                t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    spans = stagetimer.spans()
    assert len({s.thread for s in spans}) == 3
    _check_on_timeline(prof, spans)


def test_sums_are_exact_with_six_threads():
    """6 threads x 10,000 stages of exactly one second each (a fake
    clock, one per thread), with the interpreter switching threads as
    often as it can: no update is lost."""
    local = threading.local()

    def clock():
        local.t = getattr(local, "t", 0) + 1_000_000_000
        return local.t

    def work():
        for _ in range(10_000):
            with stagetimer.stage("t.exact"):
                pass

    orig_now, orig_switch = stagetimer._now, sys.getswitchinterval()
    stagetimer._now = clock
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        stagetimer._now = orig_now
        sys.setswitchinterval(orig_switch)
    assert not any(t.is_alive() for t in ts)
    assert stagetimer.times["t.exact"] == 60_000.0


def test_note_goes_to_the_innermost_open_span():
    with stagetimer.traced():
        with stagetimer.stage("t.outer"):
            with stagetimer.stage("t.inner"):
                stagetimer.note(bytes=5)
                stagetimer.note(reads=2)
            stagetimer.note(bytes=7)
    sp = _by_name(stagetimer.spans())
    assert sp["t.inner"][0].attrs == {"bytes": 5, "reads": 2}
    assert sp["t.outer"][0].attrs == {"bytes": 7}


def test_call_opens_one_root_with_a_new_id():
    with stagetimer.traced():
        for _ in range(2):
            with stagetimer.call():
                with stagetimer.call():     # run_call inside call_and_filter
                    with stagetimer.stage("t.body"):
                        pass
    sp = _by_name(stagetimer.spans())
    roots, bodies = sp["call"], sp["t.body"]
    assert len(roots) == 2 and all(r.parent is None for r in roots)
    assert roots[0].call < roots[1].call
    assert [b.parent for b in bodies] == [r.id for r in roots]
    assert [b.call for b in bodies] == [r.call for r in roots]


def test_the_span_list_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(stagetimer, "MAX_SPANS", 3)
    with stagetimer.traced():
        for _ in range(5):
            with stagetimer.stage("t.many"):
                pass
    assert len(stagetimer.spans()) == 3 and stagetimer.dropped() == 2
    assert stagetimer.times["t.many"] > 0
    stagetimer.reset()
    assert stagetimer.spans() == [] and stagetimer.dropped() == 0
    assert stagetimer.anchor_ns() is None


def test_thread_cpu_counts_work_and_not_sleep():
    with stagetimer.traced():
        with stagetimer.stage("t.sleep"):
            time.sleep(0.02)
        with stagetimer.stage("t.spin"):
            c_end = time.thread_time_ns() + 20_000_000
            while time.thread_time_ns() < c_end:
                pass
    sp = _by_name(stagetimer.spans())
    sleep, spin = sp["t.sleep"][0], sp["t.spin"][0]
    assert sleep.cpu_ns < 5_000_000
    assert 20_000_000 <= spin.cpu_ns <= spin.t1 - spin.t0 + 1_000_000


def test_the_api_its_readers_use():
    """cli --verbose and chip_smoke read report(); native_ingest and
    portbench's wrapper call stage(name) with one positional argument;
    `counts` had no reader and is gone."""
    assert list(inspect.signature(stagetimer.stage).parameters) == ["name"]
    assert not hasattr(stagetimer, "counts")
    with stagetimer.stage("t.api"):
        pass
    assert set(stagetimer.report()) == {"t.api"}
    assert isinstance(stagetimer.times["t.api"], float)


def test_stage_still_takes_the_benchmark_wrapper():
    """portbench/tracing.py replaces stagetimer.stage by a wrapper that
    opens the original inside its own span; both record."""
    from portbench.tracing import Tracer

    tracer = Tracer({})
    tracer.install()
    try:
        with stagetimer.traced():
            with stagetimer.call():
                with stagetimer.stage("t.wrapped"):
                    pass
    finally:
        tracer.uninstall()
    assert [n for n, _t0, _t1 in tracer.spans] == ["t.wrapped"]
    assert [s.name for s in stagetimer.spans()] == ["t.wrapped", "call"]
    assert stagetimer.stage.__module__ == stagetimer.__name__


# -- a whole call on a small simulated BAM --------------------------------

@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    # three 12.5 kb windows, so window builds, prefetches and confirms
    # overlap on their threads
    return simulate_fast(str(tmp_path_factory.mktemp("trace")),
                         genome_len=30_000, depth=150, seed=5)


def _traced_call(sim, out, **vkw):
    stagetimer.reset()
    with stagetimer.traced():
        res = call_and_filter(sim["bam"], sim["fa"], str(out),
                              vconf=VarcallConf(use_device_screen=True,
                                                device="cpu", **vkw))
    return res, stagetimer.spans()


@pytest.fixture(scope="module")
def call_spans(sim, tmp_path_factory):
    res, spans = _traced_call(sim, tmp_path_factory.mktemp("o") / "o.vcf")
    assert res.stats.num_snv_tests > 0 and len(res.vars) > 0
    stagetimer.reset()
    return spans


def test_call_ids_reach_the_workers_the_prefetcher_and_the_confirms(
        call_spans):
    sp = _by_name(call_spans)
    (root,) = sp["call"]
    assert all(s.call == root.call for s in call_spans)
    for name in ("ingest.raw", "ingest_columns", "confirm"):
        assert sp[name], name
        for s in sp[name]:
            # the first span a worker thread opens for the call hangs
            # under the call's root
            assert s.thread != root.thread and s.parent == root.id, s
    threads = {n: {s.thread for s in sp[n]}
               for n in ("ingest.raw", "ingest_columns", "confirm")}
    assert len(threads["ingest.raw"]) == 1
    assert not threads["ingest.raw"] & threads["ingest_columns"]
    assert not threads["confirm"] & (threads["ingest_columns"]
                                     | threads["ingest.raw"])


def test_five_parts_of_the_calling_thread_sum_to_the_root(call_spans):
    (root,) = [s for s in call_spans if s.name == "call"]
    kids = [s for s in call_spans
            if s.parent == root.id and s.thread == root.thread]
    assert {s.name for s in kids} == CALLER_PARTS
    parts = sum(s.t1 - s.t0 for s in kids) + root.self_ns
    assert parts == pytest.approx(root.t1 - root.t0, rel=0.01)


# stage -> the stage it nests in (None: the call's root)
NESTING = {"ingest.raw": "call", "ingest_columns": "call",
           "ingest.columns": "ingest_columns", "ingest_wait": "call",
           "call.batch": "call", "confirm_wait": "call", "confirm": "call",
           "exact_dp": "confirm", "filter": "call", "vcf_write": "call",
           "call": None}


@pytest.mark.parametrize("name", list(NESTING))
def test_stage_names_and_their_nesting(call_spans, name):
    ids = {s.id: s.name for s in call_spans}
    sp = _by_name(call_spans)[name]
    assert sp, name
    assert {ids.get(s.parent) for s in sp} == {NESTING[name]}


def test_run_call_alone_is_one_call(sim):
    with stagetimer.traced():
        run_call(sim["bam"], sim["fa"],
                 vconf=VarcallConf(use_device_screen=True, device="cpu"))
    roots = [s for s in stagetimer.spans() if s.name == "call"]
    assert len(roots) == 1
    assert {s.call for s in stagetimer.spans()} == {roots[0].call}


def test_device_baq_copies_carry_their_bytes(tmp_path):
    """The runner's devbaq.h2d and devbaq.d2h spans nest in
    ingest.device_baq, and their bytes are 2 L + 16 B a read and the
    reference window in, L B a read out."""
    sim = simulate_fast(str(tmp_path), genome_len=8_000, depth=60, seed=7)
    before = device_baq.RUN_STATS["reads"]
    res, spans = _traced_call(sim, tmp_path / "o.vcf", use_device_baq=True)
    reads = device_baq.RUN_STATS["reads"] - before
    assert reads > 0
    sp = _by_name(spans)
    ids = {s.id: s.name for s in spans}
    for name in ("devbaq.h2d", "devbaq.d2h"):
        assert {ids[s.parent] for s in sp[name]} == {"ingest.device_baq"}
    for name in ("ingest.extract", "ingest.device_baq"):
        assert {ids[s.parent] for s in sp[name]} == {"ingest_columns"}
    d2h = sum(s.attrs["bytes"] for s in sp["devbaq.d2h"])
    h2d = sum(s.attrs["bytes"] for s in sp["devbaq.h2d"])
    assert d2h == reads * 100
    ref_windows = h2d - reads * (2 * 100 + 16)
    assert 0 < ref_windows < len(sp["devbaq.h2d"]) * (12_500 + 2 * 200)


def test_cli_profile_trace_carries_the_spans_with_call_ids(sim, tmp_path):
    """`call --profile DIR`: the profiler's trace holds the spans'
    ranges by name and one event per span with its call id, on the
    same timeline as the anchor."""
    import json

    prof = tmp_path / "prof"
    rc = port_cli.main(["call", "-f", sim["fa"], "-o",
                        str(tmp_path / "o.vcf"), "--device-screen",
                        "--device=cpu", "--profile", str(prof), sim["bam"]])
    assert rc == 0
    (path,) = [p for p in prof.iterdir() if p.name.endswith(".json")]
    events = json.loads(path.read_text())["traceEvents"]
    ours = [e for e in events if e.get("cat") == "stagetimer"]
    names = {e["name"] for e in ours}
    assert {"call", "ingest_wait", "confirm", "ingest_columns"} <= names
    (root,) = [e for e in ours if e["name"] == "call"]
    assert {e["args"]["call"] for e in ours} == {root["args"]["call"]}
    assert all(root["ts"] <= e["ts"] <= root["ts"] + root["dur"]
               for e in ours)
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"call", "ingest_wait", stagetimer.ANCHOR} <= ranges
