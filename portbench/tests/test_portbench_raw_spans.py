"""The readers of the window raw fetch's span attributes
(raw_mb_per_call, raw_copy_mb_per_call) on synthetic span lists, and on
the port's own spans of a traced call."""

from types import SimpleNamespace

import pytest

from portbench.metrics import _spans, raw_copy_mb_per_call, raw_mb_per_call

MS = 1_000_000
CALLER, PREFETCH = 11, 13


def span(name, sid, parent, t0, t1, thread=CALLER, **attrs):
    return SimpleNamespace(name=name, id=sid, parent=parent, thread=thread,
                           t0=t0 * MS, t1=t1 * MS, attrs=attrs or None,
                           self_ns=(t1 - t0) * MS)


def one_call(base, r, noted=True):
    """A call whose prefetch thread fetched two windows: 20 MB and 30 MB
    handed out, the second one copied (2 MB) into a fresh buffer
    (4 MB)."""
    a = dict(bytes=20_000_000, copied=0, fresh=0) if noted else {}
    b = dict(bytes=30_000_000, copied=2_000_000, fresh=4_000_000) \
        if noted else {}
    return [
        span("ingest.raw", r + 1, r, base + 1, base + 5, PREFETCH, **a),
        span("ingest.raw", r + 2, r, base + 5, base + 9, PREFETCH, **b),
        span("ingest_wait", r + 3, r, base + 2, base + 30),
        span("call", r, None, base, base + 100),
    ]


SPANS = one_call(0, 100) + one_call(200, 200)
READERS = [(raw_mb_per_call, 50.0), (raw_copy_mb_per_call, 6.0)]
IDS = ["raw_mb_per_call", "raw_copy_mb_per_call"]


@pytest.fixture
def window(monkeypatch):
    def use(spans, dropped=0):
        monkeypatch.setattr(_spans, "window", lambda: (spans, dropped))
    return use


@pytest.mark.parametrize("reader,want", READERS, ids=IDS)
def test_reader_sums_the_noted_bytes_per_call(window, reader, want):
    window(SPANS)
    assert reader.read({"calls": 2}) == pytest.approx(want)


@pytest.mark.parametrize("reader,want", READERS, ids=IDS)
def test_reader_reads_none_without_noted_spans(window, reader, want):
    """A program that records `ingest.raw` without attributes (the
    tracer before the raw fetch noted them), or records none."""
    window(one_call(0, 100, noted=False) + one_call(200, 200, noted=False))
    assert reader.read({"calls": 2}) is None
    window([s for s in SPANS if s.name != "ingest.raw"])
    assert reader.read({"calls": 2}) is None


@pytest.mark.parametrize("calls,dropped", [(1, 0), (3, 0), (0, 0), (2, 1)])
def test_readers_give_none_when_roots_disagree_or_spans_dropped(
        window, calls, dropped):
    window(SPANS, dropped)
    for reader, _want in READERS:
        assert reader.read({"calls": calls}) is None


def test_readers_give_none_for_a_program_without_spans(monkeypatch):
    monkeypatch.setattr(_spans, "window", lambda: None)
    for reader, _want in READERS:
        assert reader.read({"calls": 2}) is None


def test_traced_cpu_run_reports_the_raw_bytes(tmp_path):
    """A whole traced run of the call cell on the CPU: the raw handed out
    per call is the windows' records, read as views, so nothing is
    copied, and after the warm call nothing is allocated."""
    from bench_small import bench_root

    from portbench import run as R

    code, res = R.run("ecoli-800x.call", 7, 0.3, True, device="cpu",
                      root=bench_root(tmp_path), out=lambda s: None)
    assert code == 0 and res["correct"]
    m = res["metrics"]
    assert m["raw_mb_per_call"]["value"] > 0
    assert m["raw_copy_mb_per_call"]["value"] == 0
