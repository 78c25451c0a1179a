"""The readers of the port's own spans (metrics/_spans.py) on synthetic
span lists: the calling thread's split, the device BAQ's copy bytes, and
None where the roots do not match the record's calls or spans were
dropped."""

from types import SimpleNamespace

import pytest

from portbench.metrics import (_spans, call_batch_s, call_confirm_wait_s,
                               call_ingest_wait_s, call_output_s, call_own_s,
                               devbaq_copy_mb_per_call)

MS = 1_000_000
CALLER, WORKER = 11, 12


def span(name, sid, parent, t0, t1, thread=CALLER, self_ns=None, **attrs):
    return SimpleNamespace(name=name, id=sid, parent=parent, thread=thread,
                           t0=t0 * MS, t1=t1 * MS, attrs=attrs or None,
                           self_ns=(t1 - t0) * MS if self_ns is None
                           else self_ns * MS)


def one_call(base, root_id):
    """A 100 ms call: waits 30 + 10 ms, batch 20, confirm wait 15,
    filter 5, vcf 3, so 17 ms of the root's own; worker spans, which
    the split leaves out, beside."""
    r = root_id
    return [
        span("ingest_wait", r + 1, r, base + 2, base + 32),
        span("call.batch", r + 2, r, base + 32, base + 52),
        span("prescreen", r + 3, r + 2, base + 33, base + 40),
        span("ingest_wait", r + 4, r, base + 55, base + 65),
        span("confirm_wait", r + 5, r, base + 66, base + 81),
        span("filter", r + 6, r, base + 85, base + 90),
        span("vcf_write", r + 7, r, base + 92, base + 95),
        span("ingest_columns", r + 8, r, base + 1, base + 90, WORKER),
        span("devbaq.h2d", r + 9, r + 8, base + 3, base + 4, WORKER,
             bytes=2_000_000),
        span("devbaq.d2h", r + 10, r + 8, base + 5, base + 9, WORKER,
             bytes=1_000_000),
        span("call", r, None, base, base + 100, self_ns=17),
    ]


SPANS = one_call(0, 100) + one_call(200, 200)
READERS = [(call_ingest_wait_s, 0.040), (call_batch_s, 0.020),
           (call_confirm_wait_s, 0.015), (call_output_s, 0.008),
           (call_own_s, 0.017), (devbaq_copy_mb_per_call, 3.0)]


@pytest.fixture
def window(monkeypatch):
    def use(spans, dropped=0):
        monkeypatch.setattr(_spans, "window", lambda: (spans, dropped))
    return use


@pytest.mark.parametrize("reader,want", READERS,
                         ids=[r.__name__.split(".")[-1] for r, _ in READERS])
def test_reader_on_synthetic_spans(window, reader, want):
    window(SPANS)
    assert reader.read({"calls": 2}) == pytest.approx(want)


def test_five_parts_sum_to_the_root():
    parts = _spans.split(SPANS, 0, 2)
    assert sum(parts.values()) == pytest.approx(0.100)


@pytest.mark.parametrize("calls,dropped", [(1, 0), (3, 0), (0, 0), (2, 1)])
def test_readers_give_none_when_roots_disagree_or_spans_dropped(
        window, calls, dropped):
    window(SPANS, dropped)
    for reader, _want in READERS:
        assert reader.read({"calls": calls}) is None


def test_copy_bytes_read_nothing_without_the_device_baq(window):
    window([s for s in SPANS if not s.name.startswith("devbaq.")])
    assert devbaq_copy_mb_per_call.read({"calls": 2}) is None
    assert call_own_s.read({"calls": 2}) == pytest.approx(0.017)


def test_readers_give_none_for_a_program_without_spans(monkeypatch):
    monkeypatch.setattr(_spans, "window", lambda: None)
    for reader, _want in READERS:
        assert reader.read({"calls": 2}) is None


def test_window_reads_the_port_tracer():
    from lofreq_tpu_torch.core import stagetimer

    stagetimer.reset()
    with stagetimer.traced(), stagetimer.call():
        with stagetimer.stage("call.batch"):
            pass
    spans, dropped = _spans.window()
    assert dropped == 0 and [s.name for s in spans] == ["call.batch", "call"]
    assert _spans.split(spans, dropped, 1)["batch"] >= 0
    stagetimer.reset()


CALL_PARTS = ("call_ingest_wait_s", "call_batch_s", "call_confirm_wait_s",
              "call_output_s", "call_own_s")


@pytest.mark.parametrize("cell", ["ecoli-800x.call", "ecoli-800x.device-baq"])
def test_traced_cpu_run_reports_the_split_and_the_copies(tmp_path, cell):
    """A whole traced run on the CPU: the five parts are read, sum to the
    mean call, and the copy bytes are what the runner's reads reckon
    (3 L + 16 B a read, L = 100, and the reference windows beside)."""
    from bench_small import bench_root

    from lofreq_tpu_torch.ops import device_baq
    from portbench import run as R

    before = device_baq.RUN_STATS["reads"]
    code, res = R.run(cell, 7, 0.3, True, device="cpu",
                      root=bench_root(tmp_path), out=lambda s: None)
    assert code == 0 and res["correct"]
    m, calls = res["metrics"], res["attempted"]
    assert set(CALL_PARTS) <= set(m)
    total = sum(m[k]["value"] for k in CALL_PARTS)
    assert total == pytest.approx(res["device"]["window_s"] / calls, rel=0.02)
    if cell == "ecoli-800x.call":
        assert "devbaq_copy_mb_per_call" not in m
        return
    # the warm call and the window's calls ran the same sample
    reads = (device_baq.RUN_STATS["reads"] - before) * calls / (calls + 1)
    reckoned = reads * (3 * 100 + 16) / 1e6 / calls
    assert m["devbaq_copy_mb_per_call"]["value"] == pytest.approx(
        reckoned, rel=0.01)
