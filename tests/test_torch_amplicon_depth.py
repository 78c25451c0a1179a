"""Deep amplicon columns through the port's `call`, as the benchmark's
cell `sarscov2-artic-deep.call` drives them, at a size a CPU test holds:
the deployment's amplicon shapes cut to 5,000 bp, 16 amplicons and one
sample at 1,500x, so that amplicons run thousands of reads deep, past
the screen's 128 codes.

The port's default engine (device screen on, its plain torch version on
the CPU) and its host-screen engine give the plain reference's records
and SNV tests exactly, and the records and SNV tests of lofreq_tpu's
`call` on the same BAM.  The confirm's spans: `confirm.reingest` nests in
`confirm`, and the `cells` that `exact_dp` notes are what the numpy DP's
`n_done` gives on the same rows, and the deepest DPs spread their rows
over native threads (the `threads` note).  The benchmark's five readers
of them give per-call values on a hand-made span list and None where
spans were dropped or are missing."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lofreq_tpu.call.caller import VarcallConf as RefConf
from lofreq_tpu.pipelines.call_pipeline import \
    call_and_filter as ref_call_and_filter
from lofreq_tpu_torch.call import caller
from lofreq_tpu_torch.call.caller import VarcallConf
from lofreq_tpu_torch.core import stagetimer
from lofreq_tpu_torch.core.poissbin import pruned_prob_dist_batch_py
from lofreq_tpu_torch.ops import screen
from lofreq_tpu_torch.pipelines.call_pipeline import call_and_filter
from portbench import run as R
from portbench.gen import inputs, simulate as S
from portbench.metrics import (_spans, confirm_reingest_s,
                               exact_dp_cols_per_call,
                               exact_dp_gcells_per_call, exact_dp_s,
                               exact_dp_threaded_pct)
from portbench.reference import lofreq as REF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "sarscov2-artic-deep.call"
SEEDS = [3, 11, 2 ** 31 + 7]
DEPTH = 1500


def deployment() -> dict:
    with open(os.path.join(ROOT, "portbench", "configs",
                           "sarscov2-artic-deep.json")) as fh:
        return json.load(fh)


def small_config() -> dict:
    cfg = deployment()
    cfg.update(genome_length=5000, samples=[{"depth": DEPTH}],
               snvs=[[1.0, 5], [0.05, 3], [0.02, 3]])
    cfg["amplicons"] = dict(cfg["amplicons"], count=16)
    return cfg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def records(path):
    with open(path) as fh:
        return [ln.rstrip("\n") for ln in fh if not ln.startswith("#")]


@pytest.fixture(scope="module", params=SEEDS)
def sample(request, tmp_path_factory):
    """One drawn sample on disk, the plain reference's call of it and
    lofreq_tpu's (host screen and C BAQ: its default path off an
    accelerator)."""
    cfg = small_config()
    reads = inputs.draw(cfg, request.param, 0)
    d = tmp_path_factory.mktemp(f"amplicon{request.param}")
    S.write_sample(str(d), cfg["chrom"], reads, threads=2)
    out = str(d / "lofreq_tpu.vcf")
    res = ref_call_and_filter(str(d / "reads.bam"), str(d / "ref.fa"), out,
                              vconf=RefConf(use_device_screen=False,
                                            use_device_baq=False))
    return dict(dir=d, reads=reads, want=REF.call(reads, cfg["chrom"]),
                jax=(records(out), res.stats.num_snv_tests))


def port_call(d, **conf):
    out = str(d / "out.vcf")
    res = call_and_filter(str(d / "reads.bam"), str(d / "ref.fa"), out,
                          vconf=VarcallConf(device="cpu", **conf))
    return records(out), res.stats.num_snv_tests


@pytest.mark.parametrize("device_screen", [True, False],
                         ids=["device-screen", "host-screen"])
def test_port_gives_the_reference_at_depth(sample, device_screen):
    starts = sample["reads"]["starts"]
    depth = np.bincount((starts[:, None] + np.arange(250)).ravel())
    assert depth.max() > 1000, "no column deeper than the screen's codes"
    before = screen.DISPATCH_STATS["columns"]
    got, got_tests = port_call(sample["dir"],
                               use_device_screen=device_screen)
    want, want_tests = sample["want"]
    assert want, "the reference called nothing: the case proves nothing"
    assert got == want
    assert got_tests == want_tests
    assert (got, got_tests) == sample["jax"]
    screened = screen.DISPATCH_STATS["columns"] - before
    assert (screened > 0) == device_screen


@pytest.fixture(scope="module")
def traced_call(tmp_path_factory):
    """The spans of one traced default call at depth, and the rows each
    native DP of it was given."""
    cfg = small_config()
    d = tmp_path_factory.mktemp("traced")
    S.write_sample(str(d), cfg["chrom"], inputs.draw(cfg, SEEDS[0], 0),
                   threads=2)
    rows, native = [], caller.pruned_prob_dist_batch

    def recording(probs, depths, ks, bonf, sig):
        rows.append((np.array(probs), np.array(depths), np.array(ks),
                     np.array(bonf), sig))
        return native(probs, depths, ks, bonf, sig)

    stagetimer.reset()
    caller.pruned_prob_dist_batch = recording
    try:
        with stagetimer.traced():
            port_call(d)
        spans = stagetimer.spans()
    finally:
        caller.pruned_prob_dist_batch = native
        stagetimer.reset()
    return spans, rows


def test_reingest_nests_under_confirm(traced_call):
    spans, _rows = traced_call
    by_id = {s.id: s for s in spans}
    reingest = [s for s in spans if s.name == "confirm.reingest"]
    assert reingest
    for s in reingest:
        assert by_id[s.parent].name == "confirm"
        assert s.attrs["cols"] > 0
    assert sum(s.name == "ingest.count" and by_id[s.parent].name
               == "confirm.reingest" for s in spans) == len(reingest)


def test_exact_dp_cells_are_the_numpy_dps_n_done(traced_call):
    """Σ over rows of Σ_{n=1..n_done} (min(n, K) + 1), n_done from the
    numpy DP on the rows the native DP was given, row by row."""
    spans, rows = traced_call
    dps = [s for s in spans if s.name == "exact_dp"]
    assert dps and len(dps) == len(rows)
    cells = cols = 0
    for probs, depths, ks, bonf, sig in rows:
        for b in range(len(depths)):
            _, n_done = pruned_prob_dist_batch_py(
                probs[b:b + 1, :depths[b]], depths[b:b + 1], ks[b:b + 1],
                bonf[b:b + 1], sig)
            k = int(ks[b])
            cells += sum(min(n, k) + 1 for n in range(1, int(n_done[0]) + 1))
        cols += len(depths)
    assert sum(s.attrs["cells"] for s in dps) == cells
    assert sum(s.attrs["cols"] for s in dps) == cols
    assert cells > cols * 1000, "no column ran deep into the DP"


def test_traced_call_spreads_the_deepest_dps_over_threads(traced_call):
    """Every `exact_dp` notes the native threads its rows ran on; the DP
    of the AF-1.0 columns, 1,500 reads deep, ran on more than one."""
    spans, _rows = traced_call
    dps = [s for s in spans if s.name == "exact_dp"]
    assert dps and all(s.attrs["threads"] >= 1 for s in dps)
    assert max(s.attrs["threads"] for s in dps) > 1


MS = 1_000_000
CALLER, CONFIRM = 21, 22


def span(name, sid, parent, t0, t1, thread=CONFIRM, **attrs):
    return SimpleNamespace(name=name, id=sid, parent=parent, thread=thread,
                           t0=t0 * MS, t1=t1 * MS, attrs=attrs or None,
                           self_ns=(t1 - t0) * MS)


def one_call(base, r, noted=True):
    """A 500 ms call whose confirm re-ingests for 120 ms and runs two
    DPs of 90 and 150 ms (150 and 50 columns, 0.6 and 0.2 G cells);
    noted=False: the spans as a program without the notes gives them."""
    def notes(**kw):
        return kw if noted else {}
    return [
        span("confirm.reingest", r + 2, r + 1, base + 10, base + 130,
             **notes(cols=4000)),
        span("exact_dp", r + 3, r + 1, base + 140, base + 230,
             **notes(cols=150, cells=600_000_000)),
        span("confirm", r + 1, r, base + 5, base + 240),
        span("exact_dp", r + 5, r + 4, base + 250, base + 400,
             **notes(cols=50, cells=200_000_000)),
        span("confirm", r + 4, r, base + 245, base + 410),
        span("confirm_wait", r + 6, r, base + 20, base + 420, CALLER),
        span("call", r, None, base, base + 500, CALLER),
    ]


SPANS = one_call(0, 100) + one_call(1000, 200)


def record(spans, calls):
    """The traced run's record: its calls and the stage sums, seconds
    summed over threads, that portbench/tracing.py keeps."""
    stages = {}
    for s in spans:
        stages[s.name] = stages.get(s.name, 0.0) + (s.t1 - s.t0) / 1e9
    return {"calls": calls, "stages": stages}
READERS = [(exact_dp_s, 0.240), (confirm_reingest_s, 0.120),
           (exact_dp_cols_per_call, 200), (exact_dp_gcells_per_call, 0.8)]
IDS = [r.__name__.split(".")[-1] for r, _ in READERS]


@pytest.fixture
def window(monkeypatch):
    def use(spans, dropped=0):
        monkeypatch.setattr(_spans, "window",
                            lambda: None if spans is None else (spans, dropped))
    return use


@pytest.mark.parametrize("reader,want", READERS, ids=IDS)
def test_reader_per_call_on_hand_made_spans(window, reader, want):
    window(SPANS)
    assert reader.read(record(SPANS, 2)) == pytest.approx(want)


@pytest.mark.parametrize("reader", [r for r, _ in READERS], ids=IDS)
def test_reader_gives_none_where_spans_were_dropped(window, reader):
    window(SPANS, dropped=3)
    assert reader.read(record(SPANS, 2)) is None
    window(SPANS)
    assert reader.read(record(SPANS, 3)) is None
    window(None)            # a tree without the tracer keeps no spans
    assert reader.read(record(SPANS, 2)) is None


@pytest.mark.parametrize("reader", [confirm_reingest_s,
                                    exact_dp_cols_per_call,
                                    exact_dp_gcells_per_call],
                         ids=IDS[1:])
def test_reader_gives_none_without_the_new_spans_or_notes(window, reader):
    """A program that has `exact_dp` but neither `confirm.reingest` nor
    the notes reads nothing (exact_dp_s still reads its span)."""
    spans = [s for s in one_call(0, 100, noted=False)
             if s.name != "confirm.reingest"]
    window(spans)
    assert reader.read(record(spans, 1)) is None
    assert exact_dp_s.read(record(spans, 1)) == pytest.approx(0.240)


def test_find_cell_finds_the_deep_amplicon_cell():
    bench = R.load_benchmark(ROOT)
    cell, cfg, traffic = R.find_cell(bench, CELL, ROOT)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("sarscov2-artic-deep", "call", 1)
    assert cfg == deployment()
    assert traffic["varcall"] == {}
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    assert entry["reduced"] == list(cfg["reduced"]) == ["samples"]
    with open(os.path.join(ROOT, "portbench", "configs",
                           "sarscov2-cohort.json")) as fh:
        cohort = json.load(fh)
    # one sample, on a rung of the cohort's depth ladder
    assert len(cfg["samples"]) == 1
    assert cfg["samples"][0] in cohort["samples"]
    shapes = set(cohort) - {"deployment", "samples", "reduced", "assumed"}
    assert {k: cfg[k] for k in shapes} == {k: cohort[k] for k in shapes}
    for m in ("exact_dp_s", "confirm_reingest_s", "exact_dp_cols_per_call",
              "exact_dp_gcells_per_call"):
        assert m in [x["name"] for x in R.metrics_of(bench, CELL, True)]


def threaded(spans, threads=(8, 1)):
    """The spans with `threads` noted on each `exact_dp` in turn."""
    out, left = [], list(threads) * len(spans)
    for s in spans:
        if s.name == "exact_dp" and s.attrs:
            s = SimpleNamespace(**vars(s))
            s.attrs = dict(s.attrs, threads=left.pop(0))
        out.append(s)
    return out


@pytest.mark.parametrize("threads,want", [((8, 1), 75.0), ((1, 3), 25.0),
                                          ((2, 2), 100.0), ((1, 1), 0.0)])
def test_threaded_pct_on_hand_made_spans(window, threads, want):
    """0.6 and 0.2 G cells a call, in DPs on the threads given."""
    spans = threaded(SPANS, threads)
    window(spans)
    assert exact_dp_threaded_pct.read(record(spans, 2)) == \
        pytest.approx(want)


def test_threaded_pct_gives_none_without_threads_or_with_dropped_spans(
        window):
    window(SPANS)                       # cells noted, threads not
    assert exact_dp_threaded_pct.read(record(SPANS, 2)) is None
    spans = threaded(SPANS)
    window(spans, dropped=3)
    assert exact_dp_threaded_pct.read(record(spans, 2)) is None
    window(spans)
    assert exact_dp_threaded_pct.read(record(spans, 3)) is None
    window(None)
    assert exact_dp_threaded_pct.read(record(spans, 2)) is None
    bare = one_call(0, 100, noted=False)
    window(bare)
    assert exact_dp_threaded_pct.read(record(bare, 1)) is None


def test_threaded_pct_reads_in_every_cell():
    bench = R.load_benchmark(ROOT)
    for cell in bench["workloads"]:
        names = [m["name"] for m in R.metrics_of(bench, cell["name"], True)]
        assert "exact_dp_threaded_pct" in names, cell["name"]
