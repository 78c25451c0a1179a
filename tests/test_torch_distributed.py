"""The port's multi-process layer (lofreq_tpu_torch/parallel/distributed.py
on torch.distributed, and its `call-distributed` subcommand) against the
reference's (lofreq_tpu/parallel/distributed.py on the JAX runtime), on
the CPU.

The single-process functions are held to the reference's on the same
inputs.  Two ranks run as subprocesses of the port's CLI over Gloo, with
the host engine and with the screen's plain version (--device-screen
--device cpu), and must give the JAX package's single `call`: the
reference's own equivalence (its two-process test is opt-in).  Every
subprocess has a wall-clock limit and is killed on the way out, and every
process group a timeout, so a missing rank fails the test instead of
hanging it.
"""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from lofreq_tpu.cli import main as ref_main
from lofreq_tpu.parallel import distributed as ref_dist
from lofreq_tpu_torch.cli import main as port_main
from lofreq_tpu_torch.ops import screen
from lofreq_tpu_torch.parallel import distributed as port_dist
from lofreq_tpu_torch.pipelines import parallel_call as pc
from simulate import simulate

torch.set_num_threads(1)  # the test workers share the cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_WALL_S = 240      # each rank subprocess's wall-clock limit
GROUP_TIMEOUT_S = "60"   # each process group's timeout (joining included)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _records(path):
    """A VCF's lines but the ## header lines, which name the run."""
    with open(path) as fh:
        return [ln for ln in fh if not ln.startswith("##")]


def _run_ranks(argv_of, n, tmp_path, timeout_s=RANK_WALL_S, env=None):
    """Start ranks 0..n-1 of the port's CLI (argv_of(rank)) through
    lofreq_tpu_torch.testing.rank_harness, each with a wall-clock limit;
    kill every one still running on the way out.  Returns [(returncode,
    stderr, the rank's run_distributed_call dict or None)]."""
    env = {**os.environ, "PYTHONPATH": REPO, "LOFREQ_NATIVE_THREADS": "1",
           "LOFREQ_TPU_DIST_TIMEOUT": GROUP_TIMEOUT_S, **(env or {})}
    infos = [tmp_path / f"rank{r}.json" for r in range(n)]
    procs = []
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "lofreq_tpu_torch.testing.rank_harness",
                 str(infos[r]), *argv_of(r)],
                env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True))
        results = []
        for p, info in zip(procs, infos):
            _, err = p.communicate(timeout=timeout_s)
            results.append((p.returncode, err, json.loads(info.read_text())
                            if info.exists() else None))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


@pytest.mark.parametrize("case", [
    "allreduce",
    "bins7_n2_id0", "bins7_n2_id1", "bins7_n3_id2", "bins1_n4_id3",
    "bins10_n1_id0", "bins0_n2_id0",
])
def test_counters_and_assignment_match_reference(case):
    """allreduce_counters for one process, and host_region_assignment on
    several (bins, n, id), against the reference's."""
    if case == "allreduce":
        counts = {"snv": 123, "indel": 7, "zero": 0}
        assert (port_dist.allreduce_counters(counts)
                == ref_dist.allreduce_counters(counts) == counts)
        return
    nb, n, pid = (int(w[len(p):]) for w, p in
                  zip(case.split("_"), ("bins", "n", "id")))
    bins = [("c", i * 10, (i + 1) * 10) for i in range(nb)]
    got = port_dist.host_region_assignment(bins, n, pid)
    assert got == ref_dist.host_region_assignment(bins, n, pid)
    assert got == sorted(got, key=lambda b: b[1])


def test_run_distributed_call_single_process_matches_reference(tmp_path):
    """tests/test_distributed.py's input: the shard's lines and the test
    counts equal the JAX function's; the dict carries the process's
    dispatches and its set-up time."""
    sim = simulate(str(tmp_path), genome_len=2000, depth=200, seed=9,
                   snvs=((0.5, 2),))
    vk = dict(use_baq=False, use_idaq=False)
    pk = dict(use_baq=False, use_idaq=False, collect_indels=False)
    want = ref_dist.run_distributed_call(sim["bam"], sim["fa"], vk, pk,
                                         str(tmp_path / "ref"))
    pc.reset_parallel_stats()
    got = port_dist.run_distributed_call(
        sim["bam"], sim["fa"], dict(vk, device="cpu"), pk,
        str(tmp_path / "port"))
    with open(want["shard"]) as a, open(got["shard"]) as b:
        want_lines, got_lines = a.read().splitlines(), b.read().splitlines()
    assert got_lines == want_lines and got_lines
    for k in ("num_snv_tests", "num_indel_tests", "n_local_vars"):
        assert got[k] == want[k], k
    assert got["counts"] == pc.PARALLEL_DISPATCH_STATS
    assert got["ready_at"] is not None


def test_call_distributed_single_process_matches_reference(tmp_path):
    """call-distributed for one process through the port's CLI: the JAX
    CLI's call-distributed output and the port's own call."""
    sim = simulate(str(tmp_path), genome_len=3000, depth=200, seed=31)
    outs = {}
    for name, main, cmd in (("ref", ref_main, "call-distributed"),
                            ("port", port_main, "call-distributed"),
                            ("call", port_main, "call")):
        outs[name] = str(tmp_path / f"{name}.vcf")
        assert main([cmd, "-f", sim["fa"], "-o", outs[name],
                     sim["bam"]]) == 0
    port = [ln for ln in _records(outs["port"]) if not ln.startswith("#")]
    assert port and port == [ln for ln in _records(outs["ref"])
                             if not ln.startswith("#")]
    assert port == [ln for ln in _records(outs["call"])
                    if not ln.startswith("#")]
    assert not [n for n in os.listdir(tmp_path) if ".tmp.shard" in n]


@pytest.fixture(scope="module")
def sim8(tmp_path_factory):
    """tests/test_distributed.py's two-process input, and the JAX
    package's single call on it."""
    tmp = tmp_path_factory.mktemp("dist8")
    sim = simulate(str(tmp), genome_len=4000, depth=200, seed=8)
    single = str(tmp / "single.vcf")
    assert ref_main(["call", "-f", sim["fa"], "-o", single, "-B", "-A",
                     sim["bam"]]) == 0
    return sim, _records(single)


@pytest.mark.parametrize("flags", [[], ["--device-screen", "--device",
                                        "cpu"]])
def test_call_distributed_two_gloo_ranks(sim8, tmp_path, flags):
    """Two ranks over Gloo on the CPU: the JAX package's single call, and
    the global test counts on rank 0; each rank exits 0 within its
    limit."""
    sim, want = sim8
    out = str(tmp_path / "d2.vcf")
    port = _free_port()
    res = _run_ranks(lambda r: [
        "call-distributed", "--num-processes", "2", "--process-id", str(r),
        "--coordinator", f"127.0.0.1:{port}", "-f", sim["fa"], "-o", out,
        "-B", "-A", *flags, sim["bam"]], 2, tmp_path)
    assert [rc for rc, _, _ in res] == [0, 0], [e[-2000:] for _, e, _ in res]
    assert _records(out) == want and len(want) > 1
    infos = [info for _, _, info in res]
    assert [i["rank"] for i in infos] == [0, 1]
    n_snv = infos[0]["num_snv_tests"]
    assert n_snv > 0 and infos[1]["num_snv_tests"] == n_snv
    assert f"substitution tests performed: {n_snv}" in res[0][1]
    assert sum(i["n_local_vars"] for i in infos) >= len(want) - 1
    # the screen's plain version ran in each rank, or in none; no kernel
    dispatched = [i["counts"]["dispatched"] for i in infos]
    assert (min(dispatched) > 0) == bool(flags) and (max(dispatched) > 0) \
        == bool(flags)
    assert all(i["counts"]["screen_codes"] == 0 for i in infos)
    assert not [n for n in os.listdir(tmp_path) if ".tmp.shard" in n]


@pytest.mark.parametrize("alone", [0, 1])
def test_a_missing_rank_fails_the_run(sim8, tmp_path, alone):
    """One rank of two, started alone, fails within the process group's
    timeout instead of waiting for the other."""
    sim, _ = sim8
    port = _free_port()
    res = _run_ranks(lambda r: [
        "call-distributed", "--num-processes", "2", "--process-id",
        str(alone), "--coordinator", f"127.0.0.1:{port}", "-f", sim["fa"],
        "-o", str(tmp_path / "x.vcf"), "-B", "-A", sim["bam"]], 1,
        tmp_path, timeout_s=120, env={"LOFREQ_TPU_DIST_TIMEOUT": "5"})
    rc, err, info = res[0]
    assert rc not in (0, None) and info is None, err[-2000:]
    assert not (tmp_path / "x.vcf").exists()


def test_device_screen_without_card_raises(sim8, tmp_path, monkeypatch):
    """call-distributed --device-screen on a host without a card raises,
    naming --device cpu, before it joins or calls anything: no
    dispatch, no shard, no output."""
    sim, _ = sim8
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = dict(screen.DISPATCH_STATS)
    out = tmp_path / "x.vcf"
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_main(["call-distributed", "--device-screen", "-f", sim["fa"],
                   "-o", str(out), sim["bam"]])
    assert screen.DISPATCH_STATS == before
    assert os.listdir(tmp_path) == []
    assert not (dist.is_available() and dist.is_initialized())


@pytest.mark.parametrize("cards,ranks,want_devs,want_backend", [
    (1, 2, ["cuda:0", "cuda:0"], "gloo"),
    (2, 2, ["cuda:0", "cuda:1"], "cpu:gloo,cuda:nccl"),
    (4, 2, ["cuda:0", "cuda:1"], "cpu:gloo,cuda:nccl"),
    (2, 4, ["cuda:0", "cuda:1", "cuda:0", "cuda:1"], "gloo"),
])
def test_rank_cards_and_backend(monkeypatch, cards, ranks, want_devs,
                                want_backend):
    """The mapping of ranks to cards and the backend rule, on a faked
    host of `cards` cards: NCCL exactly when each rank has a card of its
    own; an indexed card or the CPU is kept, on Gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    assert [str(port_dist.rank_device("cuda", r))
            for r in range(ranks)] == want_devs
    assert port_dist.backend_for("cuda", ranks) == want_backend
    for dev in ("cuda:1", "cpu"):
        assert port_dist.backend_for(dev, ranks) == "gloo"
        assert port_dist.rank_device(dev, ranks - 1) == torch.device(dev)


@pytest.mark.parametrize("cards,want", [(1, 1), (2, 2), (3, 2), (4, 4),
                                        (7, 4), (8, 8)])
def test_local_mesh(monkeypatch, cards, want):
    """The cards a process drives: the largest power of two not above the
    count, as the reference's screen mesh; an indexed card or the CPU
    alone."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert port_dist.local_mesh("cuda") == [torch.device("cuda", i)
                                            for i in range(want)]
    assert port_dist.local_mesh("cuda:1") == [torch.device("cuda", 1)]
    assert port_dist.local_mesh("cpu") == [torch.device("cpu")]
    mesh = port_dist.global_mesh("cuda")
    assert (mesh.rank, mesh.world_size, len(mesh.local)) == (0, 1, want)


def test_initialize_single_process_and_bad_arguments(monkeypatch):
    """One process is a no-op, as in the reference (also by
    LOFREQ_TPU_NUM_PROCESSES); several need a coordinator and a
    process id in range."""
    assert port_dist.initialize() is False
    monkeypatch.setenv("LOFREQ_TPU_NUM_PROCESSES", "1")
    assert port_dist.initialize("127.0.0.1:1", None, 0) is False
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="--coordinator"):
        port_dist.initialize(None, 2, 0)
    with pytest.raises(ValueError, match="--process-id"):
        port_dist.initialize("127.0.0.1:1", 2, 2)
    monkeypatch.setenv("LOFREQ_TPU_DIST_TIMEOUT", "7")
    assert port_dist.timeout().total_seconds() == 7.0


@pytest.mark.parametrize("n_cols,n_blocks", [(0, 2), (5, 8), (100, 3),
                                             (4096, 4), (39, 2)])
def test_column_blocks(n_cols, n_blocks):
    """Contiguous blocks in column order that cover every column once,
    their sizes within one of each other."""
    blocks = port_dist.column_blocks(n_cols, n_blocks)
    assert len(blocks) == n_blocks
    assert [c for lo, hi in blocks for c in range(lo, hi)] == list(
        range(n_cols))
    sizes = [hi - lo for lo, hi in blocks]
    assert max(sizes) - min(sizes) <= 1
