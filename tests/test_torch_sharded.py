"""The port's sharded column step (lofreq_tpu_torch/ops/device_call.py:
build_sharded_column_call), its multi-card screen split (ops/screen.py:
screen_split and the dispatch that takes it) and its dry run
(entry.py:dryrun_multichip) against the JAX package's sharded step and
screen on the 8-device CPU mesh that tests/conftest.py sets up, on the
CPU: the shards are n CPU devices, each running the plain versions.

Integer outputs, masks and num_tested are held exactly; tails within
test_torch_device_call's TAIL_TOL.  The same step across two Gloo ranks,
started by torch.multiprocessing, all-reduces num_tested to the serial
step's.  The `gpu` case runs the split on [cuda:0, cuda:0] against the
unsplit step, tails bit for bit.
"""

import os
import socket
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from lofreq_tpu.ops import screen as ref_screen
from lofreq_tpu.ops.device_call import \
    build_sharded_column_call as jax_sharded
from lofreq_tpu_torch.entry import _example_batch, _padded, \
    dryrun_checks, dryrun_multichip
from lofreq_tpu_torch.ops import cuda_poissbin as cp
from lofreq_tpu_torch.ops import screen
from lofreq_tpu_torch.ops.device_call import (STEP_KEYS, build_column_call,
                                              build_sharded_column_call)
from test_sharded_screen import _mk_inputs
from test_torch_device_call import TAIL_TOL, assert_step_equal

torch.set_num_threads(1)  # the test workers share the cores

SIG = 0.01
JOIN_S = 180   # the Gloo ranks' wall-clock limit


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("cols",))


def _dryrun_batches(n):
    """The batches of dryrun_multichip: [(name, args, real columns)],
    the padded one padded to a multiple of n."""
    out = [(f"step{step}", _example_batch(B=B, D=D, seed=step), B)
           for step, (B, D) in enumerate(((4096, 512), (16 * n, 128),
                                          (16 * n, 128)))]
    B0 = 16 * n + 7
    Bp = B0 + (-B0) % n
    out.append(("padded", _padded(_example_batch(B=B0, D=96, seed=11), B0,
                                  Bp), B0))
    rng = np.random.default_rng(23)
    B1, D1 = 32 * n, 160
    nt4, bq, baq, mq, sq, valid, ref_nt4, bonf = _example_batch(
        B=B1, D=D1, seed=12)
    nt4 = np.where(rng.random((B1, D1)) < 0.3, 4, nt4).astype(np.int8)
    valid = valid & (rng.random((B1, D1)) < 0.8)
    out.append(("indel", (nt4, bq, baq, mq, sq, valid, ref_nt4, bonf), B1))
    return out


@pytest.fixture(scope="module", params=[2, 8])
def jax_runs(request):
    """(n, [(name, args, real columns, JAX's sharded output as numpy)])
    on the n-device CPU mesh."""
    n = request.param
    fn, _ = jax_sharded(mesh=_mesh(n), use_baq=True)
    runs = []
    for name, args, B0 in _dryrun_batches(n):
        out = fn(*args)
        runs.append((name, args, B0,
                     {k: np.asarray(v) for k, v in out.items()}))
    return n, runs


@pytest.mark.parametrize("batch", ["step0", "step1", "step2", "padded",
                                   "indel"])
def test_sharded_step_matches_jax(jax_runs, batch):
    """build_sharded_column_call on [cpu] * n vs JAX's on the n-device
    mesh, on each batch of the dry run: integer outputs and num_tested
    exact, tails within TAIL_TOL, pad columns untested."""
    n, runs = jax_runs
    name, args, B0, want = next(r for r in runs if r[0] == batch)
    fn, devs = build_sharded_column_call([torch.device("cpu")] * n,
                                         use_baq=True)
    assert len(devs) == n
    got = fn(*(torch.from_numpy(a) for a in args))
    if B0 < len(args[0]):   # the padded batch
        assert not got["tested"][B0:].any() and not want["tested"][B0:].any()
        got = {k: v if k == "num_tested" else v[:B0] for k, v in got.items()}
        want = {k: v if k == "num_tested" else v[:B0]
                for k, v in want.items()}
    assert_step_equal(got, want, SIG, args[-1][:B0])
    assert int(got["num_tested"]) == int(want["num_tested"]) > 0


@pytest.mark.parametrize("n,B", [(8, 5), (3, 100), (1, 64)])
def test_sharded_step_ragged_split(n, B):
    """Fewer columns than shards (empty blocks) and blocks of unequal size
    give the unsharded step's outputs exactly."""
    args = tuple(torch.from_numpy(a) for a in _example_batch(B=B, D=40,
                                                              seed=B))
    fn, _ = build_sharded_column_call(["cpu"] * n, use_baq=True)
    got = fn(*args)
    want = build_column_call(use_baq=True, device="cpu")(*args)
    for k in STEP_KEYS + ("num_tested",):
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k


def _sharded_rank(rank, port, args_path, out_dir):
    """One Gloo rank: its contiguous half of the batch through the sharded
    step on two CPU shards; writes the all-reduced num_tested."""
    import datetime

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    try:
        arrays = np.load(args_path)
        B = arrays["a0"].shape[0]
        lo, hi = (0, B // 2) if rank == 0 else (B // 2, B)
        fn, _ = build_sharded_column_call(["cpu", "cpu"], use_baq=True)
        out = fn(*(torch.from_numpy(arrays[f"a{i}"][lo:hi])
                   for i in range(8)))
        np.save(os.path.join(out_dir, f"rank{rank}.npy"),
                np.array([int(out["num_tested"]),
                          int(out["tested"].sum())]))
    finally:
        dist.destroy_process_group()


def test_sharded_step_across_two_gloo_ranks(tmp_path):
    """Two ranks (torch.multiprocessing, spawn), each with half of the
    indel-shaped batch on two shards: every rank's all-reduced num_tested
    is the serial step's over the whole batch."""
    import torch.multiprocessing as tmp

    args = _dryrun_batches(2)[-1][1]
    args_path = str(tmp_path / "batch.npz")
    np.savez(args_path, **{f"a{i}": a for i, a in enumerate(args)})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = tmp.start_processes(_sharded_rank,
                              args=(port, args_path, str(tmp_path)),
                              nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    try:
        # join returns once a rank ends: True when all have, False while
        # one still runs; it raises if a rank failed
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"the ranks did not finish in {JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
    want = build_column_call(use_baq=True, device="cpu")(
        *(torch.from_numpy(a) for a in args))
    got = [np.load(tmp_path / f"rank{r}.npy") for r in (0, 1)]
    assert got[0][0] == got[1][0] == int(want["num_tested"]) > 0
    assert got[0][1] + got[1][1] == int(want["num_tested"])


@pytest.mark.parametrize("n", [2, 8])
def test_screen_split_matches_jax_sharded_screen(n, monkeypatch):
    """The screen split over [cpu] * n vs JAX's screen sharded over the
    n-device mesh, on tests/test_sharded_screen.py's inputs: the masks
    are equal, directly and through a dispatch that takes the split."""
    probs, depths, ks, bonf = _mk_inputs(seed=3)
    B, D = probs.shape
    s = min(ref_screen._bucket(D), ref_screen.TOP_S)
    in_depth = np.arange(D)[None, :] < depths[:, None]
    arr = np.where((probs <= 1.0) & in_depth, probs, 0.0)
    prefix = np.partition(arr, D - s, axis=1)[:, D - s:]
    with np.errstate(divide="ignore", invalid="ignore"):
        lg = np.ceil(-np.log2(np.maximum(prefix, 1e-300)) * 8.0)
    codes = np.where((prefix <= 0.0) | (prefix > 1.0) | (lg > 254), 255,
                     np.clip(lg, 0, 254)).astype(np.uint8)
    ks32 = np.maximum(ks, 1).astype(np.int32)
    lt = np.log(SIG * ref_screen.MARGIN / bonf).astype(np.float32)
    jax_fn = ref_screen._build_screen_fn(use_pallas=False, mesh=_mesh(n))
    want = np.asarray(jax_fn(codes, np.full(B, s, np.int32), ks32, lt, s=s))
    assert 0 < want.sum() < B
    got = screen.screen_split(codes, ks32, lt, [torch.device("cpu")] * n)
    np.testing.assert_array_equal(got.numpy(), want)

    cpu = torch.device("cpu")
    monkeypatch.setattr(screen, "local_mesh", lambda dev: [cpu] * n)
    before = dict(screen.DISPATCH_STATS)
    handle = screen.screen_dispatch_codes(codes, ks, bonf, SIG, "cpu")
    np.testing.assert_array_equal(screen.screen_fetch(handle), want)
    assert screen.DISPATCH_STATS["dispatched"] == before["dispatched"] + 1
    assert screen.DISPATCH_STATS["columns"] == before["columns"] + B


@pytest.mark.parametrize("n", [1, 2, 8])
def test_dryrun_multichip_cpu(n):
    """The port's dry run on n CPU shards passes, as the JAX package's
    does on its CPU mesh (tests/test_device.py)."""
    dryrun_multichip(n, device="cpu")


def test_dryrun_without_card_raises(monkeypatch):
    """dryrun_multichip on the cards raises on a host without one, and on
    a host with fewer cards than asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dryrun_multichip(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 cards"):
        dryrun_multichip(2)


def test_dryrun_checks_fail_a_wrong_split(monkeypatch):
    """The dry run's checks catch a split that loses the order of its
    blocks."""
    real = screen.screen_split

    def reversed_blocks(codes, ks, lt, devices):
        mask = real(codes, ks, lt, devices)
        half = len(mask) // 2
        return torch.cat([mask[half:], mask[:half]])

    monkeypatch.setattr(screen, "screen_split", reversed_blocks)
    with pytest.raises(AssertionError, match="split screen"):
        dryrun_checks(["cpu", "cpu"])


@pytest.mark.gpu
def test_sharded_step_on_one_card_twice():
    """On the card: the step split over [cuda:0, cuda:0] equals the
    unsplit step, tails bit for bit, and launches K1's f32 entry once per
    shard; the dry run's checks hold there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    dev = torch.device("cuda", 0)
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in _example_batch(B=4096, D=512, seed=0))
    cp.reset_launch_count()
    fn, _ = build_sharded_column_call([dev, dev], use_baq=True)
    got = fn(*args)
    assert cp.launch_count("tail_probs", card=0) == 2
    want = build_column_call(use_baq=True, device="cuda")(*args)
    for k in STEP_KEYS + ("num_tested",):
        assert torch.equal(got[k], want[k]), k
    dryrun_checks([dev, dev])
