"""chip_smoke.py's column-step checks catch wrong kernels on its spread
batch, on the CPU.

On the card chip_smoke holds K2 (fused_columns) and K1's f32 entry
(tail_probs) against their plain versions at the deployment shape.  Its
deployment draws put every log tail near 0, where a wrong tail is still
within 1e-4 of the right one; spread_batch spreads the tails over
[-80, -1].  Here the kernels are replaced by wrong variants built from
the plain versions (a tail of 0, a tail at kc + 1, probs or tails
rounded through bf16), and chip_smoke's own check functions must fail
each of them on spread_batch's draws, at 256 columns of full depth.
"""

import types

import numpy as np
import pytest
import torch

import chip_smoke as cs
from lofreq_tpu_torch.entry import entry
from lofreq_tpu_torch.ops import cuda_poissbin as cp
from lofreq_tpu_torch.ops import device_call as dc
from lofreq_tpu_torch.ops import fused_call as fc

B, DEPTH = 256, 2016


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spread():
    """(unfused step tensors, packed stream, ref ids, the step's plain
    outputs) of spread_batch on the CPU."""
    batch = cs.spread_batch(B, DEPTH)
    unf = tuple(torch.from_numpy(a) for a in batch)
    packed = torch.from_numpy(fc.pack_columns_np(*batch[:6]))
    ref4 = torch.from_numpy(batch[6].astype(np.int32))
    step, _ = entry(device="cpu")
    with cs.step_dp(dc, cp.tail_torch):
        plain = step(*unf)
    return unf, packed, ref4, plain


def test_spread_batch_reaches_what_the_checks_need(spread):
    unf, _, _, plain = spread
    cs.check_spread(dc, plain, unf[-1], "spread")


def _as_fc(k2):
    """A stand-in for ops.fused_call whose K2 is `k2`, counting launches."""
    launches = [0]

    def fused_columns(*a):
        launches[0] += 1
        return k2(*a)

    return types.SimpleNamespace(
        fused_columns=fused_columns, launch_count=lambda: launches[0],
        fused_column_torch=fc.fused_column_torch)


def _wrong_k2(kind):
    def run(packed, ref4):
        tail, depth, acnt, araw = fc.fused_column_torch(packed, ref4)
        if kind == "zero":
            tail = torch.zeros_like(tail)
        else:
            tail = tail.to(torch.bfloat16).to(torch.float32)
        return tail, depth, acnt, araw
    return run


@pytest.mark.parametrize("kind", ["zero", "bf16"])
def test_wrong_k2_fails_on_spread_batch(spread, monkeypatch, kind):
    _, packed, ref4, _ = spread
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    with pytest.raises(SystemExit):
        cs.fused_vs_plain(_as_fc(_wrong_k2(kind)), packed, ref4, "spread")
    # the right kernel passes the same check
    right = _as_fc(fc.fused_column_torch)
    assert cs.fused_vs_plain(right, packed, ref4, "spread") == 0.0


def _wrong_k1(kind):
    def run(p, kc):
        if kind == "kc+1":
            return cp.tail_torch(p, (kc + 1).clamp(1, cp.KMAX).to(torch.int32))
        if kind == "zero":
            return torch.zeros(p.shape[0])
        return cp.tail_torch(p.to(torch.bfloat16).to(torch.float32), kc)
    return run


@pytest.mark.parametrize("kind", ["kc+1", "zero", "bf16"])
def test_wrong_k1_f32_fails_on_spread_batch(spread, kind):
    unf, _, _, plain = spread
    step, _ = entry(device="cpu")
    with cs.step_dp(dc, _wrong_k1(kind)):
        got = step(*unf)
    with pytest.raises(SystemExit):
        cs.check_step(dc, got, plain, unf[-1], "spread")
    with cs.step_dp(dc, cp.tail_torch):
        right = step(*unf)
    assert cs.check_step(dc, right, plain, unf[-1], "spread") == 0.0


def test_spill_bytes_reads_ptxas_lines():
    """The build check that K2 and K4 do not spill reads ptxas -v."""
    log = ("ptxas info    : Function properties for _ZN12_GLOBAL__N_114"
           "baq_bwd_kernelEPKh\n"
           "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill "
           "loads\n"
           "ptxas info    : Used 188 registers, used 1 barriers\n")
    use = cs.register_use(log)
    assert cs.spill_bytes(use["baq_bwd_kernel"]) == 20
    assert cs.spill_bytes("0 bytes stack frame, 0 bytes spill stores, "
                          "0 bytes spill loads, Used 80 registers") == 0


def test_fused_repeats_fails_a_kernel_that_does_not_repeat(spread,
                                                            monkeypatch):
    """K2 launched twice must agree bit for bit: a kernel whose second
    launch moves one tail by one ulp fails the check."""
    _, packed, ref4, _ = spread
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    calls = [0]

    def drifting(p, r):
        calls[0] += 1
        tail, depth, acnt, araw = fc.fused_column_torch(p, r)
        if calls[0] % 2 == 0:
            tail = tail.clone()
            tail[0] = torch.nextafter(tail[0], torch.tensor(0.0))
        return tail, depth, acnt, araw

    with pytest.raises(SystemExit):
        cs.fused_repeats(_as_fc(drifting), packed, ref4, "spread")
    cs.fused_repeats(_as_fc(fc.fused_column_torch), packed, ref4, "spread")


@pytest.mark.parametrize("seen,reps,ok", [
    (500, 500, True),    # every launch seen
    (296, 300, True),    # the profiler dropped a few records
    (444, 500, True),    # ... or more of them
    (249, 500, False),   # most records missing: no time per launch
    (301, 300, False),   # other launches mixed in
])
def test_per_launch_ms_takes_a_window_missing_launches(seen, reps, ok):
    """The profiler drops records of a timing window; per_launch_ms
    averages over the launches it saw while at least half were seen, and
    fails a window with too few or too many."""
    dev = {"k_kernel(int)": (seen, 17.5 * seen), "other": (1, 3.0)}
    if ok:
        assert cs.per_launch_ms(dev, "k_kernel", reps) == pytest.approx(0.0175)
    else:
        with pytest.raises(SystemExit):
            cs.per_launch_ms(dev, "k_kernel", reps)
