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
