"""chip_smoke.py's checks catch wrong kernels, on the CPU.

On the card chip_smoke holds K2 (fused_columns) and K1's f32 entry
(tail_probs) against their plain versions at the deployment shape.  Its
deployment draws put every log tail near 0, where a wrong tail is still
within 1e-4 of the right one; spread_batch spreads the tails over
[-80, -1].  Here the kernels are replaced by wrong variants built from
the plain versions (a tail of 0, a tail at kc + 1, probs or tails
rounded through bf16), and chip_smoke's own check functions must fail
each of them on spread_batch's draws, at 256 columns of full depth.

chip_smoke also holds K1's two kernels to their bodies built by g++
(lofreq_tpu_torch/testing/cuh_shims.py): the f32 entry within 2 f32
ulps of lfq_tail_column with no layout copy, and the screen within 1e-5
of the split column at T = 8, two launches identical.  Here those checks
must fail kernels off by 3 ulps, rounded through bf16, at kc + 1, that
copy, that move tails by 2e-5, flip a mask or drift between launches, and
pass the g++ forms themselves.  The build check must fail a spill in
either K1 kernel.
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
from lofreq_tpu_torch.testing import cuh_shims

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


@pytest.fixture(scope="module")
def k1_host(tmp_path_factory):
    return cuh_shims.build_screen_shim(str(tmp_path_factory.mktemp("k1")))


def _host_tail(host, kc_shift=0):
    def run(p, kc):
        kc = (kc + kc_shift).clamp(1, cp.KMAX).to(torch.int32)
        return torch.from_numpy(cuh_shims.tail_columns(host, p.numpy(),
                                                       kc.numpy()))
    return run


def _as_cp_tail(run, copies=0):
    """A stand-in for ops.cuda_poissbin whose K1 f32 entry is `run`,
    making `copies` layout copies a call."""
    made = [0]

    def tail_probs(p, kc):
        made[0] += copies
        return run(p, kc)

    return types.SimpleNamespace(tail_probs=tail_probs,
                                 layout_copy_count=lambda: made[0])


def _wrong_k1_host(host, kind):
    right = _host_tail(host)
    if kind == "kc+1":
        return _as_cp_tail(_host_tail(host, 1))
    if kind == "copy":
        return _as_cp_tail(right, copies=1)

    def run(p, kc):
        t = right(p, kc)
        if kind == "3ulp":
            for _ in range(3):
                t = torch.nextafter(t, torch.tensor(-np.inf))
            return t
        return t.to(torch.bfloat16).to(torch.float32)
    return _as_cp_tail(run)


@pytest.mark.parametrize("kind", ["3ulp", "bf16", "kc+1", "copy"])
def test_wrong_k1_f32_fails_the_host_check(spread, k1_host, monkeypatch,
                                           kind):
    unf = spread[0]
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    step, _ = entry(device="cpu")
    with pytest.raises(SystemExit):
        cs.k1_f32_vs_host(_wrong_k1_host(k1_host, kind), dc, step, unf,
                          k1_host, "spread")
    # the g++ form itself passes, and so does one 2 ulps off
    right = _as_cp_tail(_host_tail(k1_host))
    assert cs.k1_f32_vs_host(right, dc, step, unf, k1_host, "spread") == 0

    def two_ulps(p, kc):
        t = _host_tail(k1_host)(p, kc)
        return torch.nextafter(torch.nextafter(t, torch.tensor(0.0)),
                               torch.tensor(0.0))
    got = cs.k1_f32_vs_host(_as_cp_tail(two_ulps), dc, step, unf, k1_host,
                            "spread")
    assert got == 2


def test_ulps_counts_float_steps():
    x = np.array([-1.0, -1e-8, 0.0, 1e-30, -85.0], np.float32)
    assert (cs.ulps(x, x) == 0).all()
    y = np.nextafter(np.nextafter(x, np.float32(-np.inf)),
                     np.float32(-np.inf))
    assert (cs.ulps(x, y) == 2).all()
    assert cs.ulps(np.float32(0.0), np.float32(-0.0)) == 0


def _screen_draws(seed=9, B=512, S=128):
    """Seeded codes [B, S] (30% pad), ks 1..24 and thresholds near the
    tails' range, so that masks fall on both sides."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(16, 160, (B, S)).astype(np.uint8)
    codes[rng.random((B, S)) < 0.3] = cp.CODE_PAD
    ks = rng.integers(1, 25, B).astype(np.int32)
    lt = rng.uniform(-12.0, -1.0, B).astype(np.float32)
    return [torch.from_numpy(a) for a in (codes, ks, lt)]


def _host_screen(host, kind="right"):
    calls = [0]

    def screen_codes(codes, ks, lt):
        calls[0] += 1
        k = ks + 1 if kind == "kc+1" else ks
        t, m = cuh_shims.screen_columns(host, codes.numpy(), k.numpy(),
                                        lt.numpy(), 8)
        t, m = torch.from_numpy(t), torch.from_numpy(m)
        if kind == "shift":
            t = t + 2e-5
        elif kind == "mask":
            m = m.clone()
            far = (t - lt).abs() > 1e-3
            i = int(torch.nonzero(far)[0])
            m[i] = ~m[i]
        elif kind == "drift" and calls[0] % 2 == 0:
            t = t.clone()
            t[0] = torch.nextafter(t[0], torch.tensor(0.0))
        return t, m

    return types.SimpleNamespace(screen_codes=screen_codes)


@pytest.mark.parametrize("kind", ["shift", "kc+1", "mask", "drift"])
def test_wrong_screen_fails_the_host_check(k1_host, monkeypatch, kind):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    codes, ks, lt = _screen_draws()
    with pytest.raises(SystemExit):
        cs.screen_vs_host(_host_screen(k1_host, kind), k1_host, codes, ks,
                          lt, "screen")
    assert cs.screen_vs_host(_host_screen(k1_host), k1_host, codes, ks, lt,
                             "screen") == 0.0


@pytest.mark.parametrize("kernel", ["screen_codes_kernel",
                                    "tail_probs_kernel", "fused_call_kernel"])
def test_check_no_spill_fails_a_spilling_or_missing_kernel(kernel):
    def entry_of(name, spill):
        return (f"ptxas info    : Function properties for _ZN12_GLOBAL__N_1"
                f"{len(name)}{name}EPKf\n"
                f"    0 bytes stack frame, {spill} bytes spill stores, "
                f"{spill} bytes spill loads\n"
                f"ptxas info    : Used 64 registers\n")
    clean = "".join(entry_of(n, 0) for n in cs.NO_SPILL)
    cs.check_no_spill(cs.register_use(clean))
    spilling = "".join(entry_of(n, 8 if n == kernel else 0)
                       for n in cs.NO_SPILL)
    with pytest.raises(SystemExit):
        cs.check_no_spill(cs.register_use(spilling))
    missing = "".join(entry_of(n, 0) for n in cs.NO_SPILL if n != kernel)
    with pytest.raises(SystemExit):
        cs.check_no_spill(cs.register_use(missing))


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
