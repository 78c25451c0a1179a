"""The engines of a `call` (lofreq_tpu_torch/call/engines.py): the
sub-screen's device, the device-BAQ runner, the screening pass and the
sweep's BAQ flags, decided once per run from the confs, the BED, the card
and LOFREQ_TPU_DEVICE_SCREEN, without writing into either conf.  The card
is faked and nothing is built: screen_ready and get_runner are recorded."""

import dataclasses

import pytest
import torch

from lofreq_tpu_torch.call import engines as E
from lofreq_tpu_torch.call.caller import VarcallConf
from lofreq_tpu_torch.defaults import BAQ_SCREEN_DELTA
from lofreq_tpu_torch.pileup.engine import PileupConf

BED = object()  # a BED: only its presence matters to the engines
# the engine table: the screen's device (None = the host f64 DP), the
# device BAQ, the screening pass, the sweep's baq_screen_null and
# baq_screen_bias, the sweep's use_baq, and whether a card is used
HOST_SCREEN = (True, True, 0, False)    # screening pass, host no-BAQ sweep
EXACT = (False, False, 0, True)         # no screening pass, exact sweep
DEV_BAQ = (True, False, BAQ_SCREEN_DELTA, True)
CASES = {
    # name: (card, LOFREQ_TPU_DEVICE_SCREEN, vconf, pconf, bed, want)
    "default_card": (True, None, {}, {}, None,
                     ("cuda", False, *HOST_SCREEN, True)),
    "default_no_card": (False, None, {}, {}, None,
                        (None, False, *HOST_SCREEN, False)),
    "env_0": (True, "0", {}, {}, None, (None, False, *HOST_SCREEN, False)),
    "env_off": (True, "off", {}, {}, None,
                (None, False, *HOST_SCREEN, False)),
    "env_empty": (True, "", {}, {}, None,
                  (None, False, *HOST_SCREEN, False)),
    "env_1_device_cpu": (False, "1", {"device": "cpu"}, {}, None,
                         ("cpu", False, *HOST_SCREEN, False)),
    "device_cpu": (True, None, {"device": "cpu"}, {}, None,
                   ("cpu", False, *HOST_SCREEN, False)),
    "no_baq": (True, None, {}, {"use_baq": False}, None,
               ("cuda", False, False, False, 0, False, True)),
    "bed": (True, None, {}, {}, BED, ("cuda", False, *EXACT, True)),
    "joint_quals": (True, None, {"min_jq": 20, "min_alt_jq": 20}, {}, None,
                    ("cuda", False, *EXACT, True)),
    "only_indels": (True, None, {"only_indels": True}, {}, None,
                    ("cuda", False, *EXACT, True)),
    "median_alt_bq": (True, None, {"def_alt_bq": -1}, {}, None,
                      ("cuda", False, *EXACT, True)),
    "device_baq": (True, None, {"use_device_baq": True}, {}, None,
                   ("cuda", True, *DEV_BAQ, True)),
    "device_baq_bed": (True, None, {"use_device_baq": True}, {}, BED,
                       ("cuda", False, *EXACT, True)),
    "device_baq_no_ext_baq": (True, None, {"use_device_baq": True},
                              {"ext_baq": False}, None,
                              ("cuda", True, *DEV_BAQ, True)),
    "device_baq_no_screen": (True, None, {"use_device_screen": False,
                                          "use_device_baq": True}, {}, None,
                             (None, True, *DEV_BAQ, True)),
    "device_baq_cpu": (False, None, {"use_device_baq": True,
                                     "use_device_screen": True,
                                     "device": "cpu"}, {}, None,
                       ("cpu", True, *DEV_BAQ, False)),
}


@pytest.fixture
def built(monkeypatch):
    """What resolve_engines built: the devices screen_ready readied and
    the runners get_runner made, as (ext_baq, device)."""
    got = {"ready": [], "runners": []}
    monkeypatch.setattr(E, "screen_ready", got["ready"].append)

    def runner(ext_baq=True, device="cuda"):
        got["runners"].append((ext_baq, torch.device(device)))
        return got["runners"][-1]

    monkeypatch.setattr(E, "get_runner", runner)
    return got


@pytest.mark.parametrize("name", list(CASES))
def test_resolve_engines(monkeypatch, built, name):
    card, env, vkw, pkw, bed, want = CASES[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    if env is None:
        monkeypatch.delenv("LOFREQ_TPU_DEVICE_SCREEN", raising=False)
    else:
        monkeypatch.setenv("LOFREQ_TPU_DEVICE_SCREEN", env)
    vconf, pconf = VarcallConf(**vkw), PileupConf(**pkw)
    given = (dataclasses.asdict(vconf), dataclasses.asdict(pconf))
    eng = E.resolve_engines(vconf, pconf, bed)
    screen, dev_baq, passes, null, bias, use_baq, on_card = want
    assert eng.screen == (screen and torch.device(screen))
    assert eng.screening_pass is passes
    assert eng.sweep_conf.baq_screen_null is null
    assert eng.sweep_conf.baq_screen_bias == bias
    assert eng.sweep_pconf.use_baq is use_baq
    assert eng.on_card is on_card
    dev = torch.device(vconf.device)
    assert built["runners"] == ([(pconf.ext_baq, dev)] if dev_baq else [])
    assert eng.device_baq == (built["runners"][0] if dev_baq else None)
    assert built["ready"] == ([dev] if screen or dev_baq else [])
    # the sweep's confs differ from the caller's only in the BAQ flags,
    # and the caller's are left as given
    assert dataclasses.replace(eng.sweep_conf, baq_screen_null=False,
                               baq_screen_bias=0) == vconf
    assert dataclasses.replace(eng.sweep_pconf,
                               use_baq=pconf.use_baq) == pconf
    assert (dataclasses.asdict(vconf), dataclasses.asdict(pconf)) == given
    # undecided on the card (call-parallel's parent): the same choice,
    # nothing built
    built["ready"].clear()
    built["runners"].clear()
    dry = E.resolve_engines(vconf, pconf, bed, ready=False)
    assert (dry.screen, dry.screening_pass, dry.on_card) == \
        (eng.screen, eng.screening_pass, eng.on_card)
    assert dry.sweep_conf == eng.sweep_conf
    assert dry.device_baq is None and built == {"ready": [], "runners": []}


def test_device_engine_without_card_raises(monkeypatch, built):
    """A device engine on "cuda" without a card raises when the run
    resolves its engines, naming --device cpu; undecided, it does not."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for vkw in ({"use_device_screen": True},
                {"use_device_screen": False, "use_device_baq": True}):
        with pytest.raises(RuntimeError, match="--device cpu"):
            E.resolve_engines(VarcallConf(**vkw), PileupConf())
        assert E.resolve_engines(VarcallConf(**vkw), PileupConf(),
                                 ready=False).on_card
    assert built == {"ready": [], "runners": []}
