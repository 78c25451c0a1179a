"""Which engines a `call` runs, decided once per run.

Three choices: the sub-screen (K1 on the card, its plain PyTorch version
on the CPU, or the host f64 DP), the BAQ the window sweep merges (the
exact C BAQ, none as a per-base lower bound, or the device BAQ deflated
by BAQ_SCREEN_DELTA), and whether the SNVs go through a screening pass
and the exact confirm at all.  run_call resolves them here and passes
them down; nothing writes them into the caller's VarcallConf.  The sweep
(pileup/fast_columns.py) reads its BAQ flags off the conf it is given,
so it gets copies that carry them.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ..defaults import BAQ_SCREEN_DELTA
from ..ops import engine_device
from ..ops.device_baq import get_runner
from ..ops.screen import screen_ready
from ..pileup.fast_columns import supports_fused


@dataclasses.dataclass(frozen=True)
class Engines:
    screen: torch.device | None   # the sub-screen's device; None = host DP
    device_baq: object | None     # the device-BAQ runner
    screening_pass: bool          # screening pass, then the exact confirm
    sweep_conf: object            # the VarcallConf the window sweep reads
    sweep_pconf: object           # the PileupConf the window sweep reads
    on_card: bool                 # a device engine runs on a CUDA card

    def worker_kw(self, vconf_kw: dict) -> dict:
        """A worker's conf fields with the screen resolved here, so that
        no worker asks torch for the card."""
        return dict(vconf_kw, use_device_screen=self.screen is not None)


def device_screen_default() -> bool:
    """True when a CUDA card is present.  LOFREQ_TPU_DEVICE_SCREEN
    overrides it either way, as in the reference."""
    override = os.environ.get("LOFREQ_TPU_DEVICE_SCREEN")
    if override is not None:
        return override not in ("0", "false", "no", "off", "")
    return torch.cuda.is_available()


def resolve_engines(vconf, pconf, bed=None, ready=True) -> Engines:
    """The engines of a call with `vconf` and `pconf` over `bed`.

    The screening pass needs the fused sweep, BAQ in use, SNV tests and
    the default joint-quality filters, so that the tested columns and
    the dynamic-Bonferroni sequence do not depend on the BAQ; and no BED.
    Indel quals never see the screening BAQ: the ingest computes IDAQ
    with the exact C HMM either way.  The device BAQ runs only with an
    explicit use_device_baq (--device-baq), and otherwise the sweep skips
    the BAQ.  ready: build (or load) the kernel library and the runner
    now, raising where they cannot run; False decides without touching
    the card (device_baq then stays None)."""
    screen_on = (device_screen_default() if vconf.use_device_screen is None
                 else bool(vconf.use_device_screen))
    allowed = (bed is None and pconf.use_baq and not vconf.only_indels
               and vconf.min_jq == 0 and vconf.min_alt_jq == 0
               and supports_fused(vconf))
    baq_on = bool(vconf.use_device_baq) and allowed
    dev = torch.device(vconf.device)
    runner = None
    if ready and (screen_on or baq_on):
        dev = engine_device(vconf.device)
        screen_ready(dev)
        if baq_on:
            runner = get_runner(ext_baq=pconf.ext_baq, device=dev)
    sweep_conf = dataclasses.replace(
        vconf, baq_screen_null=allowed and not baq_on,
        baq_screen_bias=BAQ_SCREEN_DELTA if baq_on else 0)
    sweep_pconf = dataclasses.replace(pconf, use_baq=False) \
        if allowed and not baq_on else pconf
    return Engines(screen=dev if screen_on else None, device_baq=runner,
                   screening_pass=allowed, sweep_conf=sweep_conf,
                   sweep_pconf=sweep_pconf,
                   on_card=(screen_on or baq_on) and dev.type == "cuda")
