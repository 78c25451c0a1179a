"""The port never imports JAX: the machine with the CUDA card runs it, and
its `call` path must not depend on the JAX reference's device code."""

import os
import re
import subprocess
import sys

from simulate_fast import simulate_fast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "lofreq_tpu_torch")


def _call_without_jax(tmp_path, flags):
    """A fresh process imports lofreq_tpu_torch, its device-BAQ modules
    included, and runs its CLI `call` with `flags` on a small BAM; no jax
    module is loaded at the end.  Returns (screen dispatches, reads through
    the device-BAQ runner)."""
    art = simulate_fast(str(tmp_path), genome_len=5_000, depth=200, seed=5)
    out = tmp_path / "out.vcf"
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)  # the test workers share the cores\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from lofreq_tpu_torch.cli import main\n"
        "from lofreq_tpu_torch.ops import baq_torch, cuda_baq, device_baq\n"
        f"rc = main(['call', *{flags!r}, '-f', {art['fa']!r}, "
        f"'-o', {str(out)!r}, {art['bam']!r}])\n"
        "from lofreq_tpu_torch.ops.screen import DISPATCH_STATS\n"
        "jax = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib'))\n"
        "print('RC', rc, 'DISPATCHED', DISPATCH_STATS['dispatched'],\n"
        "      'BAQ_READS', device_baq.RUN_STATS['reads'], 'JAX', jax)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("RC 0 DISPATCHED ") and last.endswith("JAX []"), (
        last, proc.stderr)
    assert out.read_text().startswith("##fileformat=VCF")
    words = last.split()
    return int(words[3]), int(words[5])


def test_port_call_imports_no_jax(tmp_path):
    """`call` with the device screen forced on, so the screen layer runs;
    the device-BAQ runner stays off."""
    dispatched, baq_reads = _call_without_jax(tmp_path, ["--device-screen"])
    assert dispatched > 0 and baq_reads == 0


def test_port_call_device_baq_imports_no_jax(tmp_path):
    """`call --device-baq`: the device-BAQ runner and the screen run."""
    dispatched, baq_reads = _call_without_jax(
        tmp_path, ["--device-screen", "--device-baq"])
    assert dispatched > 0 and baq_reads > 0


def test_port_sources_import_no_jax():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 5
    for path in files:
        with open(path) as fh:
            assert not pat.search(fh.read()), path
