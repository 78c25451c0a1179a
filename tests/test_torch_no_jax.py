"""The port never imports JAX, nor anything of the JAX package lofreq_tpu:
the machine with the CUDA card runs it, and it keeps its own copies of
what it needs."""

import os
import re
import subprocess
import sys

from simulate_fast import simulate_fast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "lofreq_tpu_torch")
# the last line of each fresh process: the jax, jaxlib, lofreq_tpu and
# lofreq_tpu.* modules it loaded (none, for the port)
FOREIGN = (
    "foreign = sorted(m for m in sys.modules\n"
    "                 if m.split('.')[0] in ('jax', 'jaxlib', 'lofreq_tpu'))\n"
)


def _run_fresh(code, cwd):
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(cwd))
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip().splitlines()[-1]


def _call_without_jax(tmp_path, flags):
    """A fresh process imports lofreq_tpu_torch, its device-BAQ modules
    included, and runs its CLI `call` with `flags` and --device cpu on a
    small BAM; no jax, jaxlib or lofreq_tpu module is loaded at the end.
    Returns (screen dispatches, reads through the device-BAQ runner)."""
    art = simulate_fast(str(tmp_path), genome_len=5_000, depth=200, seed=5)
    out = tmp_path / "out.vcf"
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)  # the test workers share the cores\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from lofreq_tpu_torch.cli import main\n"
        "from lofreq_tpu_torch.ops import baq_torch, cuda_baq, device_baq\n"
        f"rc = main(['call', *{flags!r}, '--device', 'cpu', '-f', "
        f"{art['fa']!r}, '-o', {str(out)!r}, {art['bam']!r}])\n"
        "from lofreq_tpu_torch.ops.screen import DISPATCH_STATS\n"
        + FOREIGN +
        "print('RC', rc, 'DISPATCHED', DISPATCH_STATS['dispatched'],\n"
        "      'BAQ_READS', device_baq.RUN_STATS['reads'], 'FOREIGN', "
        "foreign)\n"
    )
    last = _run_fresh(code, tmp_path)
    assert last.startswith("RC 0 DISPATCHED ") and last.endswith(
        "FOREIGN []"), last
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


def test_port_column_step_imports_no_jax(tmp_path):
    """entry(device="cpu") and the fused column step in a fresh process:
    they run, and no jax, jaxlib or lofreq_tpu module is loaded."""
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from lofreq_tpu_torch.entry import entry, _example_batch\n"
        "from lofreq_tpu_torch.ops import fused_call\n"
        "fn, args = entry(device='cpu')\n"
        "n1 = int(fn(*args)['num_tested'])\n"
        "nt4, bq, baq, mq, sq, valid, ref, bonf = _example_batch(64, 40)\n"
        "packed = fused_call.pack_columns_np(nt4, bq, baq, mq, sq, valid)\n"
        "step = fused_call.build_fused_column_call(device='cpu')\n"
        "n2 = int(step(torch.from_numpy(packed),\n"
        "              torch.from_numpy(ref.astype('int32')),\n"
        "              torch.from_numpy(bonf))['num_tested'])\n"
        + FOREIGN +
        "print('TESTED', n1, n2, 'FOREIGN', foreign)\n"
    )
    last = _run_fresh(code, tmp_path)
    words = last.split()
    assert words[0] == "TESTED" and int(words[1]) > 0 and int(words[2]) > 0
    assert last.endswith("FOREIGN []"), last


def test_port_subcommands_import_no_jax(tmp_path):
    """viterbi, vcfset and call-parallel --device cpu (two forked workers
    running the screen's plain version) through the port's CLI in a
    fresh process, with the device Viterbi and somatic imported: no jax,
    jaxlib or lofreq_tpu module is loaded."""
    art = simulate_fast(str(tmp_path), genome_len=5_000, depth=100, seed=5)
    d = str(tmp_path)
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from lofreq_tpu_torch.cli import main\n"
        "from lofreq_tpu_torch.ops import viterbi_torch\n"
        "from lofreq_tpu_torch.pipelines import parallel_call, somatic\n"
        f"fa, bam, d = {art['fa']!r}, {art['bam']!r}, {d!r}\n"
        "rcs = [main(['viterbi', '-f', fa, '-o', d + '/v.bam', bam]),\n"
        "       main(['call-parallel', '--pp-threads', '2', '-f', fa,\n"
        "             '--device-screen', '--device', 'cpu', '-o',\n"
        "             d + '/p.vcf.gz', bam]),\n"
        "       main(['vcfset', '-a', 'intersect', '-1', d + '/p.vcf.gz',\n"
        "             '-2', d + '/p.vcf.gz', '-o', d + '/i.vcf'])]\n"
        "n = parallel_call.PARALLEL_DISPATCH_STATS['dispatched']\n"
        + FOREIGN +
        "print('RCS', rcs, 'DISPATCHED', n, 'FOREIGN', foreign)\n"
    )
    last = _run_fresh(code, tmp_path)
    assert last.startswith("RCS [0, 0, 0] DISPATCHED "), last
    assert int(last.split()[5]) > 0
    assert last.endswith("FOREIGN []"), last
    assert (tmp_path / "v.bam").exists() and (tmp_path / "i.vcf").exists()


def test_port_call_distributed_imports_no_jax(tmp_path):
    """call-distributed (one process, the screen's plain version) through
    the port's CLI and the dry run on two CPU shards in a fresh process:
    no jax, jaxlib or lofreq_tpu module is loaded."""
    art = simulate_fast(str(tmp_path), genome_len=5_000, depth=100, seed=5)
    out = tmp_path / "d.vcf"
    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from lofreq_tpu_torch.cli import main\n"
        "from lofreq_tpu_torch.entry import dryrun_multichip\n"
        "from lofreq_tpu_torch.ops.screen import DISPATCH_STATS\n"
        f"rc = main(['call-distributed', '--device-screen', '--device', "
        f"'cpu', '-f', {art['fa']!r}, '-o', {str(out)!r}, "
        f"{art['bam']!r}])\n"
        "dryrun_multichip(2, device='cpu')\n"
        + FOREIGN +
        "print('RC', rc, 'DISPATCHED', DISPATCH_STATS['dispatched'], "
        "'FOREIGN', foreign)\n"
    )
    last = _run_fresh(code, tmp_path)
    assert last.startswith("RC 0 DISPATCHED ") and last.endswith(
        "FOREIGN []"), last
    assert int(last.split()[3]) > 0
    assert out.read_text().startswith("##fileformat=VCF")


def test_port_sources_import_no_jax():
    """No file of the port, nor chip_smoke.py, imports jax or lofreq_tpu."""
    pats = [re.compile(r"^\s*(import jax|from jax)", re.M),
            re.compile(r"^\s*(import|from)\s+lofreq_tpu(\.|\s|$)", re.M)]
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    for path in files:
        with open(path) as fh:
            src = fh.read()
        for pat in pats:
            assert not pat.search(src), (path, pat.pattern)
    # the second pattern does catch a reference import, and not the port's
    assert pats[1].search("from lofreq_tpu.io import bam")
    assert pats[1].search("import lofreq_tpu")
    assert not pats[1].search("from lofreq_tpu_torch.io import bam")
