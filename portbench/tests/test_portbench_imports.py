"""The harness loads neither JAX nor the JAX package, and refuses to run
without a card."""

import os
import subprocess
import sys

from portbench import run as R


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "lofreq_tpu_torch_fake", object())
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "lofreq_tpu.fake", object())
    assert R.forbidden_modules() == ["lofreq_tpu"]


def test_a_run_and_the_reference_load_no_jax(tmp_path):
    code = (
        "import sys, json\n"
        "sys.path.insert(0, %r)\n"
        "sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(1)\n"
        "from bench_small import bench_root\n"
        "from portbench import run as R\n"
        "rc, res = R.run('ecoli-800x.call', 3, 0.5, False, device='cpu',\n"
        "                root=bench_root(%r), out=lambda s: None)\n"
        "assert rc == 0 and res['correct'], res\n"
        "print(json.dumps(R.forbidden_modules()))\n"
        % (R.ROOT, os.path.dirname(__file__), str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(R.ROOT, "portbench", "run.py"),
         "--workload", "ecoli-800x.call", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=R.ROOT, env=env)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA card" in out.stderr


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(R.ROOT, "portbench", "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            with open(os.path.join(ref, f)) as fh:
                src = fh.read()
            assert "lofreq_tpu" not in src and "jax" not in src, f
