import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

# several test workers share the cores: one intra-op thread each
torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card; skips where torch.cuda.is_available() is "
        "false (on the card: python -m pytest portbench/tests -m gpu)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
