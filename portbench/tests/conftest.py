"""The benchmark's own tests. Tests that need a CUDA card are marked
``chip`` and skip here; the decision is made inside the ``cuda_device``
fixture, never while a module is imported."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (run on the chip)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def tiny_spec(tmp_path_factory):
    from portbench.tests import tiny

    return tiny.spec_dir(tmp_path_factory.mktemp("portbench"))
