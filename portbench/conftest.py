"""The benchmark's own tests: ``python -m pytest portbench -q`` from the
root of a checkout.  Tests marked ``card`` need a CUDA card and skip
without one (the check is made in the fixture, never at import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.cuda.get_device_name(0)
