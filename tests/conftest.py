"""Shared pytest config. NOTE: no XLA_FLAGS here — tests see 1 CPU device."""

import pytest


def pytest_addoption(parser):
    parser.addoption(
        "--update-golden", action="store_true", default=False,
        help="regenerate the pinned golden files under tests/golden/ "
             "from the current engines instead of comparing against them")


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running CPU test")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card and nvcc; skips without them")


@pytest.fixture
def update_golden(request) -> bool:
    return request.config.getoption("--update-golden")
