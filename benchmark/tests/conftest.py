"""The benchmark's own tests: run with ``python -m pytest benchmark/tests``
from the root of the checkout. Tests that need a card are marked ``gpu``
and decide in their body whether one is there."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips in its body without one")
