"""Pytest settings: registers the ``cuda`` marker."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card of compute capability 9.0 or newer; the "
        "test skips itself elsewhere")
