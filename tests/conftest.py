"""Shared pytest configuration for the suite."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: spawns a subprocess / long wall-clock (kept in tier-1, but "
        "deselectable with -m 'not slow')")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the port's hand-written kernels); "
        "skips with a reason on a host without one")
