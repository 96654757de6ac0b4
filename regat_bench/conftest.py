"""pytest settings of the benchmark's own tests (`pytest regat_bench/`): the
one marker of the tests that need a CUDA card, which skip elsewhere with a
reason (each test decides inside itself, never at import)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
