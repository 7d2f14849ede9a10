"""pytest settings of the benchmark's own tests: the ``gpu`` marker."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips (with its reason) elsewhere")
