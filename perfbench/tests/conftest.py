"""The harness's own tests: on the CPU at small sizes, and (marked
``cuda``) on the card."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips elsewhere")
