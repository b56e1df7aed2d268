"""The benchmark's own tests: ``python -m pytest mvsbench/tests -q``. Cases
marked ``cuda`` need an NVIDIA card and skip where there is none."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (torch.cuda); skips where there is none")
