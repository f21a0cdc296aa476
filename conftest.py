"""Registers the `cuda` marker: tests that need an NVIDIA GPU (the PyTorch
port's CUDA kernels) and skip, from inside a fixture, where there is none."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the PyTorch port's CUDA "
        "kernels); skips elsewhere")
