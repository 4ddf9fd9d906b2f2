def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (the CUDA kernels of "
        "repro_torch); skipped where there is none")
