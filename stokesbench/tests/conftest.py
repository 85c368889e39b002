"""The benchmark's own tests: on the CPU at small sizes, the card-only ones
marked `cuda` (they skip inside the test where there is no card)."""

import torch

torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")
