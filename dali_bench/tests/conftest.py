import os
import sys

import pytest

# the port is imported from the src layout, as the repository's tests do
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips without one)")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test (six workers share the box), restored after,
    so that no other test file in the worker inherits it."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
