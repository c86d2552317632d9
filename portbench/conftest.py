"""pytest settings of the benchmark's own tests: the ``cuda`` marker, and a
fixture that skips a card test where there is no card (decided when the
test runs, never at import)."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where CUDA is absent")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"


@pytest.fixture(autouse=True)
def one_thread():
    """The benchmark's tests compute on toy sizes: one intra-op thread
    each, so that they take no cores from tests that run beside them."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
