import pytest
import torch


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); run on the card with "
                    "python -m pytest portbench/tests -m card")
    return "cuda"


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

