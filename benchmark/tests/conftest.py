"""The benchmark's CPU tests run torch on a few threads."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)
