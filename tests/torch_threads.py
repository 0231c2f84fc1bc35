"""The port's test files pin torch to one thread with this fixture
(``from torch_threads import _one_torch_thread  # noqa: F401``): the
suite runs several files at once, one worker process each, and torch's
own thread pool per worker would oversubscribe the host's cores."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
