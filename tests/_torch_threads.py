"""One torch thread for a test module of the port (imported by each
``tests/test_torch_*.py`` that runs on the CPU).

The port's CPU path runs many small torch ops.  With several threads a
process they run three to four times slower while pytest's workers share
the cores: under a load of seven busy processes, tests/test_torch_cluster.py
took 163 s with 8 threads and 43 s with one, and the whole suite at six
workers 1010 s against 357 s.  Results do not depend on it: every test
passes either way."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
