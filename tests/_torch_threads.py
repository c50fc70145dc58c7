"""One torch thread per test module of the port.

The port's CPU tests run tiny tensors through many small ops, where
torch's intra-op thread pool costs more than it gives: a mamba2 smoke
trainer test takes 21.6 s on 8 threads and 2.9 s on one, alone, and the
gap grows under ``pytest -n 6`` when six workers' pools share eight cores.
A test module imports :func:`one_torch_thread` (an autouse fixture), which
pins one thread for the module and restores the count after it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
