"""Shared pieces of kvbench's tests: each cell cut to a size the CPU runs
in a second or two, with the port's plain phases."""

import pytest
import torch

# every cell's configuration and traffic, cut down: a few thousand keys,
# small batches, an MVCC window of a few batches and a state of 8,192
# slots
STEP = 1000
TINY = {
    "ycsb-1m.a-1k": {
        "config": {"keys": {"records": 3000},
                   "engine": {"capacity": 8192, "max_write_life": 5 * STEP}},
        "traffic": {"txns_per_batch": 64, "version_step": STEP,
                    "pool_batches": 16, "trace_batches": 16}},
    "skiplisttest.2500": {
        "config": {"keys": {"records": 20000},
                   "engine": {"capacity": 8192, "max_write_life": 16 * STEP}},
        "traffic": {"txns_per_batch": 32, "version_step": STEP,
                    "pool_batches": 20, "trace_batches": 16}},
    "skiplisttest.16k": {
        "config": {"keys": {"records": 20000},
                   "engine": {"capacity": 8192, "max_write_life": 4 * STEP}},
        "traffic": {"txns_per_batch": 128, "version_step": STEP,
                    "pool_batches": 12, "trace_batches": 16}},
}
CELLS = tuple(TINY)
SEED = 2**31 + 11  # above 32 signed bits, as the driver's are


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda_card():
    """The card, or a skip: decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return torch.device("cuda", torch.cuda.current_device())
