"""One intra-op thread for the port's CPU tests.

The suite runs several worker processes on a machine with about as many
cores. Each torch operator on the CPU otherwise splits its work over as
many threads as the machine has cores, in every worker and, on a mesh,
in every rank's thread of every worker, and those pools then contend
for the same cores. A test module of the port takes ``one_torch_thread``
(autouse, module scope) by importing it, and runs with one intra-op
thread; the thread count changes no result, since every run in the
module uses the same one.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_one_torch_thread_is_in_force():
    assert torch.get_num_threads() == 1


def test_rank_threads_take_one_thread():
    """A mesh rank's thread, started inside the module, sees the count."""
    import threading

    seen = []
    t = threading.Thread(target=lambda: seen.append(torch.get_num_threads()))
    t.start()
    t.join()
    assert seen == [1]
