"""The port's test modules' shared fixture: one intra-op thread.

Import it into a test module (``from torch_threads import
one_intra_op_thread``) and it runs around that module's tests.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for the port's tiny models: the suite's workers
    share the cores, and torch's default of one thread a core each
    oversubscribes them; on one worker it is as fast as the default."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
