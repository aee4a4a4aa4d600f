"""Fixtures the PyTorch port's test modules share (import them by name).

``one_intra_op_thread`` runs a module's torch operators on one intra-op
thread, and the processes the module starts (its runtime's workers, its
gloo ranks) on one as well, through ``OMP_NUM_THREADS`` and
``MKL_NUM_THREADS``: the tier-1 command runs six pytest workers on an
eight-core host, and eight OpenMP threads in each, spinning while they
wait, slowed every other test several-fold. The previous setting comes
back when the module ends.
"""

import os

import pytest
import torch

_THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS")


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    prev_threads = torch.get_num_threads()
    prev_env = {k: os.environ.get(k) for k in _THREAD_VARS}
    torch.set_num_threads(1)
    os.environ.update({k: "1" for k in _THREAD_VARS})
    try:
        yield
    finally:
        torch.set_num_threads(prev_threads)
        for k, v in prev_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
