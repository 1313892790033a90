"""Each test process's torch thread pool: its share of the host's cores.

Every ``tests/test_torch_*`` module imports this one, so the pool is set
when a process collects the port's tests, before any test runs; an xdist
worker collects every module, so its other tests (``perfbench/tests``
among them) run with the same pool. The share is ``os.cpu_count() //
workers``, at least 1, where ``workers`` is ``PYTEST_XDIST_WORKER_COUNT``
(xdist sets it in every worker; a one-process run counts 1 and keeps every
core). Left at torch's default, each of 6 xdist workers on an 8-core host
sized its pool to all 8 cores, so up to 48 compute threads shared 8 cores:
the suite's case times summed to 5340 s in a 1038 s wall, against
2091-2381 s in 511-593 s with one thread a worker. Spawned gloo ranks set
``OMP_NUM_THREADS=1`` themselves; XLA's pool is left as it is.
"""

import os

import torch

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))
