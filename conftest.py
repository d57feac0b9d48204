"""Test-session settings for the whole repo, loaded before tests/conftest.py.

Under pytest-xdist each worker caps torch's CPU threads at its share of the
machine's cores, `os.cpu_count() // workers` and at least one: at torch's
default of a thread a core in every worker, the workers' intra-op threads
spin against one another and every worker runs many times slower.  The cap
also goes into OMP_NUM_THREADS, which processes a test starts (gloo ranks,
CLI subprocesses) inherit.  It is assigned, not defaulted: the workers
inherit the controller's environment.  Outside xdist nothing is set.
"""

import os

if os.environ.get("PYTEST_XDIST_WORKER") and os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    _threads = max(1, (os.cpu_count() or 1) // int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))
    os.environ["OMP_NUM_THREADS"] = str(_threads)

    import torch

    torch.set_num_threads(_threads)
