"""The port's CPU tests share the machine's cores between pytest-xdist's
workers.  Each worker's torch would start one intra-op thread per core,
so the workers together run several threads a core, and torch's
threads spin and wait on each other.  Every ``tests/test_torch_*.py``
imports this module, which gives each worker its share of the cores; a
test that starts a subprocess passes the same count on in
:func:`child_env`."""

import os

import torch

THREADS = max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
torch.set_num_threads(THREADS)


def child_env(**extra) -> dict:
    """``os.environ`` for a child process, with the worker's share of the
    cores as ``OMP_NUM_THREADS`` (and ``extra`` on top)."""
    return dict(os.environ, OMP_NUM_THREADS=str(THREADS), **extra)
