"""The thread budget of the port's tests under pytest-xdist.

The suite runs N worker processes (``-n N``) on one host. torch's CPU ops
take one intra-op thread per core by default, so N workers oversubscribe
the cores N times, and OpenMP's spinning waits then stretch every torch
op: ``test_torch_dryrun.py``, 41 s alone, took ~700 test-seconds beside
five other workers. Every worker imports this module when it collects the
suite, before any test runs, and caps its torch threads at its share of
the cores it may use; the processes its tests start (CLIs, gloo worlds)
inherit the cap through ``OMP_NUM_THREADS`` unless one is set. Outside
xdist nothing changes.
"""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
SHARE = max(1, len(os.sched_getaffinity(0)) // max(WORKERS, 1))
if WORKERS > 1:
    torch.set_num_threads(SHARE)
    os.environ.setdefault("OMP_NUM_THREADS", str(SHARE))


def test_torch_threads_stay_within_the_workers_share():
    if WORKERS > 1:
        assert torch.get_num_threads() == SHARE
        assert int(os.environ["OMP_NUM_THREADS"]) >= 1
    else:
        assert torch.get_num_threads() >= 1
