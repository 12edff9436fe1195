"""One thread for each of the port's tests' compute pools, in every process
that imports a port test file (an xdist worker imports all of them, so it
holds for the whole worker, the JAX package's tests included).

The tier-1 run keeps every core of an 8-core host busy with its six
workers. A pool of a thread per core in each worker oversubscribes them,
and OpenBLAS's idle threads spin: in one worker of a tier-1 run they had
used 337 CPU-s beside the main thread's 154."""

import os

import threadpoolctl
import torch


def one_thread() -> None:
    """torch's intra-op pool and every loaded BLAS and OpenMP pool
    (numpy's, scipy's and OpenCV's OpenBLAS, OpenMP) to one thread; the
    processes that the tests start (ranks, command-line tools) inherit
    ``OPENBLAS_NUM_THREADS`` and ``OMP_NUM_THREADS`` of 1, unless the
    environment already sets them, and start their pools with one."""
    torch.set_num_threads(1)
    threadpoolctl.threadpool_limits(1)
    for name in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS"):
        os.environ.setdefault(name, "1")
