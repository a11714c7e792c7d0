"""The suite's CPU thread pools stay at one thread a pytest worker.

The ``conftest.py`` at the repository root pins NumPy's BLAS, OpenMP and
torch's intra-op pool for the whole session and for the processes tests
start.  A later ``with threadpool_limits(...)`` or a new import order that
let a pool run on every core again would stall the BLAS-heavy tests ~100x
beside the other workers, and a run of the suite would outlast its time
limit."""

import json
import subprocess
import sys

from threadpoolctl import threadpool_info

# Prints what a process started by a test sees once it has loaded the same
# libraries: the loaded pools' thread counts and torch's intra-op threads.
_CHILD = """
import json
import numpy, scipy.linalg, torch
from threadpoolctl import threadpool_info
print(json.dumps({"pools": threadpool_info(), "torch": torch.get_num_threads()}))
"""


def _wide_pools(pools):
    return [(p["internal_api"], p["filepath"], p["num_threads"]) for p in pools if p["num_threads"] != 1]


def test_worker_pools_run_one_thread():
    import scipy.linalg  # noqa: F401  (loads SciPy's own BLAS)
    import torch

    pools = threadpool_info()
    assert {p["user_api"] for p in pools} >= {"blas", "openmp"}
    assert _wide_pools(pools) == []
    assert torch.get_num_threads() == 1


def test_started_processes_run_one_thread():
    out = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True, text=True, check=True, timeout=120)
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert {p["user_api"] for p in seen["pools"]} >= {"blas", "openmp"}
    assert _wide_pools(seen["pools"]) == []
    assert seen["torch"] == 1
