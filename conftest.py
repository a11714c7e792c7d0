"""Session-wide test settings that must load before any test package.

Every CPU thread pool (NumPy's and SciPy's BLAS, OpenMP, torch's intra-op
pool) runs one thread a pytest worker, for the whole session and in the
processes tests start: a pool on every core beside the other workers stalls
each BLAS call, and slowed the feeder141 tests ~100x.  This file sits at the
rootdir, so pytest loads it before ``tests/conftest.py`` imports JAX.
"""

import os

for _var in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

# Pytest's plugins load NumPy before this file, so its BLAS pool already runs
# on every core; the variables above reach only the pools loaded from here on.
# ``gridbench/tests`` load this file too, on machines that may lack
# threadpoolctl; the variables alone serve them.
try:
    from threadpoolctl import threadpool_limits
except ImportError:
    pass
else:
    threadpool_limits(1)
