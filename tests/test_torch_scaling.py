"""The port's multi-process paths over gloo: the ``dp 2 x tp 2`` dry run,
two simulated hosts, and weak scaling.

The counterparts of ``tests/test_scaling.py`` (and of the JAX dry run's
test, ``tests/test_parallel.py``), marked ``slow`` as they are: each spawns
four CPU processes (or two, twice, for the scaling check).
"""

import json
import os
import subprocess
import sys

import pytest

from gym_anm_tpu_torch.parallel.dryrun import RANKS_TIMEOUT, dryrun_multidevice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name, *args, spawns=1):
    """``scripts/<name>``'s JSON lines; a minute more than its ``spawns``
    spawns have, so that they end their ranks first."""
    r = subprocess.run([sys.executable, "-u", os.path.join(REPO, "scripts", name), *args], capture_output=True,
                       text=True, timeout=RANKS_TIMEOUT * spawns + 60, cwd=REPO)
    assert r.returncode == 0, "%s failed:\n%s\n%s" % (name, r.stdout[-3000:], r.stderr[-3000:])
    return [json.loads(line) for line in r.stdout.splitlines() if line.startswith("{")]


@pytest.mark.slow
def test_dryrun_dp2_tp2_over_gloo():
    """JAX's rule at four devices: a ``dp 2 x tp 2`` mesh.  The dry run
    checks itself (``check_dryrun``); the layout is held here."""
    ranks = dryrun_multidevice(4, "gloo")
    assert [(r["dp_rank"], r["tp_rank"]) for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        assert (r["dp"], r["tp"], r["ppo"]["batch"], r["ppo"]["local_batch"]) == (2, 2, 8, 4)
        assert all(tp >= 1 and dp >= 1 for dp, tp in r["ppo"]["dp_tp_collectives_an_update"])
        assert r["fleet"]["collectives_while_stepping"] == 0 and r["mpc"]["max_abs_diff_unsharded"] <= 1e-6
    assert ranks[0]["ppo"]["param_digests"] == ranks[2]["ppo"]["param_digests"]
    assert ranks[0]["ppo"]["param_digests"] != ranks[1]["ppo"]["param_digests"]  # tp shards differ


@pytest.mark.slow
def test_multiprocess_hosts_over_gloo():
    """Two simulated hosts of two ranks each, each stepping its own lanes;
    the global mean reward from one all_reduce, identical on every rank."""
    rows = _script("multiproc_dist_torch.py", "--backend", "gloo")
    ranks, last = rows[:-1], rows[-1]
    assert last["multiprocess_ok"] is True and last["global_lanes"] == 4 * 64
    assert [r["local_rank"] for r in ranks] == [0, 1, 0, 1] and {r["world"] for r in ranks} == {4}
    assert {r["mean_reward"] for r in ranks} == {last["mean_reward"]}


@pytest.mark.slow
def test_weak_scaling_two_gloo_ranks():
    """Weak-scaling floor of ``tests/test_scaling.py``: twice the lanes on
    two ranks in at most 1 / 0.65 of the one-rank time, best iteration
    against best iteration as that test takes them (the script's own
    ``efficiency`` is over medians).  The two ranks share the host's cores
    with whatever else runs there, so, as that test takes the best of three
    calls, this takes the best of up to three whole runs of the script."""
    runs = []
    for _ in range(3):
        rows = _script("scaling_bench_torch.py", "--backend", "gloo", "--world", "2", "--per-device-batch", "512",
                       "--steps", "16", "--iters", "5", spawns=2)
        assert [r["devices"] for r in rows] == [1, 2] and rows[1]["batch"] == 1024
        runs.append(min(rows[0]["iteration_ms"]) / min(rows[1]["iteration_ms"]))
        if runs[-1] >= 0.65:
            break
    assert max(runs) >= 0.65, runs
