"""feeder141 on the fused path, on the CPU (the kernel itself runs on the
card in ``tests/test_torch_cuda.py``):

* the benchmark's configuration file holds the network
  ``make_multi_feeder_network`` makes, the task's float32 ``x_tol`` and the
  tree solves' budget of 18 for ``fused``, and feeder33's dynamics;
* the benchmark's cell on this feeder, run small on the CPU through the
  whole-transition kernel's plain twin, is judged correct by the plain
  reference and reports K3's iterations a lane-solve; its bfloat16 control
  and the three faults of ``gridbench/tests/test_gridbench_cells.py`` (a
  state returned unchanged, half the batch left out, a reward altered) are
  not;
* the fused transition's counters gain what the plain twin returns: its
  ``n_iter`` summed, its unconverged lanes (a NaN one among them) and its
  lane-solves, and nothing goes to the tree-NR kernel's counters.

Imports no JAX.  The benchmark's harness refuses a process in which JAX is
loaded, so its cell runs in a fresh interpreter.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gym_anm_tpu_torch.envs.feeder141 import make_core
from gym_anm_tpu_torch.envs.feeder_networks import make_multi_feeder_network
from gym_anm_tpu_torch.ops import step_cuda, tree_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "gridbench", "configs", "feeder141.json")
CELL = "feeder141.rollout.fused-pool"
RUNS = ("sound", "control", "unchanged", "half_batch", "altered")


def test_config_file_holds_the_network_the_program_runs():
    with open(CONFIG) as f:
        cfg = json.load(f)
    with open(os.path.join(REPO, "gridbench", "configs", "feeder33.json")) as f:
        f33 = json.load(f)
    assert cfg["reduced"] == [] and cfg["program"] == {"make_core": "gym_anm_tpu_torch.envs.feeder141",
                                                       "passes_network": True}
    assert cfg["dtype"] == "float32" and cfg["x_tol"] == 3e-5 and cfg["pf_max_iter"]["fused"] == 18
    assert cfg["next_vars"] == f33["next_vars"]
    net = make_multi_feeder_network()
    for key in ("bus", "device", "branch"):
        a, b = np.asarray(net[key], dtype=object), np.asarray(cfg["network"][key], dtype=object)
        assert a.shape == b.shape
        assert all((x is None and y is None) or float(x) == float(y) for x, y in zip(a.ravel(), b.ravel()))
    core = make_core(torch.float32, "cpu", pf_method="fused", network=cfg["network"])
    assert (core.spec.n_bus, core.spec.n_load, core.spec.n_gen, core.spec.n_des) == (141, 140, 17, 4)
    assert (core.max_iter, core.x_tol) == (cfg["pf_max_iter"]["fused"], cfg["x_tol"])


RUN = (
    "import importlib.util, json, sys; sys.path.insert(0, %r)\n"
    "from gridbench import harness\n"
    "spec = importlib.util.spec_from_file_location('cells', %r)\n"
    "cells = importlib.util.module_from_spec(spec); spec.loader.exec_module(cells)\n"
    "small = {'batch': 48, 'segment_steps': 6, 'judge_segments': 3, 'trace_segments': 1}\n"
    "for run in %r:\n"
    "    patch = getattr(cells, '_' + run, None)\n"
    "    line = harness.run_cell(%r, 2**31 + 1409, 0.3, run == 'sound', device='cpu', overrides=small,\n"
    "                            control=run == 'control', patch=patch)\n"
    "    print(json.dumps(line))\n"
    % (REPO, os.path.join(REPO, "gridbench", "tests", "test_gridbench_cells.py"), RUNS, CELL)
)


@pytest.fixture(scope="module")
def cell_runs():
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", RUN], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [json.loads(s) for s in res.stdout.strip().splitlines()[-len(RUNS):]]
    return dict(zip(RUNS, lines))


@pytest.mark.parametrize("run", RUNS)
def test_cell_against_the_reference(cell_runs, run):
    """The cell at 48 lanes and 6-step segments through the fused
    transition's plain twin: the sound (traced) run is correct and reports
    K3's iterations a lane-solve; the control and each fault are not
    correct, the control by the power-flow residual."""
    line = cell_runs[run]
    if run == "sound":
        assert line["correct"], line["checks"]
        assert line["attempted"] > 0 and line["failed"] == 0
        assert 1.0 <= line["metrics"]["k3_iters_per_solve.rollout"]["value"] <= 18.0
    else:
        assert not line["correct"], line["checks"]
    if run == "control":
        assert line["checks"]["pf_residual"]["value"] > line["checks"]["pf_residual"]["limit"]


@pytest.mark.parametrize("max_iter", [2, 18])
def test_counters_add_what_the_twin_returns(max_iter):
    """One plain fused transition of 64 lanes, a NaN lane among them: the
    fused transition's counters gain its ``n_iter`` summed, the lanes that
    ended unconverged and 64 lane-solves; the tree-NR kernel's counters gain
    nothing.  (No load this network allows overloads it: loads clip.)"""
    core = make_core(torch.float32, "cpu", pf_method="fused")
    st = core.grid.step
    g = torch.Generator().manual_seed(4)
    es, _ = core.reset(g, 64)
    vars = core.next_vars_fn(es.state_vec, g)
    lo, hi = torch.as_tensor(core.action_low), torch.as_tensor(core.action_high)
    actions = (lo + (hi - lo) * torch.rand((64, core.action_n), generator=g)).to(torch.float32)
    lanes = step_cuda.pack_inputs(**core.transition_inputs(es, actions, vars))
    n_des, n_load = st.dims["n_des"], st.dims["n_load"]
    lanes[n_des + n_load // 2, 1] = float("nan")  # a load of lane 1
    k3_counts = lambda: step_cuda.iteration_counts("cpu").tolist() + [step_cuda.LANE_SOLVES]
    k0, t0 = k3_counts(), tree_cuda.iteration_counts("cpu").tolist() + [tree_cuda.LANE_SOLVES]
    r0 = step_cuda.read_iteration_counts()
    out = step_cuda.unpack_outputs(st, step_cuda.fused_transition_plain(st, lanes, x_tol=core.x_tol,
                                                                        max_iter=max_iter))
    unconverged = ~(out.diff[:, 0] <= core.x_tol)
    added = [int(out.n_iter.sum()), int(unconverged.sum()), 64]
    assert [b - a for a, b in zip(k0, k3_counts())] == added
    r1 = step_cuda.read_iteration_counts()
    assert (r1.iterations - r0.iterations, r1.unconverged - r0.unconverged) == tuple(added[:2])
    assert tree_cuda.iteration_counts("cpu").tolist() + [tree_cuda.LANE_SOLVES] == t0
    assert bool(unconverged[1]) and added[0] > 64 and int(out.n_iter.max()) <= max_iter
