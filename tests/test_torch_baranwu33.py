"""Baran and Wu's 33-bus feeder as a task of the port (``envs/baranwu33.py``)
and the tree-NR solve's iteration counters (``ops/tree_cuda.py``), on the CPU:

* ``make_baran_wu_33_network`` reproduces the published base case (losses 202.68 kW,
  the lowest voltage 0.91309 p.u. at bus 18) through the port's tree solver
  and through the benchmark's plain reference, both in float64;
* the benchmark's configuration file holds the published data and the
  network ``make_baran_wu_33_network`` makes;
* the benchmark's cell on this feeder, run small on the CPU, is judged
  correct by the plain reference, and its bfloat16 control is not;
* initial reactive loads follow each load's own Q/P (feeder33's and
  feeder141's, all 0.25, are what they were);
* the counters add each solve's iterations and budget hits, and count its
  lanes, as the plain solve's returned ``n_iter`` says.

Imports no JAX.  The benchmark's harness refuses a process in which JAX is
loaded, so its cell runs in a fresh interpreter.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gym_anm_tpu_torch.core.grid import build_grid
from gym_anm_tpu_torch.envs import feeder_networks
from gym_anm_tpu_torch.envs.baranwu33 import make_core
from gym_anm_tpu_torch.envs.feeder_networks import BARAN_WU_33, make_baran_wu_33_network
from gym_anm_tpu_torch.ops import tree_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "gridbench", "configs", "baranwu33.json")
CELL = "baranwu33.rollout.tree-pool"
# The published base case (float64, the published loads, no PV or storage).
LOSS_KW, V_MIN, V_MIN_BUS = 202.68, 0.91309, 18


def _base_injections(net):
    """The non-slack buses' injections ``[1, 32]`` (p.u.) of the published
    loads alone, in bus order."""
    p, q = np.zeros(32), np.zeros(32)
    for row in net["device"]:
        if row[2] == -1:
            p[row[1] - 1] += row[5] / net["baseMVA"]
            q[row[1] - 1] += row[5] * row[3] / net["baseMVA"]
    return torch.tensor(p)[None], torch.tensor(q)[None]


def _port_base_case():
    net = make_baran_wu_33_network()
    spec, _ = build_grid(net, delta_t=0.25, lamb=100, dtype=np.float64)
    ds = tree_cuda.DeviceSchedule.from_spec(spec, "cpu", torch.float64)
    p, q = _base_injections(net)
    v_re, v_im, _, _, converged = tree_cuda.solve_pfe_tree(ds, p, q, x_tol=1e-10, max_iter=20)
    assert bool(converged.all())
    V = torch.complex(v_re, v_im)[0]
    Y = torch.complex(torch.tensor(np.asarray(spec.Y_re)), torch.tensor(np.asarray(spec.Y_im)))
    return V, Y


def _reference_base_case():
    from gridbench import reference

    with open(CONFIG) as f:
        g = reference.Grid(json.load(f))
    p = torch.zeros((1, g.n), dtype=torch.float64)
    q = torch.zeros_like(p)
    for k, i in enumerate(g.loads):
        p[0, g.dev_bus[i]] += g.p_min[i]
        q[0, g.dev_bus[i]] += g.p_min[i] * g.load_qp[k]
    V, converged, _ = reference.power_flow(g.Y, p[:, 1:], q[:, 1:], 1e-10, 20, reference.Prec("float64"))
    assert bool(converged.all())
    return V[0], g.Y


@pytest.mark.parametrize("solver", [_port_base_case, _reference_base_case], ids=["port_tree", "reference"])
def test_published_base_case(solver):
    V, Y = solver()
    S = V * (Y @ V).conj()  # every bus's injection, p.u.
    vm = V.abs()
    assert abs(float(S.sum().real) * 1e5 - LOSS_KW) <= 0.05  # kW on the 100 MVA base
    assert int(vm.argmin()) + 1 == V_MIN_BUS
    assert abs(float(vm.min()) - V_MIN) <= 5e-5


def test_config_file_holds_the_published_feeder():
    with open(CONFIG) as f:
        cfg = json.load(f)
    pub = cfg["published"]["branches"]
    assert [tuple(r) for r in pub] == list(BARAN_WU_33) and len(pub) == 32
    assert sum(r[4] for r in pub) == 3715 and sum(r[5] for r in pub) == 2300
    assert cfg["reduced"] == [] and cfg["program"]["make_core"] == "gym_anm_tpu_torch.envs.baranwu33"
    net = make_baran_wu_33_network()
    for key in ("bus", "device", "branch"):
        a, b = np.asarray(net[key], dtype=object), np.asarray(cfg["network"][key], dtype=object)
        assert a.shape == b.shape
        assert all((x is None and y is None) or float(x) == float(y) for x, y in zip(a.ravel(), b.ravel()))
    z_base = 12.66**2 / 100
    loads = [r for r in cfg["network"]["device"] if r[2] == -1]
    assert len(loads) == 32
    for (f, t, r, x, p_kw, q_kvar), br, load in zip(pub, cfg["network"]["branch"], loads):
        assert (br[0], br[1], load[1]) == (f - 1, t - 1, t - 1)
        assert math.isclose(br[2] * z_base, r, rel_tol=1e-12) and math.isclose(br[3] * z_base, x, rel_tol=1e-12)
        assert math.isclose(-load[5] * 1000, p_kw, rel_tol=1e-12)
        assert math.isclose(-load[5] * 1000 * load[3], q_kvar, rel_tol=1e-12)
    assert len(feeder_networks.BARAN_WU_RATES) == 32


RUN = (
    "import json, sys; sys.path.insert(0, %r)\n"
    "from gridbench import harness\n"
    "small = {'batch': 48, 'segment_steps': 6, 'judge_segments': 3, 'trace_segments': 1}\n"
    "for control in (False, True):\n"
    "    line = harness.run_cell(%r, 2**31 + 977, 0.3, not control, device='cpu', overrides=small, control=control)\n"
    "    print(json.dumps(line))\n"
    % (REPO, CELL)
)


@pytest.fixture(scope="module")
def cell_runs():
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", RUN], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    sound, control = (json.loads(s) for s in res.stdout.strip().splitlines()[-2:])
    return {"sound": sound, "control": control}


@pytest.mark.parametrize("run", ["sound", "control"])
def test_cell_against_the_reference(cell_runs, run):
    """The cell at 48 lanes and 6-step segments, through the port's plain
    tree solve: the sound run is correct and reports the solve's iterations
    a lane-solve; the bfloat16 control fails the power-flow residual."""
    line = cell_runs[run]
    if run == "sound":
        assert line["correct"], line["checks"]
        assert line["attempted"] > 0 and line["failed"] == 0
        assert 1.0 <= line["metrics"]["k1_iters_per_solve.rollout"]["value"] <= 10.0
    else:
        assert not line["correct"]
        assert line["checks"]["pf_residual"]["value"] > line["checks"]["pf_residual"]["limit"]


def _task_core(task):
    from gym_anm_tpu_torch.envs.feeder33 import make_core as feeder33
    from gym_anm_tpu_torch.envs.feeder141 import make_core as feeder141

    return {"baranwu33": make_core, "feeder33": feeder33, "feeder141": feeder141}[task](torch.float32, "cpu")


@pytest.mark.parametrize("task", ["baranwu33", "feeder33", "feeder141"])
def test_initial_reactive_loads_follow_each_load(task):
    """``Q = P * QP`` load by load, bit for bit.  On feeder33 and feeder141
    every QP is 0.25, so the state is the former ``loads * 0.25`` one."""
    core = _task_core(task)
    spec = core.spec
    s = core.init_state_fn(torch.Generator().manual_seed(123), 64)
    pos = np.asarray(spec.load_pos)
    qp = torch.tensor(np.asarray(spec.load_qp, dtype=np.float32))
    assert torch.equal(s[:, spec.n_dev + pos], s[:, pos] * qp)
    if task == "baranwu33":
        assert float(qp.min()) < 0.2 and float(qp.max()) == 3.0
    else:
        assert bool((qp == 0.25).all())
        assert torch.equal(s[:, spec.n_dev + pos], s[:, pos] * 0.25)


def test_gymnasium_id_steps_the_feeder():
    import gymnasium as gym

    env = gym.make("gym_anm_tpu_torch.envs.registration:gym_anm_tpu_torch/ANMBaranWu33-v0", device="cpu")
    obs, _ = env.reset(seed=5)
    spec = env.unwrapped.simulator.spec
    pos = np.asarray(spec.load_pos)
    s = np.asarray(env.unwrapped.state, dtype=np.float64)
    np.testing.assert_allclose(s[spec.n_dev + pos], s[pos] * np.asarray(spec.load_qp), rtol=1e-12)
    obs, reward, terminated, _, _ = env.step(env.action_space.sample())
    assert obs.shape == env.observation_space.shape and np.isfinite(reward) and not terminated


def _counters():
    return list(tree_cuda.iteration_counts("cpu").tolist()) + [tree_cuda.LANE_SOLVES]


@pytest.mark.parametrize("max_iter", [2, 10])
def test_counters_add_what_the_solve_returns(max_iter):
    """A plain solve of 64 lanes, one NaN and one that cannot converge among
    them: the counters gain its ``n_iter`` summed, the lanes that ended at the
    budget unconverged, and 64 lane-solves."""
    net = make_baran_wu_33_network()
    spec, _ = build_grid(net, delta_t=0.25, lamb=100, dtype=np.float32)
    ds = tree_cuda.DeviceSchedule.from_spec(spec, "cpu", torch.float32)
    p, q = (x.float() * torch.linspace(0.3, 1.2, 64)[:, None] for x in _base_injections(net))
    p[1, 4] = float("nan")
    p[2] *= 40.0
    c0 = _counters()
    _, _, diff, n_iter, converged = tree_cuda.solve_pfe_tree(ds, p, q, x_tol=1e-5, max_iter=max_iter)
    hits = int(((n_iter == max_iter) & ~converged).sum())
    assert [b - a for a, b in zip(c0, _counters())] == [int(n_iter.sum()), hits, 64]
    assert hits >= 1 and not bool(converged[1]) and not bool(converged[2])


def test_counters_follow_a_rollout(monkeypatch):
    """A pool rollout on the feeder: the counters gain the iterations every
    solve of it returned, resets and pools included."""
    returned = []
    plain = tree_cuda.solve_pfe_tree_plain

    def spy(*args, **kwargs):
        out = plain(*args, **kwargs)
        returned.append(int(out[3].sum()))
        return out

    monkeypatch.setattr(tree_cuda, "solve_pfe_tree_plain", spy)
    from gym_anm_tpu_torch.envs.batched import BatchedEnv

    env = BatchedEnv(make_core(torch.float32, "cpu"), 32, generator=torch.Generator().manual_seed(9), auto_reset=True)
    c0 = _counters()
    es, _ = env.reset()
    env.rollout(es, 4)
    d = [b - a for a, b in zip(c0, _counters())]
    assert d[0] == sum(returned) and d[2] == 32 * len(returned) and len(returned) >= 4 + 2
    assert 1.0 <= d[0] / d[2] <= 5.0
