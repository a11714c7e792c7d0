"""The port's stage-banded MPC backend against the JAX package's, in float64.

* The banded LP templates (``A_diag, A_sub, l/u_stage, q_stage``, the dense
  mirror, ``param_rows``) and the Ruiz scales (``_D_stage, _E_stage, _c``)
  are bit-equal at ANM6 h3 and feeder141 h5.
* Two chunks of 25 banded ADMM iterations (block-Thomas factorization and
  sweeps) from the same bounds agree to 1e-10 at ANM6 h3, B=2; the
  single-lane host path (``_solve``, early-exit chunk loop and dense
  polish) reaches JAX's objective at ANM6 h4.
* ``apply_A_host`` and ``sparse_A`` equal JAX's (and the dense mirror).
* The host float64 sparse-KKT polish replays
  ``tests/data/polish_calib_feeder141.npz`` to its HiGHS optima (gap <
  1e-8, violation < 1e-9), as ``tests/test_mpc_banded.py`` does.
* Splitting a batch into lane chunks leaves each lane's solve unchanged.
* Importing ``gym_anm_tpu_torch.agents`` and ``gym_anm_tpu_torch.simulator``
  loads neither ``jax``, ``gymnasium`` nor ``gym_anm_tpu``.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from gym_anm_tpu.agents import MPCAgentConstantBanded as JaxConstantBanded
from gym_anm_tpu.envs.anm6.network import network as jax_anm6_network
from gym_anm_tpu.envs.feeder141 import _NETWORK as JAX_F141
from gym_anm_tpu.simulator.facade import Simulator as JaxSimulator

from gym_anm_tpu_torch.agents import MPCAgentConstantBanded
from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core
from gym_anm_tpu_torch.envs.anm6.network import network as anm6_network
from gym_anm_tpu_torch.envs.batched import BatchedEnv
from gym_anm_tpu_torch.envs.feeder_networks import make_multi_feeder_network
from gym_anm_tpu_torch.simulator import Simulator


GAMMA = 0.995
CPU64 = dict(solver_x64=True, device="cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(grid, N, **kw):
    net, jnet = {"anm6": (anm6_network, jax_anm6_network), "feeder141": (make_multi_feeder_network(), JAX_F141)}[grid]
    sim, jsim = Simulator(net, 0.25, 100, device="cpu"), JaxSimulator(jnet, 0.25, 100)
    n_act = 2 * (sim.spec.n_gen + sim.spec.n_des)
    space = types.SimpleNamespace(low=-np.ones(n_act), high=np.ones(n_act))
    port = MPCAgentConstantBanded(sim, space, GAMMA, planning_steps=N, **kw, **CPU64)
    jax_ = JaxConstantBanded(jsim, space, GAMMA, planning_steps=N, **kw)
    return port, jax_


@pytest.fixture(scope="module")
def anm6_h3():
    return _pair("anm6", 3)


def _state_vecs(B, seed=0):
    core = make_core(torch.float64, "cpu")
    env = BatchedEnv(core, B, generator=torch.Generator().manual_seed(seed))
    return env.reset()[1].state_vec.numpy()


@pytest.mark.parametrize("grid,N", [("anm6", 3), ("feeder141", 5)])
def test_banded_templates_bit_equal(grid, N):
    port, jax_ = _pair(grid, N, safety_margin=0.96)
    for k in ("A_diag", "A_sub", "l_stage", "u_stage", "q_stage", "q", "l", "u", "_D_stage", "_E_stage", "_D", "_E",
              "_eq_rows"):
        np.testing.assert_array_equal(getattr(port, k), getattr(jax_, k), err_msg=k)
    assert (jax_.A is None) == (port.A is None)
    if jax_.A is not None:
        np.testing.assert_array_equal(port.A, jax_.A)
    assert port._c == jax_._c
    assert port.param_rows == jax_.param_rows and port.stage_param_rows == jax_.stage_param_rows
    assert (port.stage_size, port.nz, port.M_rows, port.m, port._off0) == (
        jax_.stage_size, jax_.nz, jax_.M_rows, jax_.m, jax_._off0)


def test_banded_two_chunks_match_jax(anm6_h3):
    port, jax_ = anm6_h3
    B, (N, M, S) = 2, (port.planning_steps, port.M_rows, port.stage_size)
    sv = _state_vecs(B)
    spec, base, d = port.spec, port.baseMVA, port.spec.n_dev
    loads = np.repeat((sv[:, np.asarray(spec.load_pos)] / base)[:, :, None], N, axis=2)
    pots = np.repeat((sv[:, 2 * d + spec.n_des : 2 * d + spec.n_des + spec.n_gen] / base)[:, :, None], N, axis=2)
    lv, uv = port.batch_bounds(loads, pots, sv[:, 2 * d : 2 * d + spec.n_des] / base)
    ls, us = ((port._E[None, :] * v.numpy()).reshape(B, N, M) for v in (lv, uv))
    rho0 = np.broadcast_to(np.where(port._eq_rows, 0.1 * 1e3, 0.1).reshape(1, N, M), (B, N, M))
    x0, z0, y0 = np.zeros((B, N, S)), np.clip(np.zeros_like(ls), ls, us), np.zeros_like(ls)
    want = [np.asarray(v) for v in jax_._admm_batch_full_banded(ls, us, x0, z0, y0, rho0, 2, 25, 1e-8)]
    t = lambda a: torch.as_tensor(np.array(a))
    got = [v.numpy() for v in port._admm_batch_full_banded(t(ls), t(us), t(x0), t(z0), t(y0), t(rho0), 2, 25, 1e-8)]
    for name, g, w in zip(("x", "z", "y", "rho", "pri", "dual"), got, want):
        assert g.shape == w.shape, name
        # rho (0.1 to 1e3 after the rebalance) agrees to 1e-10 relative.
        tol = dict(rtol=1e-10, atol=0) if name == "rho" else dict(rtol=0, atol=1e-10)
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


def test_banded_single_lane_solve_matches_jax():
    port, jax_ = _pair("anm6", 4)
    sv = _state_vecs(1, seed=4)[0]
    spec, base, d = port.spec, port.baseMVA, port.spec.n_dev
    load_f = np.repeat((sv[np.asarray(spec.load_pos)] / base)[:, None], 4, axis=1)
    gen_f = np.repeat((sv[2 * d + spec.n_des : 2 * d + spec.n_des + spec.n_gen] / base)[:, None], 4, axis=1)
    fake = types.SimpleNamespace(state={"des_soc": {"pu": dict(zip(spec.des_ids, sv[2 * d : 2 * d + spec.n_des] / base))}})
    a_j, a_p = jax_._solve(fake, load_f, gen_f), port._solve(fake, load_f, gen_f)
    q = port.q
    gap = abs(port.last_solution["x"] @ q - jax_.last_solution["x"] @ q) / max(1.0, abs(jax_.last_solution["x"] @ q))
    assert gap < 1e-9
    assert a_p.shape == a_j.shape


def test_apply_A_host_and_sparse_A_match_jax(anm6_h3):
    port, jax_ = anm6_h3
    x = np.random.default_rng(0).normal(size=port.nz)
    np.testing.assert_array_equal(port.apply_A_host(x), jax_.apply_A_host(x))
    np.testing.assert_allclose(port.apply_A_host(x), port.A @ x, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(port.sparse_A().toarray(), jax_.sparse_A().toarray())
    np.testing.assert_array_equal(port.sparse_A().toarray(), port.A)


def test_sparse_polish_replays_the_calibration_batch():
    """The port of ``test_sparse_polish_recovers_exact_optimum_from_f32_seed``:
    the add/drop sparse-KKT polish reaches the HiGHS optimum of each lane of
    the committed float32 ADMM seed batch (feeder141 h5)."""
    data = np.load(os.path.join(ROOT, "tests", "data", "polish_calib_feeder141.npz"))
    sim = Simulator(make_multi_feeder_network(), 0.25, 100, device="cpu")
    n_act = 2 * (sim.spec.n_gen + sim.spec.n_des)
    space = types.SimpleNamespace(low=-np.ones(n_act), high=np.ones(n_act))
    # A float64 agent, as the JAX test's under the suite's x64: its polish
    # detects the active set at 1e-6 (a float32 agent's bar is 1e-4).
    agent = MPCAgentConstantBanded(sim, space, GAMMA, planning_steps=5, **CPU64)
    assert agent._polish_act_tol == 1e-6
    out = agent._polish_batch(data["xs"].astype(np.float64), (None, data["z"], data["y"]), data["lv"], data["uv"])
    q = agent.q
    for b in range(out.shape[0]):
        lv, uv = data["lv"][b], data["uv"][b]
        Ax = agent.apply_A_host(out[b])
        viol = max(np.max(np.maximum(0, lv - Ax)), np.max(np.maximum(0, Ax - uv)))
        gap = abs(q @ out[b] - data["highs_opt"][b]) / max(1.0, abs(data["highs_opt"][b]))
        assert viol < 1e-9, (b, viol)
        assert gap < 1e-8, (b, gap)


def test_lane_chunks_leave_each_lane_unchanged(anm6_h3, monkeypatch):
    port, _ = anm6_h3
    sv = _state_vecs(4, seed=2)
    spec, base, d, N = port.spec, port.baseMVA, port.spec.n_dev, port.planning_steps
    loads = np.repeat((sv[:, np.asarray(spec.load_pos)] / base)[:, :, None], N, axis=2)
    pots = np.repeat((sv[:, 2 * d + spec.n_des : 2 * d + spec.n_des + spec.n_gen] / base)[:, :, None], N, axis=2)
    lv, uv = port.batch_bounds(loads, pots, sv[:, 2 * d : 2 * d + spec.n_des] / base)
    kw = dict(max_chunks=2, chunk_len=25)
    assert port.lane_chunk() >= 4
    x_one, carry_one = port._admm_batch(lv, uv, **kw)
    per_lane = 16 * N * port.stage_size ** 2 * 8
    monkeypatch.setattr(port, "HOST_MEMORY_BUDGET", 3 * per_lane)
    assert port.lane_chunk() == 2
    x_split, carry_split = port._admm_batch(lv, uv, **kw)
    np.testing.assert_allclose(x_split.numpy(), x_one.numpy(), rtol=0, atol=1e-13)
    for a, b in zip(carry_split, carry_one):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-13)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import gym_anm_tpu_torch.agents, gym_anm_tpu_torch.simulator\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'gymnasium', 'gym_anm_tpu')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
