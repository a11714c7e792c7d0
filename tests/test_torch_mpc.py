"""The port's dense MPC DC-OPF agents against the JAX package's, in float64.

Both agents are built from their package's ``Simulator`` facade and a
``SimpleNamespace(low=, high=)`` action space (the port's ``EnvCore``
bounds), not from a Gymnasium env; the port solves in float64
(``solver_x64=True``) on the CPU, the JAX package under the suite's x64.

* The LP (``A, l, u, q, param_rows``) and the solver's scaled data
  (``_As, _D, _E, _c``) are bit-equal at ANM6 h1/h3 and feeder33 h1.
* Two chunks of 25 batched ADMM iterations from the same bounds agree to
  1e-10 (iterates, rho, residuals); a full-budget ``act_batch`` (cold,
  with and without the polish) solves the same bounds and reaches the same
  objectives within 1e-9 relative (objectives, not vertices: the DC-OPF is
  degenerate); JAX's warm carry handed to the port reproduces JAX's next
  warm solve, with and without the stage shift; ``_shift_warm_carry`` is
  equal on every carry layout.
* ``MPCAgentPerfect.act_batch`` with the daily tables (lanes wrapping
  across midnight; iterates to 1e-9, polished objectives to 1e-9
  relative) and the single-lane host path (``_solve``, ``act(env)``
  with a warm carry over two calls) reach JAX's objectives.
* The port's own pieces: the device bound assembly equals the
  ``param_rows`` loop bit for bit, a non-finite warm carry restarts cold,
  a batch-size change drops the carry, TF32 is off inside the solver and
  restored after it, an indefinite KKT block inverts to NaN, and
  ``verify_lanes`` reads the numbers of ``scripts/mpc_bench.py``'s HiGHS
  check.
"""

import types

import numpy as np
import pytest
import torch

from gym_anm_tpu.agents import MPCAgentConstant as JaxConstant, MPCAgentPerfect as JaxPerfect
from gym_anm_tpu.envs.anm6.anm6_easy import _get_gen_time_series as jax_gens, _get_load_time_series as jax_loads
from gym_anm_tpu.envs.anm6.network import network as jax_anm6_network
from gym_anm_tpu.envs.feeder33 import _NETWORK as JAX_F33
from gym_anm_tpu.simulator.facade import Simulator as JaxSimulator

from gym_anm_tpu_torch.agents import MPCAgentConstant, MPCAgentPerfect
from gym_anm_tpu_torch.agents.mpc import full_precision, inv_spd, verify_lanes
from gym_anm_tpu_torch.envs.anm6.anm6_easy import _get_gen_time_series, _get_load_time_series, make_core
from gym_anm_tpu_torch.envs.anm6.network import network as anm6_network
from gym_anm_tpu_torch.envs.batched import BatchedEnv
from gym_anm_tpu_torch.envs.feeder_networks import make_feeder_network
from gym_anm_tpu_torch.simulator import Simulator


B = 4
H = 3
GAMMA = 0.995
CPU64 = dict(solver_x64=True, device="cpu")
OBJ_RTOL = 1e-9
ITER_ATOL = 1e-10


def _space(core):
    return types.SimpleNamespace(low=core.action_low, high=core.action_high)


def _rel_gap(a, b):
    return np.abs(a - b) / np.maximum(1.0, np.abs(b))


@pytest.fixture(scope="module")
def anm6():
    """The two facades (reset to the same s0), the action space, the batched
    env and a batch of its state vectors (lane 0 is the facades' s0), and
    one agent of each package (constant forecasts, h3)."""
    core = make_core(torch.float64, "cpu")
    env = BatchedEnv(core, B, generator=torch.Generator().manual_seed(0))
    es, first = env.reset()
    sv = first.state_vec.numpy()
    sim = Simulator(anm6_network, 0.25, 100, device="cpu")
    jsim = JaxSimulator(jax_anm6_network, 0.25, 100)
    sim.reset(sv[0])
    jsim.reset(sv[0])
    space = _space(core)
    agents = {
        "jax": JaxConstant(jsim, space, GAMMA, planning_steps=H),
        "port": MPCAgentConstant(sim, space, GAMMA, planning_steps=H, **CPU64),
    }
    return types.SimpleNamespace(core=core, env=env, es=es, sv=sv, sim=sim, jsim=jsim, space=space, agents=agents,
                                 cold={})


def _cold(anm6, polish):
    """The JAX and port full-budget cold ``act_batch`` of the batch (once a setting)."""
    if polish not in anm6.cold:
        out = {}
        for name, agent in anm6.agents.items():
            acts = agent.act_batch(anm6.sv, polish=polish)
            sol = {k: np.asarray(v) if name == "jax" else v.numpy() for k, v in agent.last_batch_solution.items()}
            out[name] = (np.asarray(acts), sol)
        anm6.cold[polish] = out
    return anm6.cold[polish]


@pytest.mark.parametrize("grid,N", [("anm6", 1), ("anm6", 3), ("feeder33", 1)])
def test_lp_bit_equal(grid, N):
    net, jnet = {"anm6": (anm6_network, jax_anm6_network), "feeder33": (make_feeder_network(), JAX_F33)}[grid]
    sim, jsim = Simulator(net, 0.25, 100, device="cpu"), JaxSimulator(jnet, 0.25, 100)
    n_act = 2 * (sim.spec.n_gen + sim.spec.n_des)
    space = types.SimpleNamespace(low=-np.ones(n_act), high=np.ones(n_act))
    port = MPCAgentConstant(sim, space, GAMMA, planning_steps=N, **CPU64)
    jax_ = JaxConstant(jsim, space, GAMMA, planning_steps=N)
    for k in ("A", "l", "u", "q", "_As", "_D", "_E", "_qs", "_eq_rows"):
        np.testing.assert_array_equal(getattr(port, k), getattr(jax_, k), err_msg=k)
    assert port._c == jax_._c
    assert port.param_rows == jax_.param_rows
    assert (port.stage_size, port.nz, port._off0) == (jax_.stage_size, jax_.nz, jax_._off0)


def test_admm_two_chunks_match_jax(anm6):
    jax_, port = anm6.agents["jax"], anm6.agents["port"]
    lv, uv = port.batch_bounds(*_forecasts(port, anm6.sv))
    ls, us = (port._E[None, :] * v.numpy() for v in (lv, uv))
    rho0 = np.broadcast_to(np.where(port._eq_rows, 0.1 * 1e3, 0.1), ls.shape)
    x0, z0, y0 = np.zeros((B, port.nz)), np.clip(np.zeros_like(ls), ls, us), np.zeros_like(ls)
    want = [np.asarray(v) for v in jax_._admm_batch_full(ls, us, x0, z0, y0, rho0, 2, 25, 1e-8)]
    t = lambda a: torch.as_tensor(np.array(a))
    got = [v.numpy() for v in port._admm_batch_full(t(ls), t(us), t(x0), t(z0), t(y0), t(rho0), 2, 25, 1e-8)]
    for name, g, w in zip(("x", "z", "y", "rho", "pri", "dual"), got, want):
        # rho (0.1 to 1e3 after the rebalance) agrees to 1e-10 relative.
        tol = dict(rtol=ITER_ATOL, atol=0) if name == "rho" else dict(rtol=0, atol=ITER_ATOL)
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


def _forecasts(agent, sv):
    """``act_batch``'s forecasts for the constant policy, as host arrays."""
    spec = agent.spec
    d, base = spec.n_dev, agent.baseMVA
    loads = sv[:, np.asarray(spec.load_pos)] / base
    p_pot = sv[:, 2 * d + spec.n_des : 2 * d + spec.n_des + spec.n_gen] / base
    N = agent.planning_steps
    return (np.repeat(loads[:, :, None], N, axis=2), np.repeat(p_pot[:, :, None], N, axis=2),
            sv[:, 2 * d : 2 * d + spec.n_des] / base)


@pytest.mark.parametrize("polish", [False, True])
def test_act_batch_full_budget_matches_jax(anm6, polish):
    out = _cold(anm6, polish)
    (jacts, jsol), (acts, sol) = out["jax"], out["port"]
    np.testing.assert_array_equal(sol["lv"], jsol["lv"])
    np.testing.assert_array_equal(sol["uv"], jsol["uv"])
    q = anm6.agents["port"].q
    assert np.max(_rel_gap(sol["x"] @ q, jsol["x"] @ q)) < OBJ_RTOL
    assert acts.shape == (B, anm6.core.action_n)
    assert np.all(acts >= anm6.space.low) and np.all(acts <= anm6.space.high)


@pytest.mark.parametrize("warm_shift", [False, True])
def test_warm_carry_from_jax_reproduces_jax(anm6, warm_shift):
    """JAX solves cold keeping its carry, the env takes one step with its
    actions; JAX's next warm solve and the port's, started from JAX's carry
    as host arrays, reach the same objectives."""
    jax_ = JaxConstant(anm6.jsim, anm6.space, GAMMA, planning_steps=H)
    port = MPCAgentConstant(anm6.sim, anm6.space, GAMMA, planning_steps=H, **CPU64)
    acts = jax_.act_batch(anm6.sv, warm_start=True)
    carry = tuple(np.asarray(c) for c in jax_._warm_carry)
    _, out = anm6.env.step(anm6.es, torch.as_tensor(np.asarray(acts)))
    sv2 = out.state_vec.numpy()
    jacts = np.asarray(jax_.act_batch(sv2, warm_start=True, warm_shift=warm_shift))
    port._warm_carry = carry
    acts2 = port.act_batch(sv2, warm_start=True, warm_shift=warm_shift).numpy()
    q = port.q
    jx, x = np.asarray(jax_.last_batch_solution["x"]), port.last_batch_solution["x"].numpy()
    assert np.max(_rel_gap(x @ q, jx @ q)) < OBJ_RTOL
    np.testing.assert_allclose(acts2, jacts, rtol=0, atol=1e-6)
    assert port._warm_carry is not None and port._warm_carry[0].shape == (B, port.nz)


def test_shift_warm_carry_matches_jax(anm6):
    jax_, port = anm6.agents["jax"], anm6.agents["port"]
    rng = np.random.default_rng(0)
    m = port.A.shape[0]
    layouts = [
        (rng.normal(size=(B, port.nz)), rng.normal(size=(B, m)), rng.normal(size=(B, m))),  # dense batch
        (rng.normal(size=port.nz), rng.normal(size=m), rng.normal(size=m)),  # single lane
        (rng.normal(size=(B, H, 5)), rng.normal(size=(B, H, 7)), rng.normal(size=(B, H, 7))),  # banded
    ]
    for carry in layouts:
        want = [np.asarray(v) for v in jax_._shift_warm_carry(carry)]
        got_np = port._shift_warm_carry(carry)
        got_t = port._shift_warm_carry(tuple(torch.as_tensor(v) for v in carry))
        for g, gt, w in zip(got_np, got_t, want):
            assert isinstance(g, np.ndarray) and isinstance(gt, torch.Tensor)
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(gt.numpy(), w)


def test_perfect_act_batch_matches_jax(anm6):
    loads, gens = _get_load_time_series(), _get_gen_time_series()
    np.testing.assert_array_equal(loads, jax_loads())
    np.testing.assert_array_equal(gens, jax_gens())
    kw = dict(safety_margin=0.96, planning_steps=H, P_loads=loads, P_maxs=gens)
    jax_ = JaxPerfect(anm6.jsim, anm6.space, GAMMA, **kw)
    port = MPCAgentPerfect(anm6.sim, anm6.space, GAMMA, **kw, **CPU64)
    sv = anm6.sv.copy()
    sv[:, -1] = [0, 50, 94, 95]  # two lanes' horizons wrap across midnight
    # warm_start only keeps each solve's carry for the polish below (the
    # first call has none to start from: both solves are cold).
    jacts = np.asarray(jax_.act_batch(sv, warm_start=True))
    acts = port.act_batch(sv, warm_start=True).numpy()
    jsol, sol = jax_.last_batch_solution, port.last_batch_solution
    lv, uv = sol["lv"].numpy(), sol["uv"].numpy()
    np.testing.assert_array_equal(lv, jsol["lv"])
    np.testing.assert_array_equal(uv, jsol["uv"])
    # These lanes end the budget on a dual-residual plateau (~2e-7 scaled),
    # not at a fixed point: the iterates agree to 1e-9, and the exact
    # vertices the polish recovers from them agree in objective.
    x, jx = sol["x"].numpy(), np.asarray(jsol["x"])
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-9)
    px = port._polish_batch(x, port._warm_carry, lv, uv)
    pjx = jax_._polish_batch(jx, jax_._warm_carry, lv, uv)
    q = port.q
    assert np.max(_rel_gap(px @ q, pjx @ q)) < OBJ_RTOL
    assert acts.shape == jacts.shape


def test_perfect_act_batch_requires_tables(anm6):
    agent = MPCAgentPerfect(anm6.sim, anm6.space, GAMMA, planning_steps=2, **CPU64)
    with pytest.raises(ValueError, match="daily tables"):
        agent.act_batch(anm6.sv)


def test_single_lane_solve_matches_jax(anm6):
    jax_, port = anm6.agents["jax"], anm6.agents["port"]
    load_f, gen_f, soc = (f[1] for f in _forecasts(port, anm6.sv))
    fake = types.SimpleNamespace(state={"des_soc": {"pu": dict(zip(port.des_ids, soc))}})
    a_j = jax_._solve(fake, load_f, gen_f)
    a_p = port._solve(fake, load_f, gen_f)
    q = port.q
    assert _rel_gap(port.last_solution["x"] @ q, jax_.last_solution["x"] @ q) < OBJ_RTOL
    np.testing.assert_array_equal(port.last_solution["lv"], jax_.last_solution["lv"])
    assert a_p.shape == a_j.shape


def test_act_env_warm_matches_jax(anm6):
    """``act(env)`` reads the facade's state (duck-typed env); two calls
    with a warm, stage-shifted carry reach JAX's objectives."""
    kw = dict(safety_margin=0.96, planning_steps=H, warm_start=True)
    jax_ = JaxConstant(anm6.jsim, anm6.space, GAMMA, **kw)
    port = MPCAgentConstant(anm6.sim, anm6.space, GAMMA, **kw, **CPU64)
    env, jenv = types.SimpleNamespace(simulator=anm6.sim), types.SimpleNamespace(simulator=anm6.jsim)
    q = port.q
    for _ in range(2):
        a_j, a_p = jax_.act(jenv), port.act(env)
        assert isinstance(a_p, np.ndarray) and a_p.shape == a_j.shape
        assert _rel_gap(port.last_solution["x"] @ q, jax_.last_solution["x"] @ q) < OBJ_RTOL
    assert port._act_carry is not None


def test_batch_bounds_match_param_loop():
    """The device assembly of the per-lane bounds is the ``param_rows`` loop
    of the JAX package, bit for bit (feeder33, h2, random forecasts)."""
    sim = Simulator(make_feeder_network(), 0.25, 100, device="cpu")
    n_act = 2 * (sim.spec.n_gen + sim.spec.n_des)
    agent = MPCAgentConstant(sim, types.SimpleNamespace(low=-np.ones(n_act), high=np.ones(n_act)), GAMMA,
                             planning_steps=2, **CPU64)
    rng = np.random.default_rng(1)
    load_f = rng.normal(size=(3, agent.n_load, 2))
    gen_f = rng.normal(size=(3, agent.n_gen - 1, 2))
    socs = rng.normal(size=(3, agent.n_des))
    lv, uv = np.tile(agent.l, (3, 1)), np.tile(agent.u, (3, 1))
    for r, kind, s, i in agent.param_rows:
        if kind == "load_eq":
            lv[:, r] = uv[:, r] = load_f[:, i, s]
        elif kind == "gen_cap":
            uv[:, r] = gen_f[:, i, s]
        elif kind == "soc_init":
            lv[:, r] = uv[:, r] = socs[:, i]
    got_l, got_u = agent.batch_bounds(load_f, gen_f, torch.as_tensor(socs))
    np.testing.assert_array_equal(got_l.numpy(), lv)
    np.testing.assert_array_equal(got_u.numpy(), uv)


def test_non_finite_warm_carry_restarts_cold(anm6):
    port = anm6.agents["port"]
    lv, uv = port.batch_bounds(*_forecasts(port, anm6.sv))
    kw = dict(max_chunks=2, chunk_len=25)
    x_cold, carry = port._admm_batch(lv, uv, **kw)
    bad = tuple(c.clone() for c in carry)
    bad[0][1, 0] = float("nan")
    x_warm, carry_w = port._admm_batch(lv, uv, warm=bad, warm_chunks=1, **kw)
    np.testing.assert_array_equal(x_warm.numpy(), x_cold.numpy())
    for a, b in zip(carry_w, carry):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_batch_size_change_drops_the_carry(anm6, monkeypatch):
    port = MPCAgentConstant(anm6.sim, anm6.space, GAMMA, planning_steps=H, **CPU64)
    seen = []

    def fake_admm_batch(lv, uv, warm=None, **kw):
        seen.append(warm)
        n = lv.shape[0]
        return torch.zeros((n, port.nz), dtype=torch.float64), tuple(torch.zeros((n, k)) for k in (port.nz, 1, 1))

    monkeypatch.setattr(port, "_admm_batch", fake_admm_batch)
    port.act_batch(anm6.sv, warm_start=True)
    port.act_batch(anm6.sv, warm_start=True)
    port.act_batch(np.repeat(anm6.sv, 2, axis=0), warm_start=True)
    assert seen[0] is None and seen[1] is not None and seen[2] is None
    port.act_batch(np.repeat(anm6.sv, 2, axis=0))
    assert port._warm_carry is None


def test_tf32_off_inside_the_solver_and_restored():
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with full_precision():
            assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_inv_spd_nan_on_indefinite_blocks():
    K = torch.stack([torch.eye(3, dtype=torch.float64) * 2.0, -torch.eye(3, dtype=torch.float64)])
    inv = inv_spd(K)
    np.testing.assert_allclose(inv[0].numpy(), np.eye(3) / 2.0, rtol=0, atol=1e-15)
    assert bool(torch.isnan(inv[1]).all())


def test_verify_lanes_matches_the_bench_check(anm6):
    """``verify_lanes`` (the port's HiGHS check) gives the numbers of the
    JAX bench's ``_verify_lanes`` (which rounds them to 8 decimals) on the
    same solve; the polished lanes meet ``tests/test_mpc.py``'s bars
    (objective within 1e-3 of HiGHS, bounds within 1e-6)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts", "mpc_bench.py")
    spec = importlib.util.spec_from_file_location("jax_mpc_bench", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    _cold(anm6, True)
    got = verify_lanes(anm6.agents["port"], 3)
    want = bench._verify_lanes(anm6.agents["jax"], 3)
    assert got["verify_lanes"] == want["verify_lanes"] == 3
    for k in ("verify_max_rel_obj_gap", "verify_mean_rel_obj_gap", "verify_max_bound_violation"):
        assert abs(got[k] - want[k]) <= 1e-8, k
    assert got["verify_max_rel_obj_gap"] < 1e-3 and got["verify_max_bound_violation"] < 1e-6
