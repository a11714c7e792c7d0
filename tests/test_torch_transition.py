"""The port's physics transition against JAX ``transition(pf_method="tree")``
in float64 on ANM6: every SimState field, the reward terms and the
convergence flags, from random set-points made with numpy."""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from gym_anm_tpu.core.grid import build_grid as jax_build_grid
from gym_anm_tpu.core.transition import sim_reset as jax_sim_reset, transition as jax_transition
from gym_anm_tpu.envs.anm6.network import network as jax_anm6_network

from gym_anm_tpu_torch.core.grid import GridTensors, build_grid
from gym_anm_tpu_torch.core.state import SIM_FIELDS, sim_state_from_numpy
from gym_anm_tpu_torch.core.transition import sim_reset, transition
from gym_anm_tpu_torch.envs.anm6.network import network as anm6_network


def _set_points(B, seed):
    rng = np.random.default_rng(seed)
    return dict(
        des_soc=rng.uniform(0.1, 0.9, (B, 1)),
        P_load=rng.uniform(-0.4, 0.0, (B, 3)),
        P_pot=rng.uniform(0.0, 0.5, (B, 2)),
        P_set_gen=rng.uniform(0.0, 0.5, (B, 2)),
        Q_set_gen=rng.uniform(-0.3, 0.3, (B, 2)),
        P_set_des=rng.uniform(-0.4, 0.4, (B, 1)),
        Q_set_des=rng.uniform(-0.3, 0.3, (B, 1)),
    )


def _grids():
    spec, _ = build_grid(anm6_network, 0.25, 100, dtype=np.float64)
    jspec, _ = jax_build_grid(jax_anm6_network, 0.25, 100, dtype=np.float64)
    return GridTensors.from_spec(spec, "cpu", torch.float64), jspec


def _assert_states_close(ours, theirs, tol):
    theirs = sim_state_from_numpy({k: np.asarray(getattr(theirs, k)) for k in SIM_FIELDS}, dtype=torch.float64)
    for k in SIM_FIELDS:
        a, b = getattr(ours, k).numpy(), getattr(theirs, k).numpy()
        if k == "pfe_converged":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=k)


def test_transition_matches_jax_f64():
    g, jspec = _grids()
    args = _set_points(64, 2)
    kw = dict(x_tol=1e-9, max_iter=20)
    res = transition(g, **{k: torch.tensor(v) for k, v in args.items()}, pf_method="tree", **kw)
    jres = jax.jit(lambda a: jax_transition(jspec, **a, pf_method="tree", **kw))(args)
    assert np.asarray(jres.pfe_converged).mean() > 0.5
    np.testing.assert_array_equal(res.pfe_converged.numpy(), np.asarray(jres.pfe_converged))
    _assert_states_close(res.state, jres.state, 1e-9)
    for k in ("reward", "e_loss", "penalty"):
        np.testing.assert_allclose(
            getattr(res, k).numpy(), np.asarray(getattr(jres, k)), rtol=1e-9, atol=1e-9, err_msg=k
        )


def test_sim_reset_matches_jax_f64():
    g, jspec = _grids()
    rng = np.random.default_rng(5)
    B, d = 32, jspec.n_dev
    s0 = np.zeros((B, 2 * d + jspec.n_des + jspec.n_gen + 1))
    s0[:, :d] = rng.uniform(-20.0, 20.0, (B, d))
    s0[:, d : 2 * d] = rng.uniform(-10.0, 10.0, (B, d))
    s0[:, 2 * d :] = rng.uniform(0.0, 40.0, (B, s0.shape[1] - 2 * d))
    kw = dict(x_tol=1e-9, max_iter=20)
    ours = sim_reset(g, torch.tensor(s0), pf_method="tree", **kw)
    theirs = jax.jit(lambda s: jax_sim_reset(jspec, s, pf_method="tree", **kw))(s0)
    _assert_states_close(ours, theirs, 1e-9)


def test_transition_rejects_other_methods_and_meshed_grids():
    g, _ = _grids()
    args = {k: torch.tensor(v) for k, v in _set_points(4, 0).items()}
    with pytest.raises(ValueError, match="pf_method"):
        transition(g, **args, pf_method="scan")
    meshed = dataclasses.replace(g, tree=None)
    with pytest.raises(ValueError, match="radial"):
        transition(meshed, **args)
