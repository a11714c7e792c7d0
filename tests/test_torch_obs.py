"""Packed observables and observations of the port against the JAX package's.

* ``pack_observables`` and ``GatherSpec.__call__`` against
  ``gym_anm_tpu.core.obs`` in float64, on ANM6 and feeder33, for a state
  with every field random (so that every packed key, every unit and every
  clip bound is exercised) and a few lanes terminated;
* ``EnvCore.observation`` with an ``obs_values`` list covering every packed
  key against the JAX package's core, to 1e-12; the fully observable path
  (the tasks' ``state_values_spec``), a callable ``obs_fn`` and no
  specification at all.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gym_anm_tpu.core.env_core import EnvCore as JaxEnvCore, EnvState as JaxEnvState
from gym_anm_tpu.core.grid import build_grid as jax_build_grid
from gym_anm_tpu.core.obs import compile_gather as jax_compile_gather, pack_observables as jax_pack
from gym_anm_tpu.core.state import SimState as JaxSimState
from gym_anm_tpu.envs.anm6.network import network as jax_anm6_network
from gym_anm_tpu.envs.feeder33 import _NETWORK as JAX_F33

from gym_anm_tpu_torch.core.env_core import EnvCore, EnvState
from gym_anm_tpu_torch.core.grid import build_grid
from gym_anm_tpu_torch.core.obs import PACKED_KEYS, compile_gather, pack_observables, packed_ids, state_values_spec
from gym_anm_tpu_torch.core.state import SIM_FIELDS, sim_state_from_numpy
from gym_anm_tpu_torch.envs.anm6.network import network as anm6_network
from gym_anm_tpu_torch.envs.feeder_networks import make_feeder_network


GRIDS = {"anm6": (anm6_network, jax_anm6_network), "feeder33": (make_feeder_network(), JAX_F33)}
K = 2
B = 24
UNITS = {
    "bus_p": "MW", "bus_q": "pu", "bus_v_magn": "kV", "bus_v_ang": "degree", "bus_i_magn": "kA", "bus_i_ang": "rad",
    "dev_p": "pu", "dev_q": "MVAr", "des_soc": "MWh", "gen_p_max": "MW", "branch_p": "MW", "branch_q": "pu",
    "branch_s": "MVA", "branch_i_magn": "pu", "branch_i_ang": "degree", "aux": None,
}


def _specs(name):
    net, jnet = GRIDS[name]
    return build_grid(net, 0.25, 100, dtype=np.float64)[0], jax_build_grid(jnet, 0.25, 100, dtype=np.float64)[0]


def _obs_values(spec):
    """Every packed key, every second ID (all of them for short lists), in
    reverse order so that the gather is not the identity."""
    ids = packed_ids(spec, K)
    out = []
    for key in PACKED_KEYS:
        sel = list(ids[key]) if len(ids[key]) <= 2 else list(ids[key])[::-2]
        out.append((key, sel, UNITS[key]))
    return out


def _random_sim(spec, seed=0):
    """Every SimState field random, a few voltages and currents large enough
    that the clip bounds bite."""
    rng = np.random.default_rng(seed)
    n, d, b = spec.n_bus, spec.n_dev, spec.n_branch
    width = {"dev": d, "des": spec.n_des, "gen": spec.n_gen, "bus": n, "br_": b}
    sim = {}
    for f in SIM_FIELDS:
        if f == "pfe_converged":
            sim[f] = rng.uniform(size=B) > 0.2
            continue
        sim[f] = rng.normal(scale=2.0, size=(B, width[f[:3]]))
    aux = rng.uniform(0, 120, size=(B, K))
    return sim, aux


@pytest.mark.parametrize("name", ["anm6", "feeder33"])
def test_pack_observables_and_gather_match_jax_f64(name):
    spec, jspec = _specs(name)
    sim, aux = _random_sim(spec)
    bus_sorted = torch.as_tensor(np.asarray(spec.bus_sorted, dtype=np.int64))
    ours = pack_observables(spec, sim_state_from_numpy(sim, "cpu", torch.float64), torch.tensor(aux), bus_sorted)
    theirs = np.asarray(jax_pack(jspec, JaxSimState(**{k: jnp.asarray(v) for k, v in sim.items()}), aux))
    assert ours.shape == theirs.shape == (B, sum(len(v) for v in packed_ids(spec, K).values()))
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-12)
    values = _obs_values(spec)
    g, jg = compile_gather(spec, values, K), jax_compile_gather(jspec, values, K)
    for clip in (False, True):
        got = g(ours, clip=clip).numpy()
        np.testing.assert_allclose(got, np.asarray(jg(jnp.asarray(theirs), clip=clip)), rtol=0, atol=1e-12)
    clipped = g(ours, clip=True).numpy()
    assert (clipped != g(ours).numpy()).any() and np.isfinite(clipped).all()


@pytest.mark.parametrize("name", ["anm6", "feeder33"])
def test_observation_matches_jax_f64(name):
    """Every packed key through ``EnvCore.observation``, zeros on terminated
    lanes, as the JAX package's core computes it."""
    spec, jspec = _specs(name)
    values = _obs_values(spec)
    aux_bounds = np.array([[0.0, 95.0]] * K)
    core = EnvCore(spec, K, 0.995, "cpu", torch.float64, obs_values=values, aux_bounds=aux_bounds)
    jcore = JaxEnvCore(jspec, K, 0.995, obs_values=values, aux_bounds=aux_bounds)
    assert core.obs_n == jcore.obs_n and not core._obs_is_state and not core.obs_from_state_vec
    sim, aux = _random_sim(spec, 1)
    term = ~sim["pfe_converged"]
    state_vec = np.random.default_rng(2).normal(size=(B, core.state_n))
    es = EnvState(sim_state_from_numpy(sim, "cpu", torch.float64), torch.tensor(aux), torch.tensor(term),
                  torch.tensor(state_vec))
    jes = JaxEnvState(JaxSimState(**{k: jnp.asarray(v) for k, v in sim.items()}), jnp.asarray(aux),
                      jnp.asarray(term), jnp.asarray(state_vec))
    ours, theirs = core.observation(es).numpy(), np.asarray(jcore.observation(jes))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-12)
    assert term.any() and not ours[term].any() and ours[~term].any()

    # Fully observable: the clipped state vector; a callable; nothing.
    full = EnvCore(spec, K, 0.995, "cpu", torch.float64, obs_values=state_values_spec(spec, K), aux_bounds=aux_bounds)
    jfull = JaxEnvCore(jspec, K, 0.995, obs_values=state_values_spec(spec, K), aux_bounds=aux_bounds)
    assert full._obs_is_state and full.obs_from_state_vec and full.obs_n == full.state_n
    np.testing.assert_allclose(full.observation(es).numpy(), np.asarray(jfull.observation(jes)), rtol=0, atol=1e-12)
    fn = EnvCore(spec, K, 0.995, "cpu", torch.float64, obs_fn=lambda s: s[:, 0])
    np.testing.assert_array_equal(fn.observation(es).numpy(), np.where(term, 0.0, state_vec[:, 0])[:, None])
    bare = EnvCore(spec, K, 0.995, "cpu", torch.float64)
    assert bare.obs_n is None and bare.obs_gather is None
    np.testing.assert_array_equal(bare.observation(es).numpy(), np.where(term[:, None], 0.0, state_vec))


def test_task_cores_are_fully_observable():
    from gym_anm_tpu_torch import check

    for env in ("anm6easy", "feeder33"):  # feeder141 is built by feeder33's make_core
        core = check.task_make_core(env)(dtype=torch.float32, device="cpu")
        assert core.obs_values == state_values_spec(core.spec, core.K)
        assert core._obs_is_state and core.obs_n == core.state_n
        assert dataclasses.is_dataclass(core.obs_gather)
