"""The port's ``Simulator`` facade against the JAX package's, in float64.

* ``reset(s0)`` and one ``transition`` (dict inputs keyed by device ID, in
  MW/MVAr) on ANM6 and feeder33 from the same numpy inputs: the nested state
  dicts, the reward, energy loss, penalty and convergence flag agree to
  1e-9; the bus, device and branch views read the same values.  A current
  at the power-flow residual (|I| < 1e-6 p.u.: a bus without a device, a
  branch feeding only such buses) has no defined angle; its angle is held
  through the complex current, which agrees to 1e-9 like every other value;
* ``Y_bus``, ``get_action_space``, ``get_state_space`` and
  ``get_rendering_specs`` are equal, as are the facade's counts and view
  attributes;
* the ``simulator.components`` namespace re-exports the same names.
"""

import numpy as np
import pytest
import torch

from gym_anm_tpu.envs.anm6.network import network as jax_anm6_network
from gym_anm_tpu.envs.feeder33 import _NETWORK as JAX_F33
from gym_anm_tpu.simulator import components as jax_components
from gym_anm_tpu.simulator.facade import Simulator as JaxSimulator

from gym_anm_tpu_torch.envs.anm6.anm6_easy import make_core as anm6_make_core
from gym_anm_tpu_torch.envs.anm6.network import network as anm6_network
from gym_anm_tpu_torch.envs.feeder33 import make_core as f33_make_core
from gym_anm_tpu_torch.envs.feeder_networks import make_feeder_network
from gym_anm_tpu_torch.simulator import Simulator, components


ATOL = 1e-9
GRIDS = {
    "anm6": (anm6_network, jax_anm6_network, anm6_make_core),
    "feeder33": (make_feeder_network(), JAX_F33, f33_make_core),
}


def _assert_nested_close(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _assert_nested_close(a[k], b[k], "%s/%s" % (path, k))
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_nested_close(x, y, "%s[%d]" % (path, i))
    else:
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0, atol=ATOL, err_msg=path)


def _snapshot(sim):
    """The state dict and the complex bus and branch currents of a facade."""
    hs = sim._state_arrays()
    return sim.state, {"bus": dict(zip(sim.buses, hs.bus_i[np.asarray(sim.spec.bus_sorted)])),
                       "branch": dict(zip(sim.branches, hs.br_i_from))}


def _assert_state_close(snap, jsnap):
    """State dicts within ATOL, current angles only where |I| is above the
    power-flow residual, and the complex currents within ATOL."""
    (state, cur), (jstate, jcur) = snap, jsnap
    _assert_nested_close(cur, jcur)
    tiny = {k: {i for i, v in c.items() if abs(v) < 1e-6} for k, c in jcur.items()}
    keep = {"bus_i_ang": tiny["bus"], "branch_i_ang": tiny["branch"]}
    strip = lambda st: {k: ({u: {i: x for i, x in d.items() if i not in keep[k]} for u, d in v.items()}
                            if k in keep else v) for k, v in st.items()}
    _assert_nested_close(strip(state), strip(jstate))


def _assert_nested_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _assert_nested_equal(a[k], b[k], "%s/%s" % (path, k))
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_nested_equal(x, y, "%s[%d]" % (path, i))
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=path)


@pytest.fixture(scope="module", params=list(GRIDS))
def pair(request):
    """The two facades of one grid after the same reset and transition, with
    what each returned."""
    net, jax_net, make_core = GRIDS[request.param]
    jax_sim = JaxSimulator(jax_net, delta_t=0.25, lamb=100)
    sim = Simulator(net, delta_t=0.25, lamb=100, device="cpu")
    core = make_core(torch.float64, "cpu")
    s0 = core.init_state_fn(torch.Generator().manual_seed(3), 1)[0].numpy()
    out = {"reset": (sim.reset(s0), jax_sim.reset(s0))}
    out["reset_state"] = (_snapshot(sim), _snapshot(jax_sim))

    spec = sim.spec
    rng = np.random.default_rng(5)
    d = spec.n_dev
    dev_p = dict(zip(spec.dev_ids, s0[:d]))
    p_load = {i: dev_p[i] * 0.9 for i in spec.load_ids}
    p_pot = {i: float(v) for i, v in zip(spec.gen_ids, s0[2 * d + spec.n_des:2 * d + spec.n_des + spec.n_gen])}
    P_gen, Q_gen, P_des, Q_des = sim.get_action_space()
    p_set = {i: rng.uniform(*P_gen[i]) for i in spec.gen_ids}
    p_set.update({i: rng.uniform(*P_des[i]) * 0.2 for i in spec.des_ids})
    q_set = {i: rng.uniform(*Q_gen[i]) * 0.2 for i in spec.gen_ids}
    q_set.update({i: rng.uniform(*Q_des[i]) * 0.2 for i in spec.des_ids})
    out["transition"] = (sim.transition(p_load, p_pot, p_set, q_set), jax_sim.transition(p_load, p_pot, p_set, q_set))
    out["transition_state"] = (_snapshot(sim), _snapshot(jax_sim))
    return sim, jax_sim, out


def test_reset_state_matches_jax(pair):
    _, _, out = pair
    assert out["reset"][0] is True and out["reset"][1] is True
    _assert_state_close(*out["reset_state"])


def test_transition_matches_jax(pair):
    _, _, out = pair
    (_, r, e, p, conv), (_, jr, je, jp, jconv) = out["transition"]
    assert conv == jconv
    _assert_state_close(*out["transition_state"])
    np.testing.assert_allclose([r, e, p], [jr, je, jp], rtol=0, atol=ATOL)


def test_views_read_the_state(pair):
    sim, jax_sim, _ = pair
    for k, bus in sim.buses.items():
        jb = jax_sim.buses[k]
        np.testing.assert_allclose([bus.v, bus.i, bus.p, bus.q], [jb.v, jb.i, jb.p, jb.q], rtol=0, atol=ATOL)
        for a in ("id", "type", "baseKV", "is_slack", "v_min", "v_max", "p_min", "p_max", "q_min", "q_max"):
            assert getattr(bus, a) == getattr(jb, a), (k, a)
    for k, dev in sim.devices.items():
        jd = jax_sim.devices[k]
        np.testing.assert_allclose([dev.p, dev.q], [jd.p, jd.q], rtol=0, atol=ATOL)
        for a in ("soc", "p_pot"):
            v, jv = getattr(dev, a), getattr(jd, a)
            assert (v is None) == (jv is None)
            if v is not None:
                np.testing.assert_allclose(v, jv, rtol=0, atol=ATOL)
    for k, br in sim.branches.items():
        jb = jax_sim.branches[k]
        got = [br.i_from, br.i_to, br.p_from, br.q_from, br.p_to, br.q_to, br.s_apparent_max]
        want = [jb.i_from, jb.i_to, jb.p_from, jb.q_from, jb.p_to, jb.q_to, jb.s_apparent_max]
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert sim.pfe_converged == jax_sim.pfe_converged


def test_static_surface_equals_jax(pair):
    sim, jax_sim, _ = pair
    for a in ("baseMVA", "N_bus", "N_device", "N_load", "N_non_slack_gen", "N_des", "N_gen_rer"):
        assert getattr(sim, a) == getattr(jax_sim, a), a
    assert list(sim.buses) == list(jax_sim.buses)
    assert list(sim.devices) == list(jax_sim.devices)
    assert list(sim.branches) == list(jax_sim.branches)
    np.testing.assert_array_equal(sim.Y_bus.toarray(), jax_sim.Y_bus.toarray())
    assert sim.Y_bus.format == "csc"
    _assert_nested_equal(sim.get_action_space(), jax_sim.get_action_space())
    _assert_nested_equal(sim.get_state_space(), jax_sim.get_state_space())
    _assert_nested_equal(sim.get_rendering_specs(), jax_sim.get_rendering_specs())


def test_components_namespace():
    assert sorted(components.__all__) == sorted(jax_components.__all__)
    from gym_anm_tpu_torch.simulator.facade import BranchView, BusView, DeviceView

    assert (components.Bus, components.Device, components.TransmissionLine) == (BusView, DeviceView, BranchView)
    assert components.BUS_H == jax_components.BUS_H and components.STATE_VARIABLES == jax_components.STATE_VARIABLES


def test_state_unset_before_reset():
    sim = Simulator(anm6_network, delta_t=0.25, lamb=100, device="cpu")
    assert sim.state is None
    with pytest.raises(RuntimeError, match="unset"):
        sim.buses[0].v
