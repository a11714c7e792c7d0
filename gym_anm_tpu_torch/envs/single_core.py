"""The program of :class:`~gym_anm_tpu_torch.envs.anm_env.ANMEnv`, without Gymnasium.

``ANMEnv`` steps one environment as a one-lane batch of its
:class:`~gym_anm_tpu_torch.core.env_core.EnvCore`.  Its device work and its
render frames are here, so that they run where Gymnasium is not installed:

* :func:`reset_lane` and :func:`step_lane` apply an initial state or take
  one step, and bring the results to the host in **one** device-to-host
  copy (on the card each separate read would be its own sync);
* :func:`render_init_args` and :func:`render_frame_args` turn the rendering
  specs and the simulator's state into the arguments of the ``init`` and
  ``update`` messages of :mod:`gym_anm_tpu_torch.render`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.env_core import EnvCore, EnvState


class LaneStep(NamedTuple):
    """One step's results on the host (float64; ``terminated`` a bool)."""

    reward: float
    terminated: bool
    e_loss: float
    penalty: float
    state: np.ndarray  # [state_n] the state vector s_t
    obs: np.ndarray  # [obs_n] the core's observation of s_t


def to_host(*tensors) -> list:
    """Tensors as flat float64 NumPy arrays, in one device-to-host copy."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
    return np.split(flat, np.cumsum([t.numel() for t in tensors])[:-1])


def reset_lane(core: EnvCore, s0) -> tuple[EnvState, bool, np.ndarray, np.ndarray]:
    """Apply one initial state vector ``s0 [k]``: the one-lane state, whether
    its load flow converged, its state vector and observation."""
    es = core.env_state_from_s0(np.asarray(s0, dtype=np.float64).reshape(1, -1))
    converged, state, obs = to_host(es.sim.pfe_converged, es.state_vec, core.observation(es))
    return es, bool(converged[0]), state, obs


def step_lane(core: EnvCore, es: EnvState, action, vars) -> tuple[EnvState, LaneStep]:
    """One step of the one-lane state ``es`` with ``action [action_n]``
    (MW/MVAr) and internal variables ``vars [vars_n]``."""
    es, out = core.step(es, np.asarray(action, dtype=np.float64).reshape(1, -1),
                        np.asarray(vars, dtype=np.float64).reshape(1, -1))
    r, term, e_loss, penalty, state, obs = to_host(
        out.reward, out.terminated, out.e_loss, out.penalty, out.state_vec, out.obs
    )
    return es, LaneStep(float(r[0]), bool(term[0]), float(e_loss[0]), float(penalty[0]), state, obs)


def render_init_args(network_specs, costs_clipping, spec):
    """``(dev_type, p_max, q_max, s_rate, v_magn_min, v_magn_max, soc_max,
    costs_range), topology``: the arguments of the ``init`` message after
    its title (reference anm6.py:148-187), from the simulator's rendering
    specs, the cost clipping and the grid's topology."""
    dev_type = list(network_specs["dev_type"].values())
    ps, qs = [], []
    for i in network_specs["dev_p"].keys():
        p_min_max = [network_specs["dev_p"][i]["MW"][j] for j in [0, 1]]
        ps.append(np.max(np.abs(p_min_max)))
        q_min_max = [network_specs["dev_q"][i]["MVAr"][j] for j in [0, 1]]
        qs.append(np.max(np.abs(q_min_max)))
    branch_rate = [network_specs["branch_s"][br]["MVA"][1] for br in network_specs["branch_s"].keys()]
    bus_v_min = [network_specs["bus_v"][i]["pu"][0] for i in network_specs["bus_v"].keys()]
    bus_v_max = [network_specs["bus_v"][i]["pu"][1] for i in network_specs["bus_v"].keys()]
    soc_max = [network_specs["des_soc"][i]["MWh"][1] for i in network_specs["des_soc"].keys()]

    c1 = 100 if costs_clipping[0] is None or np.isinf(costs_clipping[0]) else costs_clipping[0]
    c2 = 10000 if costs_clipping[1] is None or np.isinf(costs_clipping[1]) else costs_clipping[1]
    costs_range = (c1, c2)

    # True grid graph (schema extension; see rendering.start): lets the
    # client lay out any network instead of a hand-drawn per-env SVG.
    srt = np.asarray(spec.bus_sorted)
    inv = np.empty_like(srt)
    inv[srt] = np.arange(len(srt))  # internal idx -> ascending-ID position
    topology = {
        "busOfDevice": [int(inv[b]) for b in np.asarray(spec.dev_bus)],
        "branches": [
            [int(inv[f]), int(inv[t])]
            for f, t in zip(np.asarray(spec.br_f), np.asarray(spec.br_t))
        ],
        "slackBus": int(inv[0]),  # internal order puts the slack bus first
    }
    return (dev_type, ps, qs, branch_rate, bus_v_min, bus_v_max, soc_max, costs_range), topology


def render_frame_args(simulator, e_loss, penalty):
    """``(p, q, s, soc, p_potential, bus_v_magn, costs, network_collapsed)``:
    the arguments of an ``update`` message after its date (reference
    anm6.py:89-111), from the simulator's state."""
    full_state = simulator.state
    dev_p = list(full_state["dev_p"]["MW"].values())
    dev_q = list(full_state["dev_q"]["MVAr"].values())
    branch_s = list(full_state["branch_s"]["MVA"].values())
    des_soc = list(full_state["des_soc"]["MWh"].values())
    gen_p_max = list(full_state["gen_p_max"]["MW"].values())
    bus_v_magn = list(full_state["bus_v_magn"]["pu"].values())
    return dev_p, dev_q, branch_s, des_soc, gen_p_max, bus_v_magn, [e_loss, penalty], not simulator.pfe_converged
