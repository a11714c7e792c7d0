"""The radial feeder networks of the feeder33, feeder141 and baranwu33 tasks.

NumPy copies of ``gym_anm_tpu.envs.feeder33.make_feeder_network`` (a 33-bus
radial feeder with three laterals) and
``gym_anm_tpu.envs.feeder141.make_multi_feeder_network`` (141 buses on four
trunks with short laterals), generated deterministically from a fixed seed,
and Baran and Wu's published 33-bus feeder
(:func:`make_baran_wu_33_network`).  Their trees are deeper than ANM6's, so
they exercise the tree solver's level and run schedule.
"""

from __future__ import annotations

import numpy as np


def make_feeder_network(n_bus: int = 33, seed: int = 0) -> dict:
    """Build the deterministic synthetic radial feeder network dict."""
    rng = np.random.default_rng(seed)

    # Topology: main feeder 0-1-...-k plus three laterals.
    n_main = n_bus - 12
    branches = [(i, i + 1) for i in range(n_main - 1)]
    lateral_roots = [3, 6, 9]
    b = n_main
    for root in lateral_roots:
        prev = root
        for _ in range(4):
            if b >= n_bus:
                break
            branches.append((prev, b))
            prev = b
            b += 1

    bus_rows = [[0, 0, 132, 1.0, 1.0]]
    for i in range(1, n_bus):
        bus_rows.append([i, 1, 12.66, 1.1, 0.9])

    branch_rows = []
    for f, t in branches:
        r = rng.uniform(0.01, 0.08)
        x = rng.uniform(0.02, 0.09)
        rate = 30.0 if f == 0 else rng.uniform(8.0, 15.0)
        branch_rows.append([f, t, r, x, 0.0, rate, 1, 0])

    # Devices: slack at bus 0; loads on most buses; 5 PV; 2 storage.
    dev_rows = [[0, 0, 0, None, 500, -500, 500, -500] + [None] * 7]
    dev_id = 1
    pv_buses = set(np.linspace(4, n_bus - 2, 5, dtype=int).tolist())
    des_buses = {n_main - 1, n_bus - 1}
    for i in range(1, n_bus):
        p_min = -float(np.round(rng.uniform(0.5, 3.0), 3))
        dev_rows.append([dev_id, i, -1, 0.25, 0, p_min] + [None] * 9)
        dev_id += 1
        if i in pv_buses:
            p_max = float(np.round(rng.uniform(2.0, 8.0), 3))
            dev_rows.append(
                [dev_id, i, 2, None, p_max, 0, p_max, -p_max, 0.75 * p_max, None, 0.6 * p_max, -0.6 * p_max]
                + [None] * 3
            )
            dev_id += 1
        if i in des_buses:
            dev_rows.append([dev_id, i, 3, None, 5, -5, 5, -5, 4, -4, 4, -4, 20, 0, 0.92])
            dev_id += 1

    return {
        "baseMVA": 100.0,
        "bus": np.array(bus_rows, dtype=object),
        "device": np.array(dev_rows, dtype=object),
        "branch": np.array(branch_rows, dtype=object),
    }


def make_multi_feeder_network(
    n_bus: int = 141,
    seed: int = 0,
    n_trunks: int = 4,
    lateral_len: int = 4,
    lateral_every: int = 3,
) -> dict:
    """Deterministic synthetic multi-trunk network dict.

    Bus 0 is the 132 kV slack substation; ``n_trunks`` 12.66 kV trunks leave
    it. Along each trunk a ``lateral_len``-bus lateral is attached every
    ``lateral_every`` chain buses until the bus budget is exhausted.
    """
    rng = np.random.default_rng(seed)

    # ---- topology ------------------------------------------------------
    branches = []  # (from, to, is_trunk)
    parent = {0: None}
    next_bus = 1
    budget = n_bus - 1
    per_trunk = [budget // n_trunks + (1 if i < budget % n_trunks else 0) for i in range(n_trunks)]
    for trunk_budget in per_trunk:
        remaining = trunk_budget
        prev = 0
        chain_pos = 0
        while remaining > 0:
            # Extend the trunk chain.
            branches.append((prev, next_bus, True))
            parent[next_bus] = prev
            prev = next_bus
            next_bus += 1
            remaining -= 1
            chain_pos += 1
            if chain_pos % lateral_every == 0 and remaining > 0:
                lp = prev
                for _ in range(min(lateral_len, remaining)):
                    branches.append((lp, next_bus, False))
                    parent[next_bus] = lp
                    lp = next_bus
                    next_bus += 1
                    remaining -= 1
    assert next_bus == n_bus

    bus_rows = [[0, 0, 132, 1.0, 1.0]]
    for i in range(1, n_bus):
        bus_rows.append([i, 1, 12.66, 1.1, 0.9])

    # ---- devices -------------------------------------------------------
    # Loads on every non-slack bus; PV on every 8th bus; storage at the
    # ends of the four trunks.
    dev_rows = [[0, 0, 0, None, 500, -500, 500, -500] + [None] * 7]
    dev_id = 1
    load_peak = np.zeros(n_bus)  # |p_min| in MW, for rating computation
    pv_peak = np.zeros(n_bus)
    trunk_ends = []
    trunk_bus = {b for f, t, is_trunk in branches if is_trunk for b in (t,)}
    # The last trunk bus of each trunk: track while building was easier,
    # recompute: a trunk bus whose children contain no trunk bus.
    children = {}
    for f, t, _ in branches:
        children.setdefault(f, []).append(t)
    for b in sorted(trunk_bus):
        if not any(c in trunk_bus for c in children.get(b, [])):
            trunk_ends.append(b)

    for i in range(1, n_bus):
        p_min = -float(np.round(rng.uniform(0.25, 1.25), 3))
        load_peak[i] = -p_min
        dev_rows.append([dev_id, i, -1, 0.25, 0, p_min] + [None] * 9)
        dev_id += 1
        if i % 8 == 0:
            p_max = float(np.round(rng.uniform(1.0, 5.0), 3))
            pv_peak[i] = p_max
            dev_rows.append(
                [dev_id, i, 2, None, p_max, 0, p_max, -p_max, 0.75 * p_max, None, 0.6 * p_max, -0.6 * p_max]
                + [None] * 3
            )
            dev_id += 1
    for i in trunk_ends[: max(2, n_trunks)]:
        dev_rows.append([dev_id, i, 3, None, 4, -4, 4, -4, 3, -3, 3, -3, float(np.round(rng.uniform(10, 30), 1)), 0, 0.92])
        dev_id += 1

    # ---- branch impedances and ratings ---------------------------------
    # Rating = margin x the larger of downstream peak load and downstream
    # peak PV (reverse flow), in MVA (loads carry Q = 0.25 P).
    subtree_load = load_peak.copy()
    subtree_pv = pv_peak.copy()
    for f, t, _ in reversed(branches):  # children appear after parents
        subtree_load[f] += subtree_load[t]
        subtree_pv[f] += subtree_pv[t]

    branch_rows = []
    q_factor = float(np.sqrt(1 + 0.25**2))
    for f, t, is_trunk in branches:
        if is_trunk:
            r = rng.uniform(0.008, 0.03)
            x = rng.uniform(0.015, 0.045)
        else:
            r = rng.uniform(0.02, 0.07)
            x = rng.uniform(0.03, 0.08)
        flow = max(subtree_load[t] * q_factor, subtree_pv[t], 0.5)
        rate = float(np.round(1.4 * flow, 2))
        branch_rows.append([f, t, float(np.round(r, 5)), float(np.round(x, 5)), 0.0, rate, 1, 0])

    return {
        "baseMVA": 100.0,
        "bus": np.array(bus_rows, dtype=object),
        "device": np.array(dev_rows, dtype=object),
        "branch": np.array(branch_rows, dtype=object),
    }


# Baran and Wu's 33-bus feeder (M. E. Baran and F. F. Wu, "Network
# reconfiguration in distribution systems for loss reduction and load
# balancing", IEEE Trans. Power Delivery 4(2):1401-1407, 1989; MATPOWER's
# case33bw), as published: 12.66 kV, radial, the five tie switches open.
# One row a sectionalizing branch, buses 1-based: (from, to, R ohm, X ohm,
# P kW, Q kVAr), the load sitting at the "to" bus.  3,715 kW and 2,300 kVAr.
BARAN_WU_33 = (
    (1, 2, 0.0922, 0.0470, 100, 60), (2, 3, 0.4930, 0.2511, 90, 40), (3, 4, 0.3660, 0.1864, 120, 80),
    (4, 5, 0.3811, 0.1941, 60, 30), (5, 6, 0.8190, 0.7070, 60, 20), (6, 7, 0.1872, 0.6188, 200, 100),
    (7, 8, 0.7114, 0.2351, 200, 100), (8, 9, 1.0300, 0.7400, 60, 20), (9, 10, 1.0440, 0.7400, 60, 20),
    (10, 11, 0.1966, 0.0650, 45, 30), (11, 12, 0.3744, 0.1238, 60, 35), (12, 13, 1.4680, 1.1550, 60, 35),
    (13, 14, 0.5416, 0.7129, 120, 80), (14, 15, 0.5910, 0.5260, 60, 10), (15, 16, 0.7463, 0.5450, 60, 20),
    (16, 17, 1.2890, 1.7210, 60, 20), (17, 18, 0.7320, 0.5740, 90, 40), (2, 19, 0.1640, 0.1565, 90, 40),
    (19, 20, 1.5042, 1.3554, 90, 40), (20, 21, 0.4095, 0.4784, 90, 40), (21, 22, 0.7089, 0.9373, 90, 40),
    (3, 23, 0.4512, 0.3083, 90, 50), (23, 24, 0.8980, 0.7091, 420, 200), (24, 25, 0.8960, 0.7011, 420, 200),
    (6, 26, 0.2030, 0.1034, 60, 25), (26, 27, 0.2842, 0.1447, 60, 25), (27, 28, 1.0590, 0.9337, 60, 20),
    (28, 29, 0.8042, 0.7006, 120, 70), (29, 30, 0.5075, 0.2585, 200, 600), (30, 31, 0.9744, 0.9630, 150, 70),
    (31, 32, 0.3105, 0.3619, 210, 100), (32, 33, 0.3410, 0.5302, 60, 40),
)
BARAN_WU_KV = 12.66
# Branch ratings in MVA, in BARAN_WU_33's order.  The publication gives none:
# each is 1.5 times the larger apparent power at the branch's two ends in the
# published base case (float64 power flow, published loads, no PV or storage
# injection), rounded up to 0.1 MVA.
BARAN_WU_RATES = (
    7.0, 6.2, 4.4, 4.2, 4.0, 1.9, 1.5, 1.2, 1.1, 1.0, 0.9, 0.8, 0.7, 0.5, 0.4, 0.3,
    0.2, 0.6, 0.5, 0.3, 0.2, 1.6, 1.5, 0.8, 2.1, 2.0, 1.9, 1.8, 1.6, 0.8, 0.5, 0.2,
)
# The ANM devices the publication does not have, 1-based buses: PV units
# (MW) at the three distributed-generation sites and sizes that
# loss-minimisation studies of this feeder report, and storage units at the
# ends of the two longest paths.
BARAN_WU_PV = ((14, 0.75), (24, 1.10), (30, 1.07))
BARAN_WU_STORAGE = (18, 33)


def make_baran_wu_33_network() -> dict:
    """Baran and Wu's 33-bus feeder as a network dict, in per unit on 100
    MVA (Z_base = 12.66^2 / 100 ohm).  Bus 1 of the
    publication is bus 0, the slack; the other buses allow |V| in [0.95,
    1.05] p.u.  A load on each of buses 1-32 draws its published P (as
    ``PMIN``) at its published Q/P; :data:`BARAN_WU_PV` adds PV units in
    feeder33's row shape and :data:`BARAN_WU_STORAGE` storage units of 0.5
    MW and 2 MWh (efficiency 0.92), feeder33's storage row scaled by 0.1;
    branches take :data:`BARAN_WU_RATES`."""
    z_base = BARAN_WU_KV**2 / 100.0
    pv = {bus - 1: p for bus, p in BARAN_WU_PV}
    des = {bus - 1 for bus in BARAN_WU_STORAGE}
    load = {t - 1: (p_kw / 1000.0, q_kvar / p_kw) for _, t, _, _, p_kw, q_kvar in BARAN_WU_33}

    bus_rows = [[0, 0, BARAN_WU_KV, 1.0, 1.0]] + [[i, 1, BARAN_WU_KV, 1.05, 0.95] for i in range(1, len(load) + 1)]
    dev_rows = [[0, 0, 0, None, 500, -500, 500, -500] + [None] * 7]
    for i in range(1, len(bus_rows)):
        p_mw, qp = load[i]
        dev_rows.append([len(dev_rows), i, -1, qp, 0, -p_mw] + [None] * 9)
        if i in pv:
            p = pv[i]
            dev_rows.append([len(dev_rows), i, 2, None, p, 0, p, -p, 0.75 * p, None, 0.6 * p, -0.6 * p] + [None] * 3)
        if i in des:
            dev_rows.append([len(dev_rows), i, 3, None, 0.5, -0.5, 0.5, -0.5, 0.4, -0.4, 0.4, -0.4, 2.0, 0, 0.92])
    branch_rows = [[f - 1, t - 1, r / z_base, x / z_base, 0.0, rate, 1, 0]
                   for (f, t, r, x, _, _), rate in zip(BARAN_WU_33, BARAN_WU_RATES)]
    return {
        "baseMVA": 100.0,
        "bus": np.array(bus_rows, dtype=object),
        "device": np.array(dev_rows, dtype=object),
        "branch": np.array(branch_rows, dtype=object),
    }
