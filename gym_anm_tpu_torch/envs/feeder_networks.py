"""The synthetic radial feeder networks of the feeder33 and feeder141 tasks.

NumPy copies of ``gym_anm_tpu.envs.feeder33.make_feeder_network`` (a 33-bus
radial feeder with three laterals) and
``gym_anm_tpu.envs.feeder141.make_multi_feeder_network`` (141 buses on four
trunks with short laterals), generated deterministically from a fixed seed.
Their trees are deeper than ANM6's, so they exercise the tree solver's level
and run schedule.
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
