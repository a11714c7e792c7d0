"""Host-side elimination schedule of the tree-structured Newton-Raphson
power flow for radial networks.

A NumPy copy of ``gym_anm_tpu.ops.tree_nr.build_tree_info`` (the JAX
package cannot be imported where the port runs); a CPU test holds it equal
to the original on every field.  Distribution feeders are trees, and the
polar NR Jacobian inherits the network's sparsity: eliminating a leaf bus
touches only its parent, so the per-lane linear solve is O(n) 2x2-block
operations.  :mod:`gym_anm_tpu_torch.ops.tree_cuda` turns this schedule
into the slot layout its kernel and plain version run on.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TreeInfo:
    """Host-side elimination schedule for a radial network (all NumPy).

    Node = non-slack bus; ``m`` nodes are stored in **elimination order**
    (leaves first, grouped into contiguous levels; children always precede
    their parent).  ``eo`` index = position in this order.
    """

    n_bus: int
    bus: np.ndarray  # [m] full-bus index of node j (1..n-1)
    par_bus: np.ndarray  # [m] full-bus index of the parent (0 = slack)
    par_eo: np.ndarray  # [m] eo index of the parent; m (dummy) if slack
    has_par: np.ndarray  # [m] bool, parent is non-slack
    enum: np.ndarray  # [m] bus-1 -> eo position (inverse of ``bus - 1``)
    levels: tuple  # ((lo, hi), ...) contiguous eo ranges, leaves first
    ch_eo: np.ndarray  # [m, maxC] children eo indices, padded with m
    ch_bus: np.ndarray  # [m, maxC] children full-bus indices, padded with 0
    # Static admittance entries per node (complex split re/im):
    y_diag: np.ndarray  # [m, 2] Y[bus, bus]
    y_up: np.ndarray  # [m, 2] Y[bus, par_bus]   (row bus, col parent)
    y_down: np.ndarray  # [m, 2] Y[par_bus, bus] (row parent, col bus)
    y_ch: np.ndarray  # [m, maxC, 2] Y[bus, ch_bus] = y_down of each child, pad 0


def build_tree_info(br_f, br_t, n_bus, Y_re, Y_im):
    """Derive the elimination schedule from the branch list, or ``None``
    if the network is not a tree rooted at the slack (bus 0): wrong branch
    count, disconnected, or cyclic."""
    br_f = np.asarray(br_f)
    br_t = np.asarray(br_t)
    m = n_bus - 1
    if br_f.shape[0] != m:
        return None

    adj = [[] for _ in range(n_bus)]
    for f, t in zip(br_f.tolist(), br_t.tolist()):
        adj[f].append(t)
        adj[t].append(f)

    # BFS from the slack; a visited "child" seen twice means a cycle, and
    # with exactly n-1 edges full coverage implies a tree.
    parent_bus = np.full(n_bus, -2, dtype=np.int64)
    parent_bus[0] = -1
    order = [0]
    head = 0
    while head < len(order):
        u = order[head]
        head += 1
        for w in adj[u]:
            if parent_bus[w] == -2:
                parent_bus[w] = u
                order.append(w)
    if len(order) != n_bus:
        return None  # disconnected (and therefore cyclic elsewhere)

    children_bus = [[] for _ in range(n_bus)]
    for b in range(1, n_bus):
        children_bus[parent_bus[b]].append(b)

    # Height-from-leaves levels over non-slack buses.
    height = np.zeros(n_bus, dtype=np.int64)
    for b in reversed(order):  # children before parents in reverse BFS
        if b == 0:
            continue
        hs = [height[c] for c in children_bus[b]]
        height[b] = 1 + max(hs) if hs else 0

    n_levels = int(height[1:].max()) + 1 if m else 0
    eo_bus = []  # node full-bus indices in elimination order
    levels = []
    for lv in range(n_levels):
        lo = len(eo_bus)
        eo_bus.extend(int(b) for b in range(1, n_bus) if height[b] == lv)
        levels.append((lo, len(eo_bus)))
    bus = np.asarray(eo_bus, dtype=np.int64)
    enum = np.empty(m, dtype=np.int64)
    enum[bus - 1] = np.arange(m)

    par_bus = parent_bus[bus]
    has_par = par_bus != 0
    par_eo = np.where(has_par, enum[np.maximum(par_bus - 1, 0)], m)

    maxC = max((len(children_bus[int(b)]) for b in bus), default=0)
    maxC = max(maxC, 1)  # keep the arrays non-degenerate
    ch_eo = np.full((m, maxC), m, dtype=np.int64)
    ch_bus = np.zeros((m, maxC), dtype=np.int64)
    for j, b in enumerate(bus):
        for c_i, c in enumerate(children_bus[int(b)]):
            ch_eo[j, c_i] = enum[c - 1]
            ch_bus[j, c_i] = c

    Y_re = np.asarray(Y_re, np.float64)
    Y_im = np.asarray(Y_im, np.float64)
    y2 = lambda r, c: np.stack([Y_re[r, c], Y_im[r, c]], axis=-1)
    y_diag = y2(bus, bus)
    y_up = y2(bus, par_bus)
    y_down = y2(par_bus, bus)
    y_ch = np.where((ch_bus > 0)[:, :, None], y2(bus[:, None], ch_bus), 0.0)

    return TreeInfo(
        n_bus=n_bus,
        bus=bus,
        par_bus=par_bus,
        par_eo=par_eo,
        has_par=has_par,
        enum=enum,
        levels=tuple(levels),
        ch_eo=ch_eo,
        ch_bus=ch_bus,
        y_diag=y_diag,
        y_up=y_up,
        y_down=y_down,
        y_ch=y_ch,
    )
