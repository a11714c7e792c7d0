"""The benchmark's frozen yardsticks: the card's peaks, the work an NR power
flow and a whole ANM transition need, and the rate over a window.

The counts are of the work these inputs need, not of what any kernel does: a
radial grid's Newton-Raphson step needs a tree-structured solve (2 x 2 blocks
eliminated leaf to root), so its count grows with the buses, whatever a
kernel computes.  The number of iterations is the one the plain reference
needed for the same inputs.  One operation is one floating-point add,
multiply, divide, compare, square root or trigonometric function; bytes count
each input read once and each output written once, in float32.
"""

from __future__ import annotations

import time

# NVIDIA H100 SXM, dense, as published (at the full 700 W power limit).
PEAK_FLOPS_FP32 = 67e12  # float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # HBM3
F32 = 4


def nr_eval_ops(n_bus: int, n_branch: int) -> int:
    """One mismatch evaluation: V from (theta, |V|) (4 a bus), I = Y V over
    Y's n + 2 b entries (8 a complex multiply-add), S = V conj(I) (6), the
    mismatch (2) and its inf-norm (4)."""
    S = n_bus - 1
    return 4 * S + 8 * (n_bus + 2 * n_branch) + 6 * S + 2 * S + 4 * S


def nr_step_ops(n_bus: int, n_branch: int) -> int:
    """One Newton step on a radial grid beyond the evaluation: the Jacobian's
    2 x 2 blocks (20 a diagonal block, 14 an off-diagonal one, two a
    branch), the leaf-to-root elimination (a 2 x 2 inverse 7, the parent's
    Schur update 28, the right-hand side 14), the back-substitution (14) and
    the update (2)."""
    S = n_bus - 1
    return 20 * S + 14 * 2 * n_branch + (7 + 28 + 14) * S + 14 * S + 2 * S


def power_flow_ops(n_bus: int, n_branch: int, iters: float) -> float:
    """A lane's power flow that takes ``iters`` Newton steps from a flat start."""
    return (iters + 1) * nr_eval_ops(n_bus, n_branch) + iters * nr_step_ops(n_bus, n_branch)


def power_flow_bytes(n_bus: int) -> int:
    """A lane's power flow: P and Q of the non-slack buses in; V (re, im),
    the mismatch and the iteration count out."""
    S = n_bus - 1
    return F32 * (2 * S + 2 * S + 2)


def transition_ops(n_bus, n_branch, n_load, n_gen, n_des, iters, n_rows=10) -> float:
    """A lane's whole transition: the loads (2 each), the projection of each
    controllable device onto its polygon of ``n_rows`` edges (the point, each
    edge's foot and each vertex tested against every edge: 4 a test, 8 a
    foot, 10 a vertex, 3 a distance), the state of charge (6 a unit), the bus
    sums (2 a device), the power flow, the slack (2), the branch flows (40 a
    branch), the energy loss and the penalty (4 a device, 6 a bus, 3 a
    branch)."""
    n_dev = 1 + n_load + n_gen + n_des
    pairs = n_rows * (n_rows - 1) // 2
    cands = 1 + n_rows + pairs
    project = cands * (4 * n_rows + 3) + 8 * n_rows + 10 * pairs
    return (2 * n_load + (n_gen + n_des) * project + 6 * n_des + 2 * n_dev
            + power_flow_ops(n_bus, n_branch, iters) + 2 + 40 * n_branch
            + 4 * n_dev + 6 * n_bus + 3 * n_branch)


def transition_bytes(n_bus, n_branch, n_load, n_gen, n_des) -> int:
    """A lane's whole transition: the charge, the loads, the potentials and
    the set-points in; the device P and Q, the charge, the potentials, bus V,
    I, P and Q, the branch currents and flows, the convergence, the energy
    loss, the penalty and the mismatch out."""
    n_dev = 1 + n_load + n_gen + n_des
    inputs = n_des + n_load + n_gen + 2 * (n_gen + n_des)
    outputs = 2 * n_dev + n_des + n_gen + 6 * n_bus + 9 * n_branch + 4
    return F32 * (inputs + outputs)


def roofline_pct(ops: float, nbytes: float, seconds: float) -> float | None:
    """The share of the least time the card could take (the larger of the
    operations over the float32 peak and the bytes over the bandwidth) in the
    measured ``seconds``, in percent; None without a measured time."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * max(ops / PEAK_FLOPS_FP32, nbytes / PEAK_BYTES_PER_S) / seconds


class WindowRate:
    """Work over a window: every unit of work completed between the window's
    opening and its close, over all of the window's seconds (no median of
    pieces).  The caller synchronises the device before ``close``."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.t1 = None
        self.work = 0

    def add(self, n: int) -> None:
        self.work += int(n)

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def close(self) -> None:
        self.t1 = time.perf_counter()

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def rate(self) -> float:
        return self.work / self.seconds
