"""The two team reductions the dense CUDA kernels rely on, modelled in torch
and held against the plain twins' sequential choices (numpy and torch only).

The kernels (``gym_anm_tpu_torch/csrc/nr_core.cuh``, ``step_fused.cu``) split
a lane's work over a team of T threads: thread t takes the entries t, t + T,
... (for the projection, entry 0 is the point itself and entry k + 1
candidate k), keeps the best of its own in increasing order, and the team
combines the threads' bests with XOR shuffles (partners t ^ o for
o = T/2, ..., 1).  These tests run that schedule in Python:

(a) the projection's running minimum with the (distance, entry) reduction
    picks the point ``step_cuda._project_plain``'s sequential scan picks,
    for T in {1, 8, 32}, on random polytopes with forced ties, infeasible
    and NaN candidates;
(b) the pivot search (first NaN, else first maximal |A_rk|, lowest row on
    ties) picks the row ``nr_cuda._solve_system``'s ``torch.argmax`` picks.

``tests/test_torch_cuda.py`` meets the same ties in the kernels themselves.
"""

import types

import numpy as np
import pytest
import torch

from gym_anm_tpu_torch.ops import step_cuda


EPS = 1e-5
BIG = 2**31 - 1


def _butterfly(vals, T, better):
    """The team's XOR-shuffle reduction: every thread ends with the best of
    all, where ``better(mine, other)`` says whether to take the partner's."""
    vals = list(vals)
    o = T // 2
    while o > 0:
        vals = [vals[t ^ o] if better(vals[t], vals[t ^ o]) else vals[t] for t in range(T)]
        o //= 2
    assert all(v == vals[0] or v is vals[0] for v in vals)
    return vals[0]


def _team_project(st, px, py, h, T):
    """The kernel's team projection of ``(px, py) [C, B]``.  Candidate k's
    point is what the plain twin gives with k alone: it counts where that
    run moved the point (an infeasible point is never a feasible
    candidate's).  The point's own entry, d = 0 when it is feasible, is
    left at d = inf: where the point is feasible no candidate counts and
    every thread keeps the point anyway."""
    entries = []
    for c in st.structure.cand:
        one = types.SimpleNamespace(f=st.f, eps=st.eps, structure=types.SimpleNamespace(cand=(c,)))
        x, y = step_cuda._project_plain(one, px, py, h)
        dx, dy = x - px, y - py
        d = dx * dx + dy * dy
        entries.append((x, y, d, d > 0))
    inf = torch.full_like(px, float("inf"))
    bests = []
    for t in range(T):
        bx, by, bd = px, py, inf
        bi = torch.full(px.shape, -1 if t == 0 else BIG)
        for k in range(T - 1 if t == 0 else t - 1, len(entries), T):
            x, y, d, ok = entries[k]
            take = ok & (d < bd)
            bx, by, bd = torch.where(take, x, bx), torch.where(take, y, by), torch.where(take, d, bd)
            bi = torch.where(take, k, bi)
        bests.append((bx, by, bd, bi))
    o = T // 2
    while o > 0:
        nxt = []
        for t in range(T):
            a, b = bests[t], bests[t ^ o]
            take = (b[2] < a[2]) | ((b[2] == a[2]) & (b[3] < a[3]))
            nxt.append(tuple(torch.where(take, v, u) for u, v in zip(a, b)))
        bests, o = nxt, o // 2
    return bests[0][0], bests[0][1]


def _random_polytopes(rng, C, R):
    """Capability-like polytopes: random normals, with duplicated rows (equal
    feet, parallel pairs), rows along the axes, a NaN normal and an infinite
    right-hand side.  The last device is a roof y <= 1 -+ 1e-6 x over a box:
    its apex is a vertex of two nearly parallel rows, which the projection
    rejects, so a point above it lies exactly as far from the two feet onto
    the roof's sides, (+-x, y): a tie of distinct points between entries 0
    and 1 that the first entry must win."""
    G = rng.normal(size=(C, R, 2)).astype(np.float32)
    G[:, 1] = G[:, 0]  # a duplicated row
    G[:, 2:6] = np.array([[1, 0], [-1, 0], [0, 1], [0, -1]], np.float32)  # a square
    G[0, 7] = np.nan
    h0 = rng.uniform(0.1, 1.0, size=(C, R)).astype(np.float32)
    h0[:, 2:6] = 0.5
    h0[1, 8] = np.inf
    G[-1, :5] = np.array([[-1e-6, 1], [1e-6, 1], [1, 0], [-1, 0], [0, -1]], np.float32)
    h0[-1, :5] = 1.0
    h0[-1, 5:] = np.inf
    return G, h0


@pytest.mark.parametrize("T", [1, 8, 32])
def test_team_projection_picks_the_sequential_choice(T):
    rng = np.random.default_rng(T)
    C, R, B = 4, 9, 48
    G, h0 = _random_polytopes(rng, C, R)
    cand = step_cuda._candidates(G.astype(np.float64), EPS)
    st = types.SimpleNamespace(
        f={"Gx": torch.tensor(G[:, :, 0]), "Gy": torch.tensor(G[:, :, 1])}, eps=EPS,
        structure=types.SimpleNamespace(cand=cand),
    )
    h = np.repeat(h0[:, :, None], B, axis=2)
    h[:-1, 0] = rng.uniform(-0.2, 0.8, size=(C - 1, B))  # a cap that may empty the set
    px = rng.uniform(-1.5, 1.5, size=(C, B)).astype(np.float32)
    py = rng.uniform(-1.5, 1.5, size=(C, B)).astype(np.float32)
    px[:, :8] = np.where(np.arange(8) < 4, 0.0, 3.0)  # points symmetric about the square
    py[:, :8] = 0.0
    px[2, 8] = np.nan  # NaN distances everywhere
    px[-1, 8:16] = 0.0  # above the roof's apex
    py[-1, 8:16] = np.linspace(2.0, 9.0, 8, dtype=np.float32)
    args = torch.tensor(px), torch.tensor(py), torch.tensor(h)
    bx, by = step_cuda._project_plain(st, *args)
    x, y = _team_project(st, *args, T)
    np.testing.assert_array_equal(torch.stack([x, y]).numpy(), torch.stack([bx, by]).numpy())
    moved = (bx != args[0]) | (by != args[1])
    assert bool(moved.any()) and not bool(moved.all())  # both the point itself and candidates won
    assert bool((bx[-1, 8:16] > 0).all())  # the tie went to the first side's foot


def _team_pivot(col, k, T):
    """The kernel's pivot row for column ``col`` at step k."""
    nn = len(col)
    bests = []
    for t in range(T):
        best = (0, -1.0, BIG)  # (NaN flag, |A_rk|, row)
        for r in range(t, nn, T):
            if r >= k and not best[0]:
                v = abs(col[r])
                if np.isnan(v):
                    best = (1, v, r)
                elif v > best[1]:
                    best = (0, v, r)
        bests.append(best)

    def better(a, b):
        if a[0] != b[0]:
            return b[0] > a[0]
        if a[0]:
            return b[2] < a[2]
        return b[1] > a[1] or (b[1] == a[1] and b[2] < a[2])

    return _butterfly(bests, T, better)[2]


@pytest.mark.parametrize("T", [1, 8, 32])
def test_team_pivot_picks_the_argmax_row(T):
    rng = np.random.default_rng(100 + T)
    nn, B = 40, 64
    A = rng.normal(size=(nn, B)).astype(np.float32)
    A[:, :16] = np.round(A[:, :16])  # many ties of |A_rk|, +0 and -0 among them
    A[:, 16:24] = -A[:, 16:24] * (rng.random((nn, 8)) < 0.5)
    A[5, 24:32] = np.nan
    A[17, 28:36] = np.nan
    A[3, 36:40] = np.inf
    A[30, 36:40] = -np.inf
    A[:, 40:44] = 0.0
    At = torch.tensor(A)
    for k in (0, 3, 5, 6, 17, 18, 31, 39):
        ref = (k + torch.argmax(At[k:, :].abs(), dim=0)).tolist()  # nr_cuda._solve_system's choice
        assert [_team_pivot(A[:, b], k, T) for b in range(B)] == ref
