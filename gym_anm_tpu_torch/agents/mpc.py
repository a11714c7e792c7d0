"""MPC DC-OPF baseline agents on tensors.

The counterpart of ``gym_anm_tpu.agents.mpc`` (itself a re-design of the
reference's CVXPY policy, ``gym_anm/agents/mpc.py:8-441``).  The N-stage
DC-OPF is assembled **once** on the host as a dense linear program

    min  q^T z   s.t.   l <= A z <= u

(the branch-overflow penalty ``max(0, |P_ij| - beta * rate)`` linearized
with per-branch slack variables), and solved by an OSQP-style ADMM whose KKT
matrix ``sigma*I + A^T diag(rho) A`` is factorized once per chunk of
iterations.  :meth:`MPCAgent.solve_batch` solves B lanes (one per
environment) at once on the agent's ``device``: the per-lane bounds are
assembled there, each chunk inverts the B KKT matrices through their
Cholesky factors, runs its iterations as batched matrix products and
rebalances each lane's rho from its residuals.  A final active-set "polish"
on the host recovers the exact LP vertex.

Per-stage variables, mirroring mpc.py:202-319:
``z_s = [theta (n_bus), P_dev (n_dev), p_ch (n_des), p_dis (n_des),
soc (n_des), t (n_branch)]`` with constraints:

* DC flow balance  sum_ij B_ij (theta_i - theta_j) = sum_d P_d  (mpc.py:241-253)
* loads pinned to forecasts                                     (mpc.py:255-259)
* generator / storage P bounds                                  (mpc.py:261-273)
* generation <= forecasted potential                            (mpc.py:275-279)
* P_des = p_dis - p_ch, SoC recursion with efficiency, SoC box  (mpc.py:281-295)
* |theta| <= pi, slack angle = 0                                (mpc.py:297-302)
* t >= 0, t >= +-P_branch - beta*rate  (linearized penalty)     (mpc.py:304-314)

Objective: sum_s gamma^s [ sum_{non-renewable gens} P + lamb * sum_br t ]
(mpc.py:304-314).  Action extraction: stage-0 P for non-slack generators
and storage, Q = 0, scaled to MW and clipped (mpc.py:372-393).

Reference quirk reproduced: the slack-angle constraint indexes ``theta``
with the slack *device* mapping position, not the slack bus position
(mpc.py:302) -- identical whenever the slack device is device 0 on bus 0.

The solver runs in float32 (``solver_x64=False``) or float64, both native
on the card.  Every contraction of the agent runs with TF32 off (scoped by
:func:`~gym_anm_tpu_torch.ops.precision.full_precision`, the previous
setting restored afterwards): the KKT factorizations are one-shot, and
TF32's 10-bit mantissa can make them indefinite.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.precision import full_precision, in_full_precision  # noqa: F401 (full_precision: re-exported)
from ..parallel.sharding import all_gather


def inv_spd(K):
    """Batched inverse of symmetric positive-definite matrices ``[..., n, n]``
    through their Cholesky factors and two triangular solves against I.  A
    matrix that is not positive definite gives NaN (no exception, no host
    sync), as ``jnp.linalg.cholesky`` does."""
    L, info = torch.linalg.cholesky_ex(K)
    L = torch.where((info != 0)[..., None, None], torch.full_like(L, float("nan")), L)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device).expand_as(K)
    h = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.linalg.solve_triangular(L.mT, h, upper=True)


class IterationGraph:
    """Runs an ADMM iteration ``state = step(consts, *state)`` many times.

    On the CPU this is a plain loop.  On a CUDA device the loop is bound by
    the host's launches (a dozen to sixty small kernels an iteration), so the
    first run does ``iters`` iterations eagerly (which also warms the
    libraries up) and captures the next ``iters`` into a CUDA graph that reads
    its constants (the chunk's KKT factors, rho, the bounds) and its state
    from buffers of its own and advances the state in place.  Each run then
    copies its constants and state in and replays the graph as often as it
    fits; the remainder runs eagerly.  A replay launches the eager loop's
    kernels on the same values.  ``iters=0`` keeps the plain loop."""

    def __init__(self, step, iters):
        self.step, self.iters, self.graph = step, int(iters), None

    def run(self, consts, state, n):
        k = self.iters
        if not k or state[0].device.type != "cuda" or (self.graph is None and n < 2 * k):
            for _ in range(n):
                state = self.step(consts, *state)
            return state
        if self.graph is None:
            for _ in range(k):
                state = self.step(consts, *state)
            n -= k
            self.consts = tuple(c.clone() for c in consts)
            self.state = tuple(t.clone() for t in state)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                out = self.state
                for _ in range(k):
                    out = self.step(self.consts, *out)
                for buf, t in zip(self.state, out):
                    buf.copy_(t)
        else:
            for buf, c in zip(self.consts, consts):
                buf.copy_(c)
            for buf, t in zip(self.state, state):
                buf.copy_(t)
        reps, rest = divmod(n, k)
        for _ in range(reps):
            self.graph.replay()
        state = self.state
        for _ in range(rest):
            state = self.step(consts, *state)
        return state


def _numpy(a, dtype=np.float64):
    """A host float64 array from a tensor (any device) or an array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


class MPCAgent:
    """Base class: build the parametric N-stage DC-OPF (abstract forecast()).

    Parameters mirror the reference (mpc.py:32-57): ``simulator`` (the
    :class:`~gym_anm_tpu_torch.simulator.Simulator` facade, read for its
    ``spec``, ``baseMVA`` and ``lamb``), ``action_space`` (anything with
    ``.low`` / ``.high`` in MW/MVAr, e.g. ``SimpleNamespace(low=core.action_low,
    high=core.action_high)``), ``gamma``, ``safety_margin`` (beta),
    ``planning_steps`` (N).  ``device`` is where the ADMM runs (the card
    unless the caller passes ``"cpu"``).
    """

    #: iterations of a batched ADMM chunk one CUDA graph holds (0: eager
    #: launches, see :class:`IterationGraph`).
    GRAPH_ITERS = 50

    def __init__(
        self, simulator, action_space, gamma, safety_margin=0.9, planning_steps=1, solver_x64=False,
        warm_start=False, warm_shift=True, device="cuda",
    ):
        # warm_start: carry the (scaled) ADMM iterate across consecutive
        # ``act()`` calls -- the receding-horizon problems at consecutive
        # env steps differ only in a few parameter rows, so the previous
        # optimum is near-feasible and the early-exit chunk loop converges
        # in far fewer chunks.  warm_shift additionally realigns the carry
        # by one stage (stage s <- s+1, last stage duplicated, duals
        # un-discounted by 1/gamma) -- the receding-horizon shift.  The
        # reference re-solves cold each step (mpc.py:372-393);
        # warm_start=False reproduces that behavior exactly.
        self.warm_start = bool(warm_start)
        self.warm_shift = bool(warm_shift)
        self._act_carry = None
        # solver_x64: run the ADMM in float64 (else float32).
        self.solver_x64 = bool(solver_x64)
        self.device = torch.device(device)
        self.dtype = torch.float64 if self.solver_x64 else torch.float32
        self.safety_margin = safety_margin
        self.baseMVA = simulator.baseMVA
        self.lamb = simulator.lamb
        self.action_space = action_space
        self.planning_steps = int(planning_steps)
        self.gamma = gamma

        spec = simulator.spec
        self.spec = spec
        self.simulator = simulator
        self.n_bus = spec.n_bus
        self.n_dev = spec.n_dev
        self.n_branch = spec.n_branch
        self.delta_t = spec.delta_t
        self.n_gen = spec.n_gen + 1  # incl. slack, as the reference counts
        self.n_des = spec.n_des
        self.n_load = spec.n_load
        self.n_rer = spec.n_rer
        self.load_ids = list(spec.load_ids)
        self.non_slack_gen_ids = list(spec.gen_ids)
        self.gen_rer_ids = list(spec.rer_ids)
        self.des_ids = list(spec.des_ids)
        self.branch_ids = list(spec.branch_ids)
        self.device_ids = list(spec.dev_ids)
        self.bus_ids = list(spec.bus_ids)
        self.gen_ids = [spec.slack_dev_id] + [i for i in spec.dev_ids if i in spec.gen_ids]
        self.slack_dev_id = spec.slack_dev_id

        # ID -> dense-position mappings (mpc.py:88-98).
        self.bus_id_mapping = {b: i for i, b in enumerate(self.bus_ids)}
        self.dev_id_mapping = {d: i for i, d in enumerate(self.device_ids)}

        # B matrix in bus-ID order (mpc.py:110-111).
        srt = np.asarray(spec.bus_sorted)
        self.B_bus = np.asarray(spec.Y_im)[np.ix_(srt, srt)]

        self._build_lp()
        self._build_solver()
        self._build_batch_tables()

    def _tensor(self, a, dtype=None):
        """A host array as a tensor on the agent's device (solver dtype by default)."""
        return torch.as_tensor(np.asarray(a), device=self.device).to(self.dtype if dtype is None else dtype)

    # ------------------------------------------------------------------
    # LP assembly (host-side numpy, once).
    # ------------------------------------------------------------------
    def _build_lp(self):
        spec = self.spec
        nb, nd, ndes, nbr = self.n_bus, self.n_dev, self.n_des, self.n_branch
        N = self.planning_steps
        S = nb + nd + 2 * ndes + ndes + nbr  # stage width

        def off(s):
            base = s * S
            return dict(
                theta=base,
                P=base + nb,
                pch=base + nb + nd,
                pdis=base + nb + nd + ndes,
                soc=base + nb + nd + 2 * ndes,
                t=base + nb + nd + 3 * ndes,
            )

        self.stage_size = S
        self.nz = N * S

        dev_pos = self.dev_id_mapping
        bus_pos = self.bus_id_mapping
        load_pos = [dev_pos[i] for i in self.load_ids]
        gen_pos = [dev_pos[i] for i in self.non_slack_gen_ids]
        des_pos = [dev_pos[i] for i in self.des_ids]
        # Device -> bus (ID-order positions).
        srt = np.asarray(spec.bus_sorted)
        inv = np.empty_like(srt)
        inv[srt] = np.arange(len(srt))  # internal idx -> sorted position
        dev_bus_sorted = inv[np.asarray(spec.dev_bus)]

        rows_A, rows_l, rows_u = [], [], []
        # Parameter hooks: (row_index, kind, stage, local_index) where kind in
        # {"load_eq", "gen_cap", "soc_init"}; act() writes l/u there.
        self.param_rows = []

        P_gen_min = np.asarray(spec.gen_p_min)
        P_gen_max = np.asarray(spec.gen_p_max)
        P_des_min = np.asarray(spec.dev_p_min)[des_pos] if ndes else np.zeros(0)
        P_des_max = np.asarray(spec.dev_p_max)[des_pos] if ndes else np.zeros(0)
        soc_min = np.asarray(spec.des_soc_min)
        soc_max = np.asarray(spec.des_soc_max)
        eff = np.asarray(spec.des_eff)
        rates = np.asarray(spec.br_rate)
        beta = self.safety_margin
        B = self.B_bus

        def add_row(cols, vals, lo, hi):
            row = np.zeros(self.nz)
            row[np.asarray(cols, dtype=int)] = vals
            rows_A.append(row)
            rows_l.append(lo)
            rows_u.append(hi)
            return len(rows_A) - 1

        for s in range(N):
            o = off(s)
            # R1: DC flow balance per bus (mpc.py:241-253).
            for i_pos in range(nb):
                cols, vals = [], []
                for (f, t) in self.branch_ids:
                    j, k = bus_pos[f], bus_pos[t]
                    if j == i_pos:
                        cols += [o["theta"] + j, o["theta"] + k]
                        vals += [B[j, k], -B[j, k]]
                    elif k == i_pos:
                        cols += [o["theta"] + k, o["theta"] + j]
                        vals += [B[k, j], -B[k, j]]
                # minus sum of device injections at this bus
                for d_idx in range(nd):
                    if dev_bus_sorted[d_idx] == i_pos:
                        cols.append(o["P"] + d_idx)
                        vals.append(-1.0)
                # Accumulate duplicate columns.
                row = np.zeros(self.nz)
                for c, v in zip(cols, vals):
                    row[c] += v
                rows_A.append(row)
                rows_l.append(0.0)
                rows_u.append(0.0)

            # R2: loads pinned to forecast (param).
            for li, p in enumerate(load_pos):
                r = add_row([o["P"] + p], [1.0], 0.0, 0.0)
                self.param_rows.append((r, "load_eq", s, li))

            # R3/R5: gen box + potential cap (param u).
            for gi, p in enumerate(gen_pos):
                add_row([o["P"] + p], [1.0], P_gen_min[gi], P_gen_max[gi])
                r = add_row([o["P"] + p], [1.0], -np.inf, np.inf)
                self.param_rows.append((r, "gen_cap", s, gi))

            # R4: storage box.
            for di, p in enumerate(des_pos):
                add_row([o["P"] + p], [1.0], P_des_min[di], P_des_max[di])

            # R6: P_des = p_dis - p_ch (mpc.py:291).
            for di, p in enumerate(des_pos):
                add_row([o["P"] + p, o["pdis"] + di, o["pch"] + di], [1.0, -1.0, 1.0], 0.0, 0.0)

            # R7: SoC recursion (mpc.py:281-295).
            for di in range(ndes):
                cols = [o["soc"] + di, o["pch"] + di, o["pdis"] + di]
                vals = [1.0, -self.delta_t * eff[di], self.delta_t / eff[di]]
                if s == 0:
                    r = add_row(cols, vals, 0.0, 0.0)
                    self.param_rows.append((r, "soc_init", s, di))
                else:
                    cols.append(off(s - 1)["soc"] + di)
                    vals.append(-1.0)
                    add_row(cols, vals, 0.0, 0.0)

            # R8: SoC box.
            for di in range(ndes):
                add_row([o["soc"] + di], [1.0], soc_min[di], soc_max[di])

            # R9: theta box (mpc.py:297-299).
            for i_pos in range(nb):
                add_row([o["theta"] + i_pos], [1.0], -np.pi, np.pi)

            # R10: slack angle = 0, using the reference's device-position
            # index quirk (mpc.py:302).
            add_row([o["theta"] + self.dev_id_mapping[self.slack_dev_id]], [1.0], 0.0, 0.0)

            # R11: branch-overflow slacks: +-P_branch - t <= beta*rate.
            for bi, (f, t) in enumerate(self.branch_ids):
                j, k = bus_pos[f], bus_pos[t]
                c = B[j, k]
                add_row(
                    [o["theta"] + j, o["theta"] + k, o["t"] + bi],
                    [c, -c, -1.0],
                    -np.inf,
                    beta * rates[bi] if np.isfinite(rates[bi]) else np.inf,
                )
                add_row(
                    [o["theta"] + j, o["theta"] + k, o["t"] + bi],
                    [-c, c, -1.0],
                    -np.inf,
                    beta * rates[bi] if np.isfinite(rates[bi]) else np.inf,
                )

            # R12: nonnegativity of t, p_ch, p_dis.
            for bi in range(nbr):
                add_row([o["t"] + bi], [1.0], 0.0, np.inf)
            for di in range(ndes):
                add_row([o["pch"] + di], [1.0], 0.0, np.inf)
                add_row([o["pdis"] + di], [1.0], 0.0, np.inf)

        self.A = np.asarray(rows_A)
        self.l = np.asarray(rows_l)
        self.u = np.asarray(rows_u)

        # Objective (mpc.py:304-314): gamma^s * (non-renewable gen P + lamb * t).
        q = np.zeros(self.nz)
        nonrer_gen_pos = [dev_pos[g] for g in self.gen_ids if g not in self.gen_rer_ids]
        for s in range(N):
            o = off(s)
            for p in nonrer_gen_pos:
                q[o["P"] + p] += self.gamma**s
            for bi in range(nbr):
                q[o["t"] + bi] += self.gamma**s * self.lamb
        self.q = q
        self._off0 = off(0)

    # ------------------------------------------------------------------
    # OSQP-style ADMM solver.
    # ------------------------------------------------------------------
    def _build_solver(self, rho=0.1, sigma=1e-6, alpha=1.6, iters=4000):
        A, l, u = self.A, self.l, self.u
        m, n = A.shape

        # Ruiz equilibration (OSQP-style): diagonal E (rows) / D (cols) so
        # the scaled A has ~unit-norm rows and columns -- the decisive factor
        # for ADMM convergence speed on this LP.
        D = np.ones(n)
        E = np.ones(m)
        As = A.copy()
        for _ in range(15):
            r = np.sqrt(np.maximum(np.max(np.abs(As), axis=1), 1e-8))
            As = As / r[:, None]
            E /= r
            c = np.sqrt(np.maximum(np.max(np.abs(As), axis=0), 1e-8))
            As = As / c[None, :]
            D /= c
        self._D, self._E = D, E
        qs = D * self.q
        cost_norm = max(np.max(np.abs(qs)), 1e-6)
        self._c = 1.0 / cost_norm
        qs = qs * self._c

        self._eq_rows = (l == u) & np.isfinite(l)
        self._As = As
        self._qs = qs
        self._rho0 = rho
        self._sigma = sigma
        self._alpha = alpha
        self._chunk_iters = iters

        self._Aj = self._tensor(As)
        self._qj = self._tensor(qs)

    def _build_batch_tables(self):
        """Device tables of the batched path: the template bounds, the scales
        and the parameter rows of :meth:`solve_batch` as index tensors (the
        dense-layout ``param_rows``, shared by both backends)."""
        f64 = torch.float64
        self._l_t = self._tensor(self.l, f64)
        self._u_t = self._tensor(self.u, f64)
        self._D_t = self._tensor(self._D, f64)
        self._E_t = self._tensor(self._E, f64)
        rho0 = np.where(self._eq_rows, self._rho0 * 1e3, self._rho0)
        self._rho0_t = self._tensor(rho0)
        idx = lambda kind, k: torch.as_tensor(
            np.asarray([p[k] for p in self.param_rows if p[1] == kind], dtype=np.int64), device=self.device
        )
        self._param_idx = {
            kind: (idx(kind, 0), idx(kind, 2), idx(kind, 3)) for kind in ("load_eq", "gen_cap", "soc_init")
        }
        dp = self.dev_id_mapping
        o = self._off0["P"]
        self._act_gen = torch.as_tensor([o + dp[d] for d in self.non_slack_gen_ids], dtype=torch.int64,
                                        device=self.device)
        self._act_des = torch.as_tensor([o + dp[d] for d in self.des_ids], dtype=torch.int64, device=self.device)
        self._act_low = self._tensor(np.asarray(self.action_space.low, dtype=np.float64), f64)
        self._act_high = self._tensor(np.asarray(self.action_space.high, dtype=np.float64), f64)

    def _admm_chunk(self, ls, us, x, z, y, L, rho_vec):
        """One chunk of the single-lane ADMM with the KKT factor ``L`` (two
        triangular solves an iteration), then its scaled-space residuals."""
        A, q = self._Aj, self._qj
        sigma, alpha = self._sigma, self._alpha
        LT = L.T
        for _ in range(self._chunk_iters):
            b = sigma * x - q + A.T @ (rho_vec * z - y)
            h = torch.linalg.solve_triangular(L, b[:, None], upper=False)
            x_new = torch.linalg.solve_triangular(LT, h, upper=True)[:, 0]
            Ax = A @ x_new
            z_t = alpha * Ax + (1 - alpha) * z
            z_new = torch.clamp(z_t + y / rho_vec, ls, us)
            y = y + rho_vec * (z_t - z_new)
            x, z = x_new, z_new
        # Residuals in the scaled space (OSQP termination criteria).
        Ax = A @ x
        pri = torch.max(torch.abs(Ax - z))
        dual = torch.max(torch.abs(q + A.T @ y + sigma * x))
        return x, z, y, pri, dual

    def _factor_inv(self, rho):
        """``rho [B, m]`` -> ``K^-1 [B, n, n]`` of ``K = sigma*I + A^T diag(rho) A``.

        An explicit inverse (via the Cholesky factor), so an iteration is a
        batched matrix-vector product; ADMM tolerates the inexact solve (it
        is a fixed-point iteration) and the host path (``_admm`` +
        ``_polish``) keeps the backward-stable solves."""
        A = self._Aj
        eye = torch.eye(A.shape[1], dtype=A.dtype, device=A.device)
        K = self._sigma * eye + (A.T * rho[:, None, :]) @ A
        return inv_spd(K)

    @in_full_precision
    def _admm_batch_full(self, ls, us, x0, z0, y0, rho0, n_chunks, chunk_len, eps):
        """Batched ADMM on the device: ``ls``/``us`` ``[B, m]`` -> ``x [B, n]``.

        Runs ``n_chunks`` chunks of ``chunk_len`` iterations; after each
        chunk the per-lane rho is rebalanced from the primal/dual residual
        ratio and the per-lane KKT matrix is re-factorized (OSQP's
        adaptive-rho scheme, with no host round-trip).  Fixed iteration
        structure: converged lanes keep iterating at their fixed point (ADMM
        fixed points are rho-invariant).

        ``(x0, z0, y0, rho0)`` is the starting iterate: zeros for a cold
        start, or the previous receding-horizon solve's final iterate for a
        warm start.  Returns ``(x, z, y, rho, pri [B], dual [B])``.
        """
        A, q = self._Aj, self._qj
        sigma, alpha = self._sigma, self._alpha

        def step(consts, x, z, y):
            Kinv, rho, ls, us = consts
            b = sigma * x - q + (rho * z - y) @ A
            x_new = (Kinv @ b[:, :, None])[:, :, 0]
            Ax = x_new @ A.T
            z_t = alpha * Ax + (1 - alpha) * z
            z_new = torch.clamp(z_t + y / rho, ls, us)
            y_new = y + rho * (z_t - z_new)
            return x_new, z_new, y_new

        loop = IterationGraph(step, self.GRAPH_ITERS)
        x, z, y, rho = x0, z0, y0, rho0
        pri = dual = None
        for _ in range(n_chunks):
            x, z, y = loop.run((self._factor_inv(rho), rho, ls, us), (x, z, y), chunk_len)
            Ax = x @ A.T
            pri = torch.amax(torch.abs(Ax - z), dim=1)  # [B]
            dual = torch.amax(torch.abs(q + y @ A + sigma * x), dim=1)
            ratio = torch.sqrt(torch.clamp_min(pri, 1e-16) / torch.clamp_min(dual, 1e-16))
            ratio = torch.clamp(ratio, 1e-2, 1e2)
            conv = (pri < eps) & (dual < eps)
            rebal = (~conv) & ((ratio < 0.5) | (ratio > 2.0))
            rho = torch.where(rebal[:, None], torch.clamp(rho * ratio[:, None], 1e-6, 1e6), rho)
        return x, z, y, rho, pri, dual

    def _factor(self, rho_vec):
        K = self._sigma * np.eye(self.nz) + (self._As.T * rho_vec) @ self._As
        return np.linalg.cholesky(K)

    @in_full_precision
    def _admm(self, lv, uv, eps=1e-9, max_chunks=12, warm=None):
        """Run ADMM to convergence with warm-started chunks and adaptive rho
        (refactorizing the KKT matrix on rho updates, as OSQP does).

        ``warm`` is a scaled-space (x, z, y) carry from a previous call
        (the 4th return value); starting from it, the early-exit chunk loop
        converges in fewer chunks on receding-horizon problem sequences.
        The chunks run on the agent's device in the solver dtype.  Returns
        ``(x, z, y, carry)`` -- the first three unscaled host arrays."""
        m, n = self._As.shape
        ls, us = self._E * lv, self._E * uv
        rho_vec = np.where(self._eq_rows, self._rho0 * 1e3, self._rho0)
        L = self._factor(rho_vec)
        if warm is None:
            x = np.zeros(n)
            z = np.clip(np.zeros(m), ls, us)
            y = np.zeros(m)
        else:
            x, z, y = (_numpy(v) for v in warm)
            z = np.clip(z, ls, us)
            if not np.all(np.isfinite(x)) or not np.all(np.isfinite(y)):
                x, z, y = np.zeros(n), np.clip(np.zeros(m), ls, us), np.zeros(m)
        prev_worst = np.inf
        t = self._tensor
        for _ in range(max_chunks):
            x, z, y, pri, dual = (
                v.cpu().numpy() for v in self._admm_chunk(t(ls), t(us), t(x), t(z), t(y), t(L), t(rho_vec))
            )
            worst = max(pri, dual)
            if pri < eps and dual < eps:
                break
            if worst < 1e-6 and worst > 0.5 * prev_worst:
                break  # stalled at the residual floor; the polish finishes
            prev_worst = worst
            factor = np.sqrt(max(pri, 1e-16) / max(dual, 1e-16))
            factor = float(np.clip(factor, 1e-2, 1e2))
            if 0.5 < factor < 2.0:
                continue  # balanced: just iterate more
            rho_vec = np.clip(rho_vec * factor, 1e-6, 1e6)
            L = self._factor(rho_vec)
        # Unscale: x = D x_bar, z = E^-1 z_bar, y = E y_bar / c.
        return self._D * x, z / self._E, self._E * y / self._c, (x, z, y)

    def _polish(self, x, z, y, lv, uv, tol=1e-6):
        """Active-set refinement: solve the equality-constrained system on the
        detected active rows to recover the exact LP vertex (OSQP-style)."""
        A, q = self.A, self.q
        act_l = (z <= lv + tol) & (y < -tol / 10)
        act_u = (z >= uv - tol) & (y > tol / 10)
        eq = (lv == uv) & np.isfinite(lv)
        act = act_l | act_u | eq
        if not np.any(act):
            return x
        A_act = A[act]
        b_act = np.where(act_u[act], uv[act], lv[act])
        # KKT of min q^T x + (delta/2)||x||^2 s.t. A_act x = b_act.
        na = A_act.shape[0]
        delta = 1e-9
        KKT = np.block([[delta * np.eye(self.nz), A_act.T], [A_act, -delta * np.eye(na)]])
        rhs = np.concatenate([-q, b_act])
        try:
            sol = np.linalg.solve(KKT, rhs)
        except np.linalg.LinAlgError:
            return x
        x_p = sol[: self.nz]
        # Accept only if primal-feasible and not worse.
        Axp = A @ x_p
        feas = np.all(Axp >= lv - 1e-6) and np.all(Axp <= uv + 1e-6)
        if feas and q @ x_p <= q @ x + 1e-9:
            return x_p
        return x

    def _cold_start(self, ls, us, x_shape):
        """The cold-start iterate of the batched solve: zeros, ``z`` clipped."""
        return (
            torch.zeros(x_shape, dtype=ls.dtype, device=ls.device),
            torch.clamp(torch.zeros_like(ls), ls, us),
            torch.zeros_like(ls),
        )

    def _carry_tensors(self, warm):
        """A carry given as tensors or host arrays, on the device in the solver dtype."""
        return tuple(
            torch.as_tensor(np.array(v) if isinstance(v, np.ndarray) else v, device=self.device).to(self.dtype)
            for v in warm
        )

    def _admm_batch(self, lv, uv, eps=1e-8, max_chunks=16, chunk_len=1500, warm=None, warm_chunks=2):
        """Batched ADMM across B problem instances sharing (A, q).

        ``lv``/``uv``: float64 ``[B, m]`` tensors on the device.  Per-lane
        adaptive rho with on-device KKT refactorization between chunks.  No
        per-lane polish -- accuracy is the ADMM tolerance (eps on scaled
        residuals).

        ``warm`` is an (x, z, y) carry from a previous call (in the scaled
        space; tensors or host arrays).  A warm call starts from that
        iterate -- but with a *fresh* rho (the adaptively-rebalanced rho of
        the previous solve converges far slower on the perturbed problem
        than restarting the rho schedule) -- runs only ``warm_chunks``
        chunks, then checks the worst per-lane residual on the host and
        resumes for the full ``max_chunks`` if any lane is worse than
        ``_warm_tol`` (or restarts cold if a lane is not finite).
        Returns (x [B, n] unscaled float64 tensor, carry) -- hand the carry
        back in as ``warm`` on the next receding-horizon step.
        """
        ls = (self._E_t[None, :] * lv).to(self.dtype)  # [B, m]
        us = (self._E_t[None, :] * uv).to(self.dtype)
        n = self._As.shape[1]
        Bsz = ls.shape[0]
        rho0 = self._rho0_t.expand(Bsz, -1)
        if warm is None:
            x0, z0, y0 = self._cold_start(ls, us, (Bsz, n))
            chunks = max_chunks
        else:
            x0, z0, y0 = self._carry_tensors(warm)
            z0 = torch.clamp(z0, ls, us)
            chunks = warm_chunks
        x, z, y, rho, pri, dual = self._admm_batch_full(ls, us, x0, z0, y0, rho0, chunks, chunk_len, eps)
        if warm is not None:
            worst = float(torch.max(torch.maximum(pri, dual)))
            if not np.isfinite(worst):
                # A non-finite iterate poisons ADMM permanently (NaN
                # propagates through every subsequent matvec), so resuming
                # from it can never recover: restart the full budget from
                # the cold-start iterate with a fresh rho schedule.
                x0, z0, y0 = self._cold_start(ls, us, (Bsz, n))
                x, z, y, rho, pri, dual = self._admm_batch_full(ls, us, x0, z0, y0, rho0, max_chunks, chunk_len, eps)
            elif worst > self._warm_tol:
                x, z, y, rho, pri, dual = self._admm_batch_full(ls, us, x, z, y, rho, max_chunks, chunk_len, eps)
        return x.to(torch.float64) * self._D_t[None, :], (x, z, y)

    def _shift_warm_carry(self, carry):
        """Receding-horizon realignment of a scaled ADMM carry: stage s
        takes stage s+1's iterate (the plan the previous solve made for
        this wall-clock step), the last stage duplicates, and the duals are
        un-discounted by 1/gamma (stage s's objective weight is gamma^s, so
        the shifted multipliers were scaled for gamma^(s+1)).  The scaled
        space commutes with the shift because the Ruiz scales are
        stage-uniform (tiled per stage).  Tensors stay tensors, host arrays
        host arrays."""
        N = self.planning_steps
        if N == 1:
            return carry

        x, z, y = carry
        cat = torch.cat if isinstance(x, torch.Tensor) else np.concatenate
        # Banded carries are already stage-major [B, N, rows]; dense ones
        # are flat [B, N*rows] (or [N*rows] from the single-env path) with
        # stage-major row blocks (_build_lp builds rows per stage).
        if x.ndim == 3:
            xs = cat([x[:, 1:], x[:, -1:]], 1)
            zs = cat([z[:, 1:], z[:, -1:]], 1)
            ys = cat([y[:, 1:], y[:, -1:]], 1) / self.gamma
            return (xs, zs, ys)

        def sh(a):
            shp = tuple(a.shape)
            rows = shp[-1] // N
            a3 = a.reshape(shp[:-1] + (N, rows))
            a3 = cat([a3[..., 1:, :], a3[..., -1:, :]], -2)
            return a3.reshape(shp)

        return (sh(x), sh(z), sh(y) / self.gamma)

    @property
    def _warm_tol(self):
        """Residual acceptance threshold for warm-started batched solves, in
        the scaled space: float32 cannot reach the float64 residual floor,
        so the bar depends on the solver dtype (warm actions match cold
        solves to 2e-2 MW after real receding-horizon steps in the JAX
        package's calibration; the DC-OPF is degenerate, so different
        optimal vertices can differ more than the residual tolerance
        suggests)."""
        return 5e-5 if self.dtype == torch.float64 else 5e-4

    def _polish_batch(self, X, carry, LV, UV):
        """Per-lane active-set polish of a batched solve on the host in
        float64 (overridden by the banded backend with a sparse-KKT
        version).  Takes tensors or host arrays; returns a host array."""
        X = _numpy(X)
        if getattr(self, "A", None) is None:
            return X
        Zs, Ys, LV, UV = _numpy(carry[1]), _numpy(carry[2]), _numpy(LV), _numpy(UV)
        Z = Zs.reshape(Zs.shape[0], -1) / self._E[None, :]
        Y = Ys.reshape(Ys.shape[0], -1) * self._E[None, :] / self._c
        out = np.array(X)
        tol = self._polish_act_tol
        for b in range(X.shape[0]):
            out[b] = self._polish(X[b], Z[b], Y[b], LV[b], UV[b], tol=tol)
        return out

    @property
    def _polish_act_tol(self):
        """Active-set detection tolerance for batched polishes: float32 ADMM
        stalls near ~5e-5 scaled residuals, so its bar is looser than the
        float64 host path's 1e-6."""
        return 1e-6 if self.dtype == torch.float64 else 1e-4

    def batch_bounds(self, load_forecasts, gen_forecasts, init_socs):
        """The per-lane bounds ``(lv, uv)``, float64 ``[B, m]`` on the device:
        the template ``(l, u)`` with the parameter rows written from the
        forecasts and initial SoCs (the loop over ``param_rows`` of the JAX
        package, as index copies)."""
        f64 = lambda a: torch.as_tensor(a, device=self.device).to(torch.float64)
        load_f, gen_f, socs = f64(load_forecasts), f64(gen_forecasts), f64(init_socs)
        Bsz = load_f.shape[0]
        lv = self._l_t.expand(Bsz, -1).clone()
        uv = self._u_t.expand(Bsz, -1).clone()
        r, s, i = self._param_idx["load_eq"]
        lv[:, r] = load_f[:, i, s]
        uv[:, r] = load_f[:, i, s]
        r, s, i = self._param_idx["gen_cap"]
        uv[:, r] = gen_f[:, i, s]
        r, _, i = self._param_idx["soc_init"]
        lv[:, r] = socs[:, i]
        uv[:, r] = socs[:, i]
        return lv, uv

    def solve_batch(self, load_forecasts, gen_forecasts, init_socs, warm_start=False, warm_shift=False, polish=False,
                    sharding=None):
        """Solve the N-stage DC-OPF for a batch of B environment lanes.

        Parameters (tensors or host arrays)
        ----------
        load_forecasts : [B, n_load, N] (p.u.)
        gen_forecasts : [B, n_gen-1, N] (p.u.)
        init_socs : [B, n_des] (p.u.)

        Returns actions ``[B, action_n]`` in MW/MVAr (Q = 0), clipped to the
        action space: a float64 tensor on the agent's device.

        With ``warm_start=True`` the solver keeps the previous call's final
        ADMM iterate on the device and starts the next solve from it -- in
        receding-horizon operation consecutive problems differ only in the
        forecast/SoC parameter rows (with an automatic full-budget fallback
        when the residual check fails, e.g. after a large state jump).  The
        carry is invalidated when the batch size changes.  ``polish`` runs
        the host float64 active-set polish on each lane.

        ``sharding`` (a :func:`~gym_anm_tpu_torch.parallel.sharding.batch_sharding`
        of a mesh whose rank device is the agent's) splits the lanes over the
        ranks: each rank assembles every lane's bounds, solves its own lanes
        (the ADMM issues no collective: lanes are independent) and gathers
        the actions with one ``all_gather``, so every rank returns the
        global ``[B, action_n]``.  The warm carry, the polish and
        ``last_batch_solution`` are this rank's lanes'.
        """
        lv, uv = self.batch_bounds(load_forecasts, gen_forecasts, init_socs)
        if sharding is not None:
            lanes = sharding.lanes(lv.shape[0])
            lv, uv = lv[lanes], uv[lanes]
        Bsz = lv.shape[0]
        warm = getattr(self, "_warm_carry", None)
        if not warm_start:
            warm = None
        elif warm is not None and warm[0].shape[0] != Bsz:
            warm = None
        if warm is not None and warm_shift:
            # Receding-horizon realignment (see _shift_warm_carry): stage s
            # starts from the plan the previous solve made for it.
            warm = self._shift_warm_carry(warm)
        x, carry = self._admm_batch(lv, uv, warm=warm)
        self._warm_carry = carry if warm_start else None
        if polish:
            # Mixed-precision accuracy mode: the device ADMM identifies the
            # active set, an exact float64 equality-constrained KKT solve on
            # the host recovers the LP vertex per lane.
            x = self._tensor(self._polish_batch(x, carry, lv, uv), torch.float64)
        # Full per-lane solutions for inspection / external-oracle
        # cross-checks (scripts/mpc_bench_torch.py --verify): x [B, nz] with
        # the per-lane bounds actually solved against.
        self.last_batch_solution = {"x": x, "lv": lv, "uv": uv}
        base = self.baseMVA
        zeros = lambda k: torch.zeros((Bsz, k), dtype=torch.float64, device=self.device)
        acts = torch.cat(
            [
                x[:, self._act_gen] * base,
                zeros(len(self.non_slack_gen_ids)),
                x[:, self._act_des] * base,
                zeros(len(self.des_ids)),
            ],
            dim=1,
        )
        acts = torch.clamp(acts, self._act_low, self._act_high)
        if sharding is not None:
            acts = all_gather(acts, sharding.mesh)
        return acts

    def _state_vecs(self, state_vecs):
        """Canonical state vectors as a float64 ``[B, state_n]`` tensor on the device."""
        return torch.as_tensor(state_vecs, device=self.device).to(torch.float64)

    # ------------------------------------------------------------------
    def forecast(self, env):
        """Return (P_load_forecast [n_load, N], P_gen_forecast [n_gen-1, N])
        in p.u. -- implemented by subclasses (mpc.py:345-370)."""
        raise NotImplementedError()

    def act(self, env):
        """Solve the N-stage DC-OPF and return the stage-0 action
        (mpc.py:321-343), a host array.  ``env`` needs ``simulator`` (the
        facade, after a reset) and what ``forecast`` reads."""
        P_load_forecast, P_gen_forecast = self.forecast(env)
        a = self._solve(env.simulator, P_load_forecast, P_gen_forecast)
        return np.clip(a, self.action_space.low, self.action_space.high)

    def _solve(self, simulator, load_forecasts, gen_forecasts):
        lv, uv = self.l.copy(), self.u.copy()
        load_forecasts = np.asarray(load_forecasts, dtype=float)
        gen_forecasts = np.asarray(gen_forecasts, dtype=float)
        init_soc = np.array(
            [simulator.state["des_soc"]["pu"][i] for i in self.des_ids], dtype=float
        )
        for r, kind, s, i in self.param_rows:
            if kind == "load_eq":
                lv[r] = uv[r] = load_forecasts[i, s]
            elif kind == "gen_cap":
                uv[r] = gen_forecasts[i, s]
            elif kind == "soc_init":
                lv[r] = uv[r] = init_soc[i]

        warm = self._act_carry if self.warm_start else None
        if warm is not None and self.warm_shift:
            warm = self._shift_warm_carry(warm)
        x, z, y, carry = self._admm(lv, uv, warm=warm)
        self._act_carry = carry if self.warm_start else None
        x = self._polish(x, z, y, lv, uv)

        # Expose the full solution for inspection/tests (the reference
        # exposes the CVXPY variables, mpc.py:196-198).
        S = self.stage_size
        nb, nd, ndes = self.n_bus, self.n_dev, self.n_des
        self.last_solution = {
            "x": x,
            "lv": lv,
            "uv": uv,
            "theta": [x[s * S : s * S + nb] for s in range(self.planning_steps)],
            "P_dev": [x[s * S + nb : s * S + nb + nd] for s in range(self.planning_steps)],
            "soc": [
                x[s * S + nb + nd + 2 * ndes : s * S + nb + nd + 3 * ndes]
                for s in range(self.planning_steps)
            ],
        }

        o = self._off0
        P = x[o["P"] : o["P"] + self.n_dev]
        P_gen = [P[self.dev_id_mapping[d]] * self.baseMVA for d in self.non_slack_gen_ids]
        Q_gen = [0.0] * len(P_gen)
        P_des = [P[self.dev_id_mapping[d]] * self.baseMVA for d in self.des_ids]
        Q_des = [0.0] * len(P_des)
        return np.concatenate((P_gen, Q_gen, P_des, Q_des))


def verify_lanes(agent, k):
    """Objective parity of K evenly spaced lanes of the agent's last batched
    solve against the scipy HiGHS LP optimum (``scripts/mpc_bench.py``'s
    check): the relative objective gaps and the worst bound violation.

    Uses the banded backend's sparse assembly where it exists (it scales to
    feeder141 horizon 20, where no dense A exists), else the dense A.
    Returns ``{"verify_lanes", "verify_max_rel_obj_gap",
    "verify_mean_rel_obj_gap", "verify_max_bound_violation"}`` or
    ``{"verify_error": ...}`` when HiGHS fails on a lane."""
    from scipy import sparse
    from scipy.optimize import linprog

    sol = getattr(agent, "last_batch_solution", None)
    if sol is None:
        return {"verify_error": "no batch solution recorded"}
    X, LV, UV = (_numpy(sol[k_]) for k_ in ("x", "lv", "uv"))
    B = X.shape[0]
    lanes = np.linspace(0, B - 1, min(k, B)).astype(int)
    A = agent.sparse_A() if hasattr(agent, "sparse_A") else sparse.csr_matrix(agent.A)
    gaps, feas = [], []
    for b in lanes:
        x, lv, uv = X[b], LV[b], UV[b]
        Ax = agent.apply_A_host(x) if hasattr(agent, "apply_A_host") else A @ x
        feas.append(float(np.max(np.maximum(0.0, np.maximum(lv - Ax, Ax - uv)))))
        eq = (lv == uv) & np.isfinite(lv)
        ub = np.isfinite(uv) & ~eq
        lb = np.isfinite(lv) & ~eq
        res = linprog(
            agent.q,
            A_ub=sparse.vstack([A[ub], -A[lb]]),
            b_ub=np.concatenate([uv[ub], -lv[lb]]),
            A_eq=A[eq],
            b_eq=lv[eq],
            bounds=[(None, None)] * agent.nz,
            method="highs",
        )
        if res.status != 0:
            return {"verify_error": f"HiGHS status {res.status} on lane {int(b)}"}
        gaps.append(abs(float(agent.q @ x) - res.fun) / max(1.0, abs(res.fun)))
    return {
        "verify_lanes": len(lanes),
        "verify_max_rel_obj_gap": max(gaps),
        "verify_mean_rel_obj_gap": float(np.mean(gaps)),
        "verify_max_bound_violation": max(feas),
    }
