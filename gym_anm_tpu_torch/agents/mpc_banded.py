"""Stage-banded MPC DC-OPF solver: the scalable backend.

The counterpart of ``gym_anm_tpu.agents.mpc_banded``.  The dense backend
(:mod:`gym_anm_tpu_torch.agents.mpc`) assembles the N-stage DC-OPF as one
dense LP ``A [m, N*S]`` -- O((N*S)^2) memory/compute, which collapses at long
horizons and at feeder141 scale (S ~ 455 per stage).  This module exploits
the LP's *stage-banded* structure instead:

* every stage has the same row/column pattern -- one shared pair
  ``A_diag [M, S]`` (stage-s rows on stage-s variables) and ``A_sub [M, S]``
  (stage-s rows on stage-(s-1) variables; only the SoC-recursion rows,
  mpc.py:281-295, are nonzero there, and stage 0 has no sub part) -- so
  ``A z`` and ``A^T y`` are ``[M, S]`` matrix products over a ``[N, B]``
  grid, never a dense ``[m, N*S]`` product;
* the ADMM KKT matrix ``sigma*I + A^T diag(rho) A`` is block tridiagonal
  with ``[S, S]`` stage blocks; it is factorized by a *block-Thomas LDL^T*
  (a loop over the N stages of batched Cholesky-based ``[B, S, S]`` block
  inverses) and each ADMM iteration solves it with two O(N) sweeps of
  batched ``[B, S, S] @ [B, S]`` products -- explicit block inverses, not
  per-element substitution.

Per-iteration cost drops from O((N*S)^2) to O(N*(M*S + S^2)) and memory
from O((N*S)^2) to O(N*S^2).  Accuracy machinery (Ruiz equilibration,
per-lane adaptive rho with on-device refactorization, warm starts, the
dense active-set polish for small problems, the host float64 sparse-KKT
polish for large ones) mirrors the dense backend.  The JAX package's
host-looped one-chunk programs (a TPU runtime watchdog's workaround) are not
ported: every budget runs as one fixed sequence of chunks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.precision import in_full_precision
from .mpc import IterationGraph, MPCAgent, _numpy, inv_spd
from .mpc_constant import MPCAgentConstant
from .mpc_perfect import MPCAgentPerfect


class MPCAgentBanded(MPCAgent):
    """`MPCAgent` with the stage-banded solver backend (same public API)."""

    #: run the dense active-set polish only while N*S stays small (its KKT
    #: solve is O((nz + n_active)^3)); beyond it, accuracy is the ADMM
    #: residual tolerance.
    POLISH_MAX_NZ = 2048
    #: build the dense (A, l, u) mirror -- needed only for the polish -- up
    #: to a larger, memory-bound limit.  Constraint inspection at any scale
    #: goes through :meth:`apply_A_host` / :meth:`sparse_A` instead.
    MIRROR_MAX_NZ = 4096
    #: Share of the card's memory one lane chunk of the batched ADMM may
    #: take: the block-Thomas factors are 2 x [B, N, S, S] plus comparable
    #: temporaries (~16 N S^2 values a lane).  On an 80 GB H100 that is
    #: 40 GB: feeder141 h5 takes 66 MB a lane in float32 (600 lanes fit;
    #: chunks of 512), h20 265 MB (128).  Larger batches are split into
    #: power-of-two lane chunks solved one after the other.
    DEVICE_MEMORY_FRACTION = 0.5
    #: the budget on the CPU, which has no device memory to ask about.
    HOST_MEMORY_BUDGET = 6e9

    # ------------------------------------------------------------------
    # Banded LP assembly (host numpy, once).
    # ------------------------------------------------------------------
    def _build_lp(self):
        spec = self.spec
        nb, nd, ndes, nbr = self.n_bus, self.n_dev, self.n_des, self.n_branch
        N = self.planning_steps
        S = nb + nd + 3 * ndes + nbr  # stage width (theta, P, pch, pdis, soc, t)
        self.stage_size = S
        self.nz = N * S

        o_theta = 0
        o_P = nb
        o_pch = nb + nd
        o_pdis = nb + nd + ndes
        o_soc = nb + nd + 2 * ndes
        o_t = nb + nd + 3 * ndes
        self._off0 = dict(theta=o_theta, P=o_P, pch=o_pch, pdis=o_pdis, soc=o_soc, t=o_t)

        dev_pos = self.dev_id_mapping
        bus_pos = self.bus_id_mapping
        load_pos = [dev_pos[i] for i in self.load_ids]
        gen_pos = [dev_pos[i] for i in self.non_slack_gen_ids]
        des_pos = [dev_pos[i] for i in self.des_ids]
        srt = np.asarray(spec.bus_sorted)
        inv = np.empty_like(srt)
        inv[srt] = np.arange(len(srt))
        dev_bus_sorted = inv[np.asarray(spec.dev_bus)]

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

        rows_d, rows_s, lo, hi = [], [], [], []
        # (stage-local row index, kind, local index); kinds as in the dense
        # backend, but stage-generic ("load_eq"/"gen_cap" repeat per stage,
        # "soc_init" applies to stage 0 only).
        self.stage_param_rows = []

        def add_row(d_cols, d_vals, l, u, s_cols=(), s_vals=()):
            rd = np.zeros(S)
            for c, v in zip(d_cols, d_vals):
                rd[c] += v
            rs = np.zeros(S)
            for c, v in zip(s_cols, s_vals):
                rs[c] += v
            rows_d.append(rd)
            rows_s.append(rs)
            lo.append(l)
            hi.append(u)
            return len(rows_d) - 1

        # R1: DC flow balance per bus (mpc.py:241-253).
        for i_pos in range(nb):
            cols, vals = [], []
            for (f, t) in self.branch_ids:
                j, k = bus_pos[f], bus_pos[t]
                if j == i_pos:
                    cols += [o_theta + j, o_theta + k]
                    vals += [B[j, k], -B[j, k]]
                elif k == i_pos:
                    cols += [o_theta + k, o_theta + j]
                    vals += [B[k, j], -B[k, j]]
            for d_idx in range(nd):
                if dev_bus_sorted[d_idx] == i_pos:
                    cols.append(o_P + d_idx)
                    vals.append(-1.0)
            add_row(cols, vals, 0.0, 0.0)

        # R2: loads pinned to forecast (param per stage).
        for li, p in enumerate(load_pos):
            r = add_row([o_P + p], [1.0], 0.0, 0.0)
            self.stage_param_rows.append((r, "load_eq", li))

        # R3/R5: gen box + potential cap (param u per stage).
        for gi, p in enumerate(gen_pos):
            add_row([o_P + p], [1.0], P_gen_min[gi], P_gen_max[gi])
            r = add_row([o_P + p], [1.0], -np.inf, np.inf)
            self.stage_param_rows.append((r, "gen_cap", gi))

        # R4: storage box.
        for di, p in enumerate(des_pos):
            add_row([o_P + p], [1.0], P_des_min[di], P_des_max[di])

        # R6: P_des = p_dis - p_ch (mpc.py:291).
        for di, p in enumerate(des_pos):
            add_row([o_P + p, o_pdis + di, o_pch + di], [1.0, -1.0, 1.0], 0.0, 0.0)

        # R7: SoC recursion (mpc.py:281-295).  A_sub carries the -soc_{s-1}
        # coupling; at stage 0 the sub part is masked off and the bound is
        # the soc_init parameter instead of 0.
        for di in range(ndes):
            r = add_row(
                [o_soc + di, o_pch + di, o_pdis + di],
                [1.0, -self.delta_t * eff[di], self.delta_t / eff[di]],
                0.0,
                0.0,
                s_cols=[o_soc + di],
                s_vals=[-1.0],
            )
            self.stage_param_rows.append((r, "soc_init", di))

        # R8: SoC box.
        for di in range(ndes):
            add_row([o_soc + di], [1.0], soc_min[di], soc_max[di])

        # R9: theta box (mpc.py:297-299).
        for i_pos in range(nb):
            add_row([o_theta + i_pos], [1.0], -np.pi, np.pi)

        # R10: slack angle = 0 (device-position quirk, mpc.py:302).
        add_row([o_theta + self.dev_id_mapping[self.slack_dev_id]], [1.0], 0.0, 0.0)

        # R11: branch-overflow slacks.
        for bi, (f, t) in enumerate(self.branch_ids):
            j, k = bus_pos[f], bus_pos[t]
            c = B[j, k]
            u_b = beta * rates[bi] if np.isfinite(rates[bi]) else np.inf
            add_row([o_theta + j, o_theta + k, o_t + bi], [c, -c, -1.0], -np.inf, u_b)
            add_row([o_theta + j, o_theta + k, o_t + bi], [-c, c, -1.0], -np.inf, u_b)

        # R12: nonnegativity of t, p_ch, p_dis.
        for bi in range(nbr):
            add_row([o_t + bi], [1.0], 0.0, np.inf)
        for di in range(ndes):
            add_row([o_pch + di], [1.0], 0.0, np.inf)
            add_row([o_pdis + di], [1.0], 0.0, np.inf)

        self.A_diag = np.asarray(rows_d)  # [M, S]
        self.A_sub = np.asarray(rows_s)  # [M, S]
        self.l_stage = np.asarray(lo)  # [M]
        self.u_stage = np.asarray(hi)
        self.M_rows = self.A_diag.shape[0]
        self.m = N * self.M_rows

        # Per-stage objective (mpc.py:304-314): q[s] = gamma^s * q_stage.
        q_stage = np.zeros(S)
        nonrer_gen_pos = [dev_pos[g] for g in self.gen_ids if g not in self.gen_rer_ids]
        for p in nonrer_gen_pos:
            q_stage[o_P + p] += 1.0
        for bi in range(nbr):
            q_stage[o_t + bi] += self.lamb
        self.q_stage = q_stage
        gammas = self.gamma ** np.arange(N)
        self.q = (gammas[:, None] * q_stage[None, :]).reshape(-1)  # dense mirror

        # Dense mirrors of A/l/u for the polish + inspection tests, only
        # while small (MIRROR_MAX_NZ); large problems skip them.
        if self.nz <= self.MIRROR_MAX_NZ:
            A = np.zeros((self.m, self.nz))
            for s in range(N):
                r0 = s * self.M_rows
                A[r0 : r0 + self.M_rows, s * S : (s + 1) * S] = self.A_diag
                if s > 0:
                    A[r0 : r0 + self.M_rows, (s - 1) * S : s * S] = self.A_sub
            self.A = A
        else:
            self.A = None
        self.l = np.tile(self.l_stage, N)
        self.u = np.tile(self.u_stage, N)

        # Dense-layout param hooks (row index in the stacked [N*M] order) so
        # act()/solve_batch parameter writing is shared with the dense
        # backend's convention.
        self.param_rows = []
        for s in range(N):
            for r, kind, i in self.stage_param_rows:
                if kind == "soc_init" and s > 0:
                    continue  # s>0 recursion rows keep their (0, 0) bound
                self.param_rows.append((s * self.M_rows + r, kind, s, i))

    # ------------------------------------------------------------------
    # Banded ADMM solver.
    # ------------------------------------------------------------------
    def _build_solver(self, rho=0.1, sigma=1e-6, alpha=1.6, iters=1500):
        Ad, As = self.A_diag, self.A_sub
        M, S = Ad.shape
        N = self.planning_steps

        # Ruiz equilibration on the stacked [M, 2S] stage template: row
        # scales E (shared by every stage's row block) and column scales D
        # (shared by every stage's variable block), preserving the banded
        # structure exactly.
        D = np.ones(S)
        E = np.ones(M)
        Ads, Ass = Ad.copy(), As.copy()
        for _ in range(15):
            stacked = np.abs(np.concatenate([Ads, Ass], axis=1))
            r = np.sqrt(np.maximum(stacked.max(axis=1), 1e-8))
            Ads /= r[:, None]
            Ass /= r[:, None]
            E /= r
            c = np.sqrt(np.maximum(np.maximum(np.abs(Ads).max(axis=0), np.abs(Ass).max(axis=0)), 1e-8))
            Ads /= c[None, :]
            Ass /= c[None, :]
            D /= c
        self._D_stage, self._E_stage = D, E
        # Dense-layout scale mirrors (used by solve_batch/_admm plumbing).
        self._D = np.tile(D, N)
        self._E = np.tile(E, N)

        gammas = self.gamma ** np.arange(N)
        qs_stage = (gammas[:, None] * (D * self.q_stage)[None, :])  # [N, S] scaled
        cost_norm = max(np.abs(qs_stage).max(), 1e-6)
        self._c = 1.0 / cost_norm
        qs_stage = qs_stage * self._c

        self._eq_rows = (self.l == self.u) & np.isfinite(self.l)
        self._rho0 = rho
        self._sigma = sigma
        self._alpha = alpha
        self._chunk_iters = iters

        self._Ads, self._Ass, self._qs_stage = Ads, Ass, qs_stage
        self._Ad_t = self._tensor(Ads)  # [M, S] scaled
        self._As_t = self._tensor(Ass)
        self._q_t = self._tensor(qs_stage)[:, None, :]  # [N, 1, S]
        # Only the SoC-recursion rows of A_sub are nonzero: the coupling
        # blocks of the KKT matrix sum over those rows alone.
        sub = np.flatnonzero(np.any(Ass != 0, axis=1))
        self._sub_rows = torch.as_tensor(sub, dtype=torch.int64, device=self.device)
        self._As_sub_t = self._tensor(Ass[sub])

    # Stage-major layout inside the solve: x [N, B, S], z/y/rho/bounds
    # [N, B, M] (each stage's lanes contiguous for the block sweeps).
    def _apply_A(self, x):  # [N, B, S] -> [N, B, M]
        y = x @ self._Ad_t.T
        y[1:] += x[:-1] @ self._As_t.T
        return y

    def _apply_AT(self, y):  # [N, B, M] -> [N, B, S]
        x = y @ self._Ad_t
        x[:-1] += y[1:] @ self._As_t
        return x

    def _factor_banded(self, rho):
        """``rho [N, B, M]`` -> ``(Msub, Dinv)``, each ``[N, B, S, S]``: the
        block-Thomas LDL^T of the block-tridiagonal K, whose diagonal blocks
        are ``D_s = sigma*I + Ad^T R_s Ad (+ As^T R_{s+1} As for s < N-1)``
        and sub-diagonal blocks ``F_s = Ad^T R_s As`` (s >= 1):
        ``Dt_s = D_s - M_s F_s^T``, ``M_s = F_s Dinv_{s-1}``."""
        N = rho.shape[0]
        Ad, sub, As_sub = self._Ad_t, self._sub_rows, self._As_sub_t
        S = Ad.shape[1]
        eye = torch.eye(S, dtype=Ad.dtype, device=Ad.device)
        Dblk = self._sigma * eye + (Ad.T * rho[..., None, :]) @ Ad  # [N, B, S, S]
        Dinv = torch.empty_like(Dblk)
        Msub = torch.zeros_like(Dblk)
        if N > 1:
            rho_sub = rho[1:][..., sub][:, :, None, :]  # [N-1, B, 1, Ms]
            Dblk[:-1] += (As_sub.T * rho_sub) @ As_sub
            Fblk = (Ad[sub].T * rho_sub) @ As_sub  # [N-1, B, S, S]
        Dinv[0] = inv_spd(Dblk[0])
        for s in range(1, N):
            Fb = Fblk[s - 1]
            Msub[s] = Fb @ Dinv[s - 1]
            Dinv[s] = inv_spd(Dblk[s] - Msub[s] @ Fb.mT)
        return Msub, Dinv

    @staticmethod
    def _kkt_solve(Msub, Dinv, b):
        """``b [N, B, S]`` -> ``x [N, B, S]``: the forward sweep
        ``w_s = b_s - M_s w_{s-1}``, ``v = Dinv w``, and the backward sweep
        ``x_s = v_s - M_{s+1}^T x_{s+1}``."""
        N = b.shape[0]
        w = torch.empty(b.shape + (1,), dtype=b.dtype, device=b.device)
        w[0] = b[0, ..., None]
        for s in range(1, N):
            torch.baddbmm(b[s, ..., None], Msub[s], w[s - 1], alpha=-1, out=w[s])
        v = Dinv @ w
        x = torch.empty_like(v)
        x[N - 1] = v[N - 1]
        for s in range(N - 2, -1, -1):
            torch.baddbmm(v[s], Msub[s + 1].mT, x[s + 1], alpha=-1, out=x[s])
        return x[..., 0]

    @in_full_precision
    def _admm_batch_full_banded(self, ls, us, x0, z0, y0, rho0, n_chunks, chunk_len, eps):
        """Banded analog of the dense backend's batched ADMM on the device:
        chunks of fixed iterations, per-lane adaptive rho with on-device
        refactorization between chunks.  Takes and returns stage-major
        carries of the JAX package's layout (``x [B, N, S]``, ``z``/``y``/
        ``rho``/bounds ``[B, N, M]``); returns ``(x, z, y, rho, pri [B],
        dual [B])``."""
        sigma, alpha, q = self._sigma, self._alpha, self._q_t
        t = lambda a: a.transpose(0, 1)

        def step(consts, x, z, y):
            Msub, Dinv, rho, ls, us = consts
            b = sigma * x - q + self._apply_AT(rho * z - y)
            x_new = self._kkt_solve(Msub, Dinv, b)
            Ax = self._apply_A(x_new)
            z_t = alpha * Ax + (1 - alpha) * z
            z_new = torch.clamp(z_t + y / rho, ls, us)
            y_new = y + rho * (z_t - z_new)
            return x_new, z_new, y_new

        loop = IterationGraph(step, self.GRAPH_ITERS)
        ls, us = t(ls), t(us)
        x, z, y, rho = t(x0), t(z0), t(y0), t(rho0)
        pri = dual = None
        for _ in range(n_chunks):
            x, z, y = loop.run((*self._factor_banded(rho), rho, ls, us), (x, z, y), chunk_len)
            Ax = self._apply_A(x)
            pri = torch.amax(torch.abs(Ax - z), dim=(0, 2))  # [B]
            dual = torch.amax(torch.abs(q + self._apply_AT(y) + sigma * x), dim=(0, 2))
            ratio = torch.sqrt(torch.clamp_min(pri, 1e-16) / torch.clamp_min(dual, 1e-16))
            ratio = torch.clamp(ratio, 1e-2, 1e2)
            conv = (pri < eps) & (dual < eps)
            rebal = (~conv) & ((ratio < 0.5) | (ratio > 2.0))
            rho = torch.where(rebal[None, :, None], torch.clamp(rho * ratio[None, :, None], 1e-6, 1e6), rho)
        return t(x), t(z), t(y), t(rho), pri, dual

    # ------------------------------------------------------------------
    def _memory_budget(self):
        if self.device.type == "cuda":
            return self.DEVICE_MEMORY_FRACTION * torch.cuda.get_device_properties(self.device).total_memory
        return self.HOST_MEMORY_BUDGET

    def lane_chunk(self):
        """Lanes of one batched ADMM chunk: a power of two within the memory
        budget, at ~16 N S^2 values a lane of the solver's element size."""
        N, S = self.planning_steps, self.stage_size
        itemsize = torch.finfo(self.dtype).bits // 8
        per_lane_bytes = 16 * N * S * S * itemsize
        b_chunk = max(1, int(self._memory_budget() // per_lane_bytes))
        return 1 << (b_chunk.bit_length() - 1)

    def _admm_batch(self, lv, uv, eps=1e-8, max_chunks=16, chunk_len=None, warm=None, warm_chunks=2):
        """Banded drop-in for the dense backend's `_admm_batch`: same
        dense-layout float64 [B, m] bounds in, [B, nz] unscaled solution
        out."""
        if chunk_len is None:
            chunk_len = self._chunk_iters
        N, M, S = self.planning_steps, self.M_rows, self.stage_size
        Bsz = lv.shape[0]

        # Memory guard: split over-budget batches into lane chunks (each
        # chunk is an independent set of lanes; results concatenate exactly).
        b_chunk = self.lane_chunk()
        if Bsz > b_chunk:
            outs, carries = [], []
            for i in range(0, Bsz, b_chunk):
                w = None if warm is None else tuple(wv[i : i + b_chunk] for wv in warm)
                xd, c = self._admm_batch(
                    lv[i : i + b_chunk],
                    uv[i : i + b_chunk],
                    eps=eps,
                    max_chunks=max_chunks,
                    chunk_len=chunk_len,
                    warm=w,
                    warm_chunks=warm_chunks,
                )
                outs.append(xd)
                carries.append(c)
            x_dense = torch.cat(outs, dim=0)
            carry = tuple(torch.cat([c[j] for c in carries], dim=0) for j in range(3))
            return x_dense, carry

        ls = (self._E_t[None, :] * lv).to(self.dtype).reshape(Bsz, N, M)
        us = (self._E_t[None, :] * uv).to(self.dtype).reshape(Bsz, N, M)
        rho0 = self._rho0_t.reshape(1, N, M).expand(Bsz, N, M)

        def run_budget(x, z, y, rho_, n_chunks):
            return self._admm_batch_full_banded(ls, us, x, z, y, rho_, n_chunks, chunk_len, eps)

        if warm is None:
            x, z, y, rho_, pri, dual = run_budget(*self._cold_start(ls, us, (Bsz, N, S)), rho0, max_chunks)
        else:
            x0, z0, y0 = self._carry_tensors(warm)
            z0 = torch.clamp(z0, ls, us)
            x, z, y, rho_, pri, dual = run_budget(x0, z0, y0, rho0, warm_chunks)
            worst = float(torch.max(torch.maximum(pri, dual)))
            if not np.isfinite(worst):
                # Restart cold with a fresh rho (NaN iterates never recover).
                x, z, y, rho_, pri, dual = run_budget(*self._cold_start(ls, us, (Bsz, N, S)), rho0, max_chunks)
            elif worst > self._warm_tol:
                x, z, y, rho_, pri, dual = run_budget(x, z, y, rho_, max_chunks)
        x_dense = x.reshape(Bsz, N * S).to(torch.float64) * self._D_t[None, :]
        return x_dense, (x, z, y)

    def _admm(self, lv, uv, eps=1e-9, max_chunks=12, warm=None):
        """Single-instance path: one-lane banded solve with the dense
        backend's host-side chunk loop and early exit (a typical DC-OPF
        converges in 1-2 chunks).  ``warm`` is a scaled-space stage-major
        (x, z, y) carry (the 4th return value); near-optimal warm points
        exit after their first chunk."""
        N, M, S = self.planning_steps, self.M_rows, self.stage_size
        t = self._tensor
        ls = t((self._E * lv).reshape(1, N, M))
        us = t((self._E * uv).reshape(1, N, M))
        rho = t(np.where(self._eq_rows, self._rho0 * 1e3, self._rho0).reshape(1, N, M))
        if warm is not None and all(np.all(np.isfinite(_numpy(v))) for v in warm):
            x = t(_numpy(warm[0]).reshape(1, N, S))
            z = torch.clamp(t(_numpy(warm[1]).reshape(1, N, M)), ls, us)
            y = t(_numpy(warm[2]).reshape(1, N, M))
        else:
            x, z, y = self._cold_start(ls, us, (1, N, S))
        prev = np.inf
        for _ in range(max_chunks):
            x, z, y, rho, pri, dual = self._admm_batch_full_banded(ls, us, x, z, y, rho, 1, self._chunk_iters, eps)
            worst = float(torch.max(torch.maximum(pri, dual)))
            # Converged, or stalled at the float64 residual floor below any
            # meaningful tolerance -- the active-set polish recovers the
            # exact vertex from there.
            if worst < eps or (worst < 1e-6 and worst > 0.5 * prev):
                break
            prev = worst
        x, z, y = (v.cpu().numpy() for v in (x, z, y))
        x_dense = x.reshape(N * S) * self._D
        # Unscale to the dense backend's (x, z, y) convention for _polish.
        z_d = z.reshape(N * M) / self._E
        y_d = y.reshape(N * M) * self._E / self._c
        carry = (x.reshape(N * S), z.reshape(N * M), y.reshape(N * M))
        return x_dense, z_d, y_d, carry

    def _polish(self, x, z, y, lv, uv, tol=1e-6):
        if self.A is None or self.nz > self.POLISH_MAX_NZ:
            return x  # too large for the dense active-set polish
        return super()._polish(x, z, y, lv, uv, tol=tol)

    #: add/drop refinement rounds of the sparse-KKT polish.  The float32
    #: ADMM active-set guess both misses rows (its residual floor is ~5e-5
    #: scaled) and marks spurious ones; a single-shot KKT on that guess is
    #: usually either infeasible or suboptimal and gets rejected.  Each
    #: round bulk-adds the rows the trial vertex violates and -- only at a
    #: feasible iterate -- releases ONE active row with the worst
    #: wrong-signed multiplier (bulk drops underdetermine the set and
    #: diverge); lanes of the calibration batch
    #: (``tests/data/polish_calib_feeder141.npz``) settle within 13.
    POLISH_REFINE_ITERS = 40

    def _polish_batch(self, X, carry, LV, UV):
        """Sparse-KKT active-set polish with add/drop refinement, per lane,
        on the host in float64 (takes tensors or host arrays, returns a host
        array).

        The mixed-precision accuracy mode for large problems: the device's
        ADMM proposes each lane's active constraint set (to its residual
        floor), then an equality-constrained KKT system on those rows --
        assembled SPARSELY from the banded stage blocks, so it scales to
        feeder141 horizon 20 where the dense mirror/polish cannot exist --
        is solved exactly in float64 with scipy's sparse LU.  Because the
        guess is imperfect, the active set is refined: rows the trial vertex
        violates join the set, active inequality rows whose KKT multiplier
        has the wrong sign (lower bounds need nu <= 0, upper bounds nu >= 0
        under the convention ``q + A_act' nu = 0``) leave it, one per round
        (the worst offender), and only at a primal-feasible iterate.  Each
        KKT solve gets two steps of iterative refinement against the
        UNregularized system (reusing the LU factors), so the active rows
        hold to float64 round-off and a feasible iterate whose wrong-sign
        set is empty is a genuine KKT certificate.  The BEST primal-feasible
        iterate is returned (never the raw ADMM point when a feasible
        iterate exists).  An iterate whose active rows cannot be satisfied
        (refined residual > 1e-6) aborts the loop, keeping the best
        candidate.  DC-OPF degeneracy means a polished lane may land on a
        different optimal vertex than HiGHS, but the objective matches the
        LP optimum to solver precision.
        """
        from scipy import sparse
        from scipy.sparse.linalg import splu

        A = self.sparse_A()
        q = self.q
        tol = self._polish_act_tol
        Zs, Ys = _numpy(carry[1]), _numpy(carry[2])
        LV, UV = _numpy(LV), _numpy(UV)
        X = _numpy(X)
        Bsz = X.shape[0]
        Z = Zs.reshape(Bsz, -1) / self._E[None, :]
        Y = Ys.reshape(Bsz, -1) * self._E[None, :] / self._c
        out = np.array(X, dtype=np.float64)
        delta = 1e-9
        feas_tol, dual_tol = 1e-8, 1e-8
        eyen = sparse.identity(self.nz, format="csr")
        for b in range(Bsz):
            x, z, y, lv, uv = out[b], Z[b], Y[b], LV[b], UV[b]
            eq = (lv == uv) & np.isfinite(lv)
            act_u = (z >= uv - tol) & (y > tol / 10) & ~eq
            act_l = (z <= lv + tol) & (y < -tol / 10) & ~eq & ~act_u
            best_obj = np.inf
            for _ in range(self.POLISH_REFINE_ITERS):
                act = act_l | act_u | eq
                if not np.any(act):
                    break
                A_act = A[act]
                b_act = np.where(act_u[act], uv[act], lv[act])
                na = A_act.shape[0]
                KKT = sparse.bmat(
                    [[delta * eyen, A_act.T], [A_act, -delta * sparse.identity(na, format="csr")]],
                    format="csc",
                )
                try:
                    lu = splu(KKT)
                    sol = lu.solve(np.concatenate([-q, b_act]))
                    for _r in range(2):
                        # Iterative refinement toward the delta -> 0 KKT
                        # system (factorization reused): the residual rhs
                        # cancels the systematic delta*nu leak, putting
                        # active-row residuals at float64 round-off.
                        x_p, nu = sol[: self.nz], sol[self.nz :]
                        r1 = -q - A_act.T @ nu
                        r2 = b_act - A_act @ x_p
                        sol = sol + lu.solve(np.concatenate([r1, r2]))
                except Exception:
                    break
                x_p, nu = sol[: self.nz], sol[self.nz :]
                if not np.all(np.isfinite(x_p)):
                    break
                if np.max(np.abs(b_act - A_act @ x_p)) > 1e-6:
                    # The active set became inconsistent (no x satisfies
                    # the forced equalities): stop and keep the best
                    # candidate so far.
                    break
                Axp = self.apply_A_host(x_p)
                viol_l = Axp < lv - feas_tol
                viol_u = Axp > uv + feas_tol
                primal_ok = not (np.any(viol_l) or np.any(viol_u))
                obj = q @ x_p
                if primal_ok and obj < best_obj:
                    # Best feasible iterate to date: accepted regardless of
                    # the ADMM objective (a slightly infeasible ADMM point
                    # can undercut the true optimum).
                    best_obj = obj
                    out[b] = x_p
                if not primal_ok:
                    # Restore primal feasibility first: bulk-add violated
                    # rows at their violated side; never drop while
                    # infeasible.
                    add_u = viol_u & ~act
                    add_l = viol_l & ~act & ~add_u
                    if not (np.any(add_u) or np.any(add_l)):
                        break  # violated rows already active: dead end
                    act_u = act_u | add_u
                    act_l = act_l | add_l
                    continue
                # Feasible: release the single worst wrong-signed active
                # inequality row (nu is ordered like act's True rows).
                nu_full = np.zeros(A.shape[0])
                nu_full[act] = nu
                wrong = np.where(act_u & (nu_full < -dual_tol), -nu_full, 0.0)
                wrong = wrong + np.where(act_l & (nu_full > dual_tol), nu_full, 0.0)
                if wrong.max() <= 0.0:
                    break  # KKT certificate: primal- and dual-feasible
                r = int(np.argmax(wrong))
                act_u[r] = False
                act_l[r] = False
        return out

    # ------------------------------------------------------------------
    # Scale-independent constraint inspection (no dense mirror needed).
    # ------------------------------------------------------------------
    def apply_A_host(self, x):
        """Host-numpy ``A @ x`` from the banded stage blocks -- valid at any
        problem size (the dense mirror stops at ``MIRROR_MAX_NZ``)."""
        N, S, M = self.planning_steps, self.stage_size, self.M_rows
        xs = np.asarray(x, dtype=np.float64).reshape(N, S)
        y = xs @ np.asarray(self.A_diag, dtype=np.float64).T  # [N, M]
        if N > 1:
            y[1:] += xs[:-1] @ np.asarray(self.A_sub, dtype=np.float64).T
        return y.reshape(-1)

    def sparse_A(self):
        """The full constraint matrix as ``scipy.sparse`` (block bi-diagonal
        assembly of ``A_diag``/``A_sub``) for external LP oracles (HiGHS via
        ``scipy.optimize.linprog``) at sizes where the dense mirror is
        memory-infeasible."""
        from scipy import sparse

        N = self.planning_steps
        Ad = sparse.csr_matrix(self.A_diag)
        As = sparse.csr_matrix(self.A_sub)
        blocks = [[None] * N for _ in range(N)]
        for s in range(N):
            blocks[s][s] = Ad
            if s > 0:
                blocks[s][s - 1] = As
        return sparse.bmat(blocks, format="csr")


class MPCAgentConstantBanded(MPCAgentConstant, MPCAgentBanded):
    """Constant-forecast policy on the stage-banded solver backend."""


class MPCAgentPerfectBanded(MPCAgentPerfect, MPCAgentBanded):
    """Perfect-forecast policy on the stage-banded solver backend."""
