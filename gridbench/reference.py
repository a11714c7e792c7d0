"""The plain reference of one ANM step, in PyTorch, for the benchmark's check.

It follows gym-anm's published semantics (Henry & Ernst, arXiv:2103.07932;
``simulator.py``, ``devices.py``, ``branch.py``, ``anm_env.py``) from the
configuration file alone: the network's rows, the task's constants and its
time series.  It imports nothing of the measured package and takes none of its
tables.  Each stage is written the straight way:

* loads clipped, reactive power by the fixed Q/P ratio;
* generator and storage set-points projected onto the device's capability
  polygon by enumerating its candidates (the point, the foot on each edge,
  each vertex) and keeping the nearest feasible one, feasible within the
  configuration's ``projection_tol`` (the tolerance the program states for
  float32: without it, a vertex that lies outside the polygon by less than
  the tolerance, which the program may keep, can sit up to a few 1e-4 p.u.
  from the exact projection);
* the storage's state of charge moved by the (dis)charging efficiency;
* the AC power flow by Newton-Raphson in polar form from a flat start, with a
  dense Jacobian and a batched linear solve, a lane stopping at the first
  iterate whose mismatch is within ``x_tol`` (its convergence decides
  termination; a power-flow answer under judgement is held to its float64
  mismatch instead, see :func:`transition`);
* the slack's injection, the branch flows, the energy loss and the penalty;
* the environment's cost clipping, terminal reward, absorbing zero state and
  clipped observation.

``precision="float64"`` is the reference.  ``precision="bfloat16"`` is the
check's control: every stage's values are rounded to bfloat16 between stages,
the arithmetic inside a stage is float32, and the power flow is solved in
float32 from bfloat16 injections.  (A power flow whose iterate is itself held
in bfloat16 cannot reach the task's ``x_tol`` and would terminate every lane.)
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# Device types of gym-anm's network format.
LOAD, SLACK, GEN, RER, DES = -1, 0, 1, 2, 3
# Columns of the network's rows.
BUS = dict(BUS_ID=0, BUS_TYPE=1, BASE_KV=2, VMAX=3, VMIN=4)
DEV = dict(DEV_ID=0, BUS_ID=1, DEV_TYPE=2, QP=3, PMAX=4, PMIN=5, QMAX=6, QMIN=7, PPLUS=8, PMINUS=9, QPLUS=10,
           QMINUS=11, SOC_MAX=12, SOC_MIN=13, EFF=14)
BR = dict(F_BUS=0, T_BUS=1, R=2, X=3, B=4, RATE=5, TAP=6, SHIFT=7)


def _v(row, col, default=None):
    x = row[col] if col < len(row) else None
    return default if x is None else float(x)


class Grid:
    """The configuration's network as float64 tables on ``device``."""

    def __init__(self, cfg: dict, device="cpu"):
        net = cfg["network"]
        self.device = torch.device(device)
        self.base = base = float(net["baseMVA"])
        self.dt = float(cfg["delta_t"])
        self.lamb = float(cfg["lamb"])
        self.gamma = float(cfg["gamma"])
        self.c1, self.c2 = (float(c) for c in cfg["costs_clipping"])
        self.K = int(cfg["K"])
        self.x_tol = float(cfg["x_tol"])
        self.proj_tol = float(cfg["projection_tol"])
        self.aux_bounds = np.asarray(cfg["aux_bounds"], dtype=np.float64)

        buses = sorted(net["bus"], key=lambda r: r[BUS["BUS_ID"]])
        slack = [r for r in buses if int(r[BUS["BUS_TYPE"]]) == 0]
        order = slack + [r for r in buses if int(r[BUS["BUS_TYPE"]]) != 0]  # slack first
        self.bus_index = {int(r[0]): i for i, r in enumerate(order)}
        self.n = n = len(order)
        self.v_max = np.array([_v(r, BUS["VMAX"]) for r in order])
        self.v_min = np.array([_v(r, BUS["VMIN"], -math.inf) for r in order])

        devs = sorted(net["device"], key=lambda r: r[DEV["DEV_ID"]])
        self.d = len(devs)
        self.dev_type = np.array([int(r[DEV["DEV_TYPE"]]) for r in devs])
        self.dev_bus = np.array([self.bus_index[int(r[DEV["BUS_ID"]])] for r in devs])
        self.loads = np.flatnonzero(self.dev_type == LOAD)
        self.gens = np.flatnonzero((self.dev_type == GEN) | (self.dev_type == RER))
        self.des = np.flatnonzero(self.dev_type == DES)
        self.rer_in_gens = np.flatnonzero(self.dev_type[self.gens] == RER)
        self.slack_dev = int(np.flatnonzero(self.dev_type == SLACK)[0])

        # Device bounds in p.u. (gym-anm's quirk: a load's PMAX is kept as given).
        p_min, p_max, q_min, q_max = (np.zeros(self.d) for _ in range(4))
        for i, r in enumerate(devs):
            t = self.dev_type[i]
            if t == LOAD:
                qp = _v(r, DEV["QP"])
                p_max[i] = _v(r, DEV["PMAX"], 0.0)
                p_min[i] = _v(r, DEV["PMIN"], -math.inf * base) / base
                q_max[i], q_min[i] = p_max[i] * qp, p_min[i] * qp
            else:
                p_max[i] = _v(r, DEV["PMAX"], math.inf * base) / base
                p_min[i] = _v(r, DEV["PMIN"], (0.0 if t in (GEN, RER) else -math.inf) * base) / base
                q_max[i] = _v(r, DEV["QMAX"], math.inf * base) / base
                q_min[i] = _v(r, DEV["QMIN"], -math.inf * base) / base
        self.p_min, self.p_max, self.q_min, self.q_max = p_min, p_max, q_min, q_max
        self.load_qp = np.array([_v(devs[i], DEV["QP"]) for i in self.loads])

        # Capability polygons G [C, 10, 2], h0 [C, 10] of the generators then
        # the storage units; rows 2 (and 9) take the step's caps.
        polys = [self._polygon(devs[i], i) for i in list(self.gens) + list(self.des)]
        self.G = torch.tensor(np.stack([g for g, _ in polys]) if polys else np.zeros((0, 10, 2)), device=device)
        self.h0 = torch.tensor(np.stack([h for _, h in polys]) if polys else np.zeros((0, 10)), device=device)
        self.soc_min = np.array([_v(devs[i], DEV["SOC_MIN"], 0.0) / base for i in self.des])
        self.soc_max = np.array([_v(devs[i], DEV["SOC_MAX"]) / base for i in self.des])
        self.eff = np.array([_v(devs[i], DEV["EFF"], 1.0) for i in self.des])

        # Nodal admittance and the pi-model coefficients of each branch.
        Y = np.zeros((n, n), dtype=np.complex128)
        br = []
        for r in net["branch"]:
            f, t = self.bus_index[int(r[BR["F_BUS"]])], self.bus_index[int(r[BR["T_BUS"]])]
            ys = 1.0 / (_v(r, BR["R"], 0.0) + 1j * _v(r, BR["X"], 0.0))
            ysh = 1j * _v(r, BR["B"], 0.0) / 2.0
            tap = _v(r, BR["TAP"], 1.0) * np.exp(1j * _v(r, BR["SHIFT"], 0.0) * np.pi / 180.0)
            Y[f, t] -= ys / np.conj(tap)
            Y[t, f] -= ys / tap
            Y[f, f] += (ys + ysh) / abs(tap) ** 2
            Y[t, t] += ys + ysh
            rate = _v(r, BR["RATE"], math.inf * base) / base
            br.append((f, t, (ys + ysh) / abs(tap) ** 2, -ys / np.conj(tap), -ys / tap, ys + ysh, rate))
        self.Y = torch.tensor(Y, device=device)
        self.br_f = torch.tensor([b[0] for b in br], device=device)
        self.br_t = torch.tensor([b[1] for b in br], device=device)
        self.br_coef = torch.tensor(np.array([b[2:6] for b in br]), device=device)  # [b, 4] complex
        self.br_rate = torch.tensor([b[6] for b in br], device=device)

        # The observation bounds of the fully observable task, in the state
        # vector's units (gym-anm's get_state_space, with its gen_p_max quirk:
        # the MW upper bound is the generator's QMAX).
        lo = np.concatenate([p_min * base, q_min * base, self.soc_min * base, p_min[self.gens] * base,
                             self.aux_bounds[:, 0]])
        hi = np.concatenate([p_max * base, q_max * base, self.soc_max * base, q_max[self.gens] * base,
                             self.aux_bounds[:, 1]])
        for k, i in enumerate(self.loads):  # a load's PMAX is not scaled, in either bound
            lo[i], hi[i] = p_min[i] * base, p_max[i] * base
        self.obs_lo, self.obs_hi = lo, hi
        self.state_n = 2 * self.d + len(self.des) + len(self.gens) + self.K

    def _polygon(self, r, i):
        base = self.base
        G, h = np.zeros((10, 2)), np.full(10, math.inf)
        p_min, p_max, q_min, q_max = self.p_min[i], self.p_max[i], self.q_min[i], self.q_max[i]
        p_plus = _v(r, DEV["PPLUS"], p_max * base) / base
        q_plus = _v(r, DEV["QPLUS"], q_max * base) / base
        q_minus = _v(r, DEV["QMINUS"], q_min * base) / base
        tau1 = 0.0 if p_max == p_plus else (q_plus - q_max) / (p_max - p_plus)
        tau2 = 0.0 if p_max == p_plus else (q_minus - q_min) / (p_max - p_plus)
        rho1, rho2 = q_max - tau1 * p_plus, q_min - tau2 * p_plus
        G[0], h[0] = (-1, 0), -p_min
        G[1], h[1] = (1, 0), p_max
        G[2] = (1, 0)
        G[3], h[3] = (0, -1), -q_min
        G[4], h[4] = (0, 1), q_max
        G[5], h[5] = (-tau1, 1), rho1
        G[6], h[6] = (tau2, -1), -rho2
        if self.dev_type[i] == DES:
            p_minus = _v(r, DEV["PMINUS"], p_min * base) / base
            tau3 = 0.0 if p_min == p_minus else (q_min - q_minus) / (p_minus - p_min)
            tau4 = 0.0 if p_min == p_minus else (q_max - q_plus) / (p_minus - p_min)
            G[7], h[7] = (tau3, -1), -(q_min - tau3 * p_minus)
            G[8], h[8] = (-tau4, 1), q_max - tau4 * p_minus
            G[9] = (-1, 0)
        return G, h


class Prec:
    """Where the reference computes and how it rounds between stages."""

    def __init__(self, precision: str):
        if precision not in ("float64", "bfloat16"):
            raise ValueError("precision must be float64 or bfloat16")
        self.control = precision == "bfloat16"
        self.dtype = torch.float32 if self.control else torch.float64
        self.cdtype = torch.complex64 if self.control else torch.complex128

    def __call__(self, x):
        """A stage's value as the precision stores it."""
        x = x.to(self.dtype)
        return x.to(torch.bfloat16).to(self.dtype) if self.control else x

    def c(self, z):
        z = z.to(self.cdtype)
        return torch.complex(self(z.real), self(z.imag)) if self.control else z


def project(G, h, px, py, tol):
    """The Euclidean projection of ``(px, py) [B, C]`` onto ``{x : G x <= h}``
    (``G [C, m, 2]``, ``h [B, C, m]``): the nearest feasible candidate among
    the point, the foot on each edge line and each vertex of two lines, a
    candidate being feasible within ``tol * (1 + |h|)`` of each edge (the
    configuration's ``projection_tol``)."""
    gx, gy = G[..., 0].to(px.dtype), G[..., 1].to(px.dtype)  # [C, m]
    m = gx.shape[-1]
    fin = torch.isfinite(h)
    hs = torch.where(fin, h, torch.zeros_like(h))
    gg = gx * gx + gy * gy
    t = (gx * px[..., None] + gy * py[..., None] - hs) / torch.where(gg > 0, gg, torch.ones_like(gg))
    cx = [px[..., None], px[..., None] - t * gx]
    cy = [py[..., None], py[..., None] - t * gy]
    ok = [torch.ones_like(px[..., None], dtype=torch.bool), fin & (gg > 0)]
    r, s = torch.triu_indices(m, m, 1, device=px.device)
    det = gx[:, r] * gy[:, s] - gy[:, r] * gx[:, s]  # [C, P]
    safe = torch.where(det.abs() > 1e-12, det, torch.ones_like(det))
    cx.append((hs[..., r] * gy[:, s] - gy[:, r] * hs[..., s]) / safe)
    cy.append((gx[:, r] * hs[..., s] - hs[..., r] * gx[:, s]) / safe)
    ok.append(fin[..., r] & fin[..., s] & (det.abs() > 1e-12))
    cx, cy, ok = torch.cat(cx, -1), torch.cat(cy, -1), torch.cat(ok, -1)  # [B, C, N]
    viol = gx[..., None, :] * cx[..., None] + gy[..., None, :] * cy[..., None] - h[..., None, :]  # [B, C, N, m]
    feasible = ok & (viol <= tol * (1.0 + h.abs()[..., None, :].nan_to_num(posinf=0.0))).all(-1)
    dist = (cx - px[..., None]) ** 2 + (cy - py[..., None]) ** 2
    k = torch.where(feasible, dist, torch.full_like(dist, math.inf)).argmin(-1, keepdim=True)
    return cx.gather(-1, k)[..., 0], cy.gather(-1, k)[..., 0]


def power_flow(Y, p, q, x_tol, max_iter, pr: Prec):
    """Newton-Raphson in polar form from a flat start: ``(V [B, n] complex,
    converged [B], iterations [B])``.  The slack (bus 0) is held at
    1 + 0j; a lane stops at the first iterate whose mismatch inf-norm is at
    most ``x_tol`` (a NaN mismatch stops it unconverged)."""
    B, m = p.shape
    Y = Y.to(pr.cdtype)
    theta = torch.zeros((B, m), dtype=pr.dtype, device=p.device)
    vm = torch.ones_like(theta)
    one = torch.ones((B, 1), dtype=pr.cdtype, device=p.device)

    def evaluate(theta, vm):
        V = torch.cat([one, torch.polar(vm, theta).to(pr.cdtype)], dim=1)
        I = V @ Y.T
        S = V * I.conj()
        F = torch.cat([S.real[:, 1:] - p, S.imag[:, 1:] - q], dim=1)
        return V, I, F, F.abs().amax(dim=1)

    V, I, F, diff = evaluate(theta, vm)
    iters = torch.zeros(B, dtype=torch.int64, device=p.device)
    eye = torch.eye(m + 1, dtype=torch.bool, device=p.device)
    for _ in range(int(max_iter)):
        active = diff > x_tol
        if not bool(active.any()):
            break
        Vn = V / V.abs()
        YV = Y[None] * V[:, None, :]  # Y_ik V_k
        dS_dth = 1j * V[:, :, None] * (torch.where(eye, I[:, :, None], torch.zeros_like(YV)) - YV).conj()
        dS_dvm = V[:, :, None] * (Y[None] * Vn[:, None, :]).conj() \
            + torch.where(eye, (I.conj() * Vn)[:, :, None], torch.zeros_like(YV))
        a, b = dS_dth[:, 1:, 1:], dS_dvm[:, 1:, 1:]
        J = torch.cat([torch.cat([a.real, b.real], 2), torch.cat([a.imag, b.imag], 2)], 1)
        dx = torch.linalg.solve_ex(J, F[..., None])[0][..., 0]
        V2, I2, F2, diff2 = evaluate(theta - dx[:, :m], vm - dx[:, m:])
        keep = active[:, None]
        theta, vm = torch.where(keep, theta - dx[:, :m], theta), torch.where(keep, vm - dx[:, m:], vm)
        V, I, F = torch.where(keep, V2, V), torch.where(keep, I2, I), torch.where(keep, F2, F)
        diff = torch.where(active, diff2, diff)
        iters = iters + active.to(torch.int64)
    return V, diff <= x_tol, iters


class Physics(NamedTuple):
    dev_p: torch.Tensor  # [B, d] p.u., device order
    dev_q: torch.Tensor
    soc: torch.Tensor  # [B, n_des] p.u.
    p_pot: torch.Tensor  # [B, n_gen] p.u.
    V: torch.Tensor  # [B, n] complex, slack first
    converged: torch.Tensor  # [B]
    e_loss: torch.Tensor
    penalty: torch.Tensor
    iters: torch.Tensor  # [B] NR iterations this solve took
    residual: torch.Tensor  # [B] mismatch inf-norm of the voltages V at the step's injections


def mismatch(Y, V, p, q):
    """The power-flow mismatch inf-norm ``[B]`` of bus voltages ``V [B, n]``
    (slack first) at the non-slack injections ``p, q [B, n - 1]``."""
    S = V * (V @ Y.to(V.dtype).T).conj()
    F = torch.cat([S.real[:, 1:] - p, S.imag[:, 1:] - q], dim=1)
    return torch.nan_to_num(F.abs().amax(dim=1), nan=math.inf)


def transition(g: Grid, soc, P_load, P_pot, P_gen, Q_gen, P_des, Q_des, max_iter, pr: Prec, V=None) -> Physics:
    """gym-anm's ``Simulator.transition`` (p.u. in and out).

    ``V [B, n]`` (complex, slack first), when given, is a power-flow answer to
    judge: the solve still runs (its convergence decides termination and its
    iterations are counted), but the slack's injection, the branch flows and
    the reward are derived from ``V``, and ``residual`` is ``V``'s mismatch."""
    t = lambda a: torch.as_tensor(a, device=g.device).to(pr.dtype)
    B = soc.shape[0]
    dt = g.dt
    soc, P_load, P_pot, P_gen, Q_gen, P_des, Q_des = (pr(x) for x in (soc, P_load, P_pot, P_gen, Q_gen, P_des, Q_des))
    load_p = pr(torch.minimum(torch.maximum(P_load, t(g.p_min[g.loads])), t(g.p_max[g.loads])))
    load_q = pr(load_p * t(g.load_qp))
    p_pot = pr(torch.minimum(torch.maximum(P_pot, t(g.p_min[g.gens])), t(g.p_max[g.gens])))

    ng = len(g.gens)
    h = g.h0.to(pr.dtype).expand(B, -1, -1).clone()  # [B, C, 10]
    h[:, :ng, 2] = p_pot
    eff, smin, smax = t(g.eff), t(g.soc_min), t(g.soc_max)
    h[:, ng:, 2] = pr(eff * (soc - smin) / dt)
    h[:, ng:, 9] = pr(-(soc - smax) / (dt * eff))
    px, py = project(g.G, h, torch.cat([P_gen, P_des], 1), torch.cat([Q_gen, Q_des], 1), g.proj_tol)
    px, py = pr(px), pr(py)
    des_p = px[:, ng:]
    new_soc = torch.where(des_p <= 0, soc - dt * eff * des_p, soc - dt * des_p / eff)
    new_soc = pr(torch.minimum(torch.maximum(new_soc, smin), smax))

    dev_p = torch.zeros((B, g.d), dtype=pr.dtype, device=g.device)
    dev_q = torch.zeros_like(dev_p)
    dev_p[:, g.loads], dev_q[:, g.loads] = load_p, load_q
    idx = list(g.gens) + list(g.des)
    dev_p[:, idx], dev_q[:, idx] = px, py
    inc = torch.zeros((g.n, g.d), dtype=pr.dtype, device=g.device)
    inc[torch.as_tensor(g.dev_bus, device=g.device), torch.arange(g.d, device=g.device)] = 1.0
    bus_p, bus_q = pr(dev_p @ inc.T), pr(dev_q @ inc.T)

    V_own, conv, iters = power_flow(g.Y, bus_p[:, 1:], bus_q[:, 1:], g.x_tol, max_iter, pr)
    V = pr.c(V_own) if V is None else V.to(pr.cdtype)
    residual = mismatch(g.Y.to(torch.complex128), V.to(torch.complex128), bus_p[:, 1:].double(),
                        bus_q[:, 1:].double())
    I = pr.c(V @ g.Y.to(pr.cdtype).T)
    inf = torch.full_like(I.real[:, 0], math.inf)
    dev_p[:, g.slack_dev] = torch.where(torch.isnan(I.real[:, 0]), inf, I.real[:, 0])
    dev_q[:, g.slack_dev] = torch.where(torch.isnan(I.imag[:, 0]), inf, -I.imag[:, 0])

    c = g.br_coef.to(pr.cdtype)
    Vf, Vt = V[:, g.br_f], V[:, g.br_t]
    i_f, i_t = c[:, 0] * Vf + c[:, 1] * Vt, c[:, 3] * Vt + c[:, 2] * Vf
    s_f, s_t = pr.c(Vf * i_f.conj()), pr.c(Vt * i_t.conj())
    s_max = torch.sign(s_f.real) * torch.maximum(s_f.abs(), s_t.abs())

    mask = torch.as_tensor(np.isin(g.dev_type, (LOAD, SLACK, GEN, RER)), device=g.device).to(pr.dtype)
    e_loss = (dev_p * mask).sum(1)
    rer = g.gens[g.rer_in_gens]
    if len(rer):
        e_loss = e_loss + torch.clamp_min(p_pot[:, g.rer_in_gens] - dev_p[:, rer], 0.0).sum(1)
    e_loss = pr(e_loss * dt)
    vm = V.abs()
    pen = (torch.clamp_min(vm - t(g.v_max), 0.0) + torch.clamp_min(t(g.v_min) - vm, 0.0)).sum(1)
    pen = pen + torch.clamp_min(s_max.abs() - g.br_rate.to(pr.dtype), 0.0).sum(1)
    penalty = pr(pen * dt * g.lamb)
    return Physics(pr(dev_p), pr(dev_q), new_soc, p_pot, V, conv, e_loss, penalty, iters, residual)


class EnvOut(NamedTuple):
    state_vec: torch.Tensor  # [B, state_n] MW / MVAr / MWh / aux; zeros where terminated
    obs: torch.Tensor  # [B, state_n] clipped state vector; zeros where terminated
    reward: torch.Tensor  # [B]
    terminated: torch.Tensor  # [B]
    V: torch.Tensor  # [B, n] complex; zeros where terminated
    iters: torch.Tensor  # [B]
    residual: torch.Tensor  # [B] see Physics


def _finish(g: Grid, ph: Physics, soc, aux, term, pr: Prec):
    base = g.base
    vec = torch.cat([ph.dev_p * base, ph.dev_q * base, soc * base, ph.p_pot * base, aux.to(pr.dtype)], 1)
    vec = pr(torch.where(term[:, None], torch.zeros_like(vec), vec))
    lo = torch.as_tensor(g.obs_lo, device=g.device).to(pr.dtype)
    hi = torch.as_tensor(g.obs_hi, device=g.device).to(pr.dtype)
    obs = torch.minimum(torch.maximum(vec, lo), hi)
    obs = torch.where(term[:, None], torch.zeros_like(obs), obs)
    V = torch.where(term[:, None], torch.zeros_like(ph.V), ph.V)
    return vec, obs, V


def env_step(g: Grid, soc, terminated, actions, vars, max_iter, pr: Prec, V=None) -> EnvOut:
    """gym-anm's ``ANMEnv.step`` from a state given by its storage charge
    ``soc [B, n_des]`` (p.u.) and ``terminated [B]``, with ``actions [B, A]``
    (MW/MVAr: P_gen, Q_gen, P_des, Q_des) and the task's ``vars [B, n_load +
    n_gen + K]`` (MW: P_load, P_pot, then aux)."""
    base = g.base
    ng, nd, nl = len(g.gens), len(g.des), len(g.loads)
    a = actions.to(pr.dtype) / base
    v = vars.to(pr.dtype)
    ph = transition(g, soc, v[:, :nl] / base, v[:, nl:nl + ng] / base, a[:, :ng], a[:, ng:2 * ng],
                    a[:, 2 * ng:2 * ng + nd], a[:, 2 * ng + nd:], max_iter, pr, V)
    newly = ~ph.converged
    e_c = torch.sign(ph.e_loss) * torch.clamp(ph.e_loss.abs(), 0.0, g.c1)
    p_c = torch.clamp(ph.penalty, 0.0, g.c2)
    r = torch.where(newly, torch.full_like(e_c, -g.c2 / (1.0 - g.gamma)), -(e_c + p_c))
    term = terminated | newly
    r = pr(torch.where(terminated, torch.zeros_like(r), r))
    aux = torch.where(term[:, None], torch.zeros_like(v[:, nl + ng:]), v[:, nl + ng:])
    vec, obs, V = _finish(g, ph, ph.soc, aux, term, pr)
    return EnvOut(vec, obs, r, term, V, ph.iters, ph.residual)


def reset_from_s0(g: Grid, s0, max_iter, pr: Prec, V=None) -> EnvOut:
    """gym-anm's ``Simulator.reset`` on initial state vectors ``s0 [B, k]``
    (MW/MVAr/MWh, aux last): the storage pre-set to empty or full so the
    requested injection is feasible, one transition, then the charge set to
    the requested value.  A lane whose power flow fails is terminated."""
    base, d = g.base, g.d
    s0 = s0.to(pr.dtype)
    P, Q = s0[:, :d] / base, s0[:, d:2 * d] / base
    nd, ng = len(g.des), len(g.gens)
    soc_target = s0[:, 2 * d:2 * d + nd] / base
    P_max = s0[:, 2 * d + nd:2 * d + nd + ng] / base
    P_des = P[:, g.des]
    t = lambda a: torch.as_tensor(a, device=g.device).to(pr.dtype)
    soc_pre = torch.where(P_des <= 0, t(g.soc_min).expand_as(P_des), t(g.soc_max).expand_as(P_des))
    ph = transition(g, soc_pre, P[:, g.loads], P_max, P[:, g.gens], Q[:, g.gens], P_des, Q[:, g.des], max_iter, pr,
                    V)
    term = ~ph.converged
    aux = torch.where(term[:, None], torch.zeros_like(s0[:, 2 * d + nd + ng:]), s0[:, 2 * d + nd + ng:])
    vec, obs, V = _finish(g, ph, pr(soc_target), aux, term, pr)
    return EnvOut(vec, obs, torch.zeros_like(vec[:, 0]), term, V, ph.iters, ph.residual)


def task_vars_gap(cfg: dict, g: Grid, state_vec_in, vars):
    """How far the task's drawn ``vars [B, ...]`` (MW) lie from what the task
    allows after a state with aux ``state_vec_in[:, -K:]``, per lane in
    p.u.: 0 when they are the task's values (a table lookup) or inside its
    distribution's support (uniform draws around a daily profile)."""
    nv = cfg["next_vars"]
    nl, ng = len(g.loads), len(g.gens)
    v = vars.to(torch.float64)
    aux = torch.remainder(state_vec_in[:, -1].to(torch.float64) + 1, 96)
    gap = (v[:, -1] - aux).abs()
    if nv["kind"] == "table":
        idx = aux.round().long()
        loads = torch.as_tensor(nv["P_loads"], dtype=torch.float64, device=v.device)[:, idx].T
        pots = torch.as_tensor(nv["P_maxs"], dtype=torch.float64, device=v.device)[:, idx].T
        gap = torch.maximum(gap, (v[:, :nl] - loads).abs().amax(1) / g.base)
        gap = torch.maximum(gap, (v[:, nl:nl + ng] - pots).abs().amax(1) / g.base)
    elif nv["kind"] == "uniform_profile":
        daily = 0.75 + 0.25 * torch.sin(2 * math.pi * (aux / 96.0 - 0.3))
        scale = torch.as_tensor(-g.p_min[g.loads] * g.base, device=v.device)  # MW
        lo_f, hi_f = nv["load_factor"]
        lo = -scale * daily[:, None] * hi_f
        hi = -scale * daily[:, None] * lo_f
        out = torch.clamp_min(lo - v[:, :nl], 0) + torch.clamp_min(v[:, :nl] - hi, 0)
        pv = torch.as_tensor(g.p_max[g.gens] * g.base, device=v.device)
        plo, phi = nv["pot_factor"]
        p = v[:, nl:nl + ng]
        out_p = torch.clamp_min(pv * plo - p, 0) + torch.clamp_min(p - pv * phi, 0)
        tol = 1e-6 * (1 + scale.abs().max())
        gap = torch.maximum(gap, torch.clamp_min(out.amax(1) - tol, 0) / g.base)
        gap = torch.maximum(gap, torch.clamp_min(out_p.amax(1) - tol, 0) / g.base)
    else:
        raise ValueError("unknown next_vars kind %r" % nv["kind"])
    return gap
