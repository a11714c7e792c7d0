"""The physics transition on tensors.

The counterpart of ``gym_anm_tpu.core.transition`` (``transition`` and
``sim_reset``), i.e. of the reference's ``Simulator.transition``
(simulator.py:464-537) and ``Simulator.reset`` (simulator.py:225-293):

1. map requested device set-points onto feasible (P, Q) injections (loads:
   clip + Q/P ratio; generators/storage: exact polytope projection),
2. update storage SoC,
3. aggregate bus injections with the static bus-device incidence,
4. solve the AC power flow with the tree-structured Newton-Raphson solver
   (the CUDA kernel on a CUDA float32 batch, its plain version on the CPU),
5. recover slack/bus/branch electrical quantities,
6. compute the energy-loss + constraint-penalty reward.

All power quantities are per-unit; complex quantities are (re, im) real
pairs.  Dynamic inputs carry one leading batch axis ``[B, k]``.  The
incidence and admittance products are one-shot contractions in the working
dtype: float32 products stay in full float32 (TF32 is never enabled here).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops.tree_cuda import solve_pfe_tree
from .grid import GridTensors, POLY_ROW_P_CAP, POLY_ROW_P_FLOOR
from .state import SimState

PF_METHODS = ("tree",)


class TransitionResult(NamedTuple):
    state: SimState
    reward: torch.Tensor
    e_loss: torch.Tensor
    penalty: torch.Tensor
    pfe_converged: torch.Tensor


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def compute_branch_flows(g: GridTensors, v_re, v_im):
    """Directional branch currents and power flows (branch.py:153-198)."""
    vf_re, vf_im = v_re[..., g.br_f], v_im[..., g.br_f]
    vt_re, vt_im = v_re[..., g.br_t], v_im[..., g.br_t]

    if1_re, if1_im = _cmul(g.br_aff[:, 0], g.br_aff[:, 1], vf_re, vf_im)
    if2_re, if2_im = _cmul(g.br_aft[:, 0], g.br_aft[:, 1], vt_re, vt_im)
    if_re, if_im = if1_re + if2_re, if1_im + if2_im

    it1_re, it1_im = _cmul(g.br_att[:, 0], g.br_att[:, 1], vt_re, vt_im)
    it2_re, it2_im = _cmul(g.br_atf[:, 0], g.br_atf[:, 1], vf_re, vf_im)
    it_re, it_im = it1_re + it2_re, it1_im + it2_im

    # S = V conj(I) at each end.
    p_from = vf_re * if_re + vf_im * if_im
    q_from = vf_im * if_re - vf_re * if_im
    p_to = vt_re * it_re + vt_im * it_im
    q_to = vt_im * it_re - vt_re * it_im

    s_from = torch.sqrt(p_from * p_from + q_from * q_from)
    s_to = torch.sqrt(p_to * p_to + q_to * q_to)
    s_max = torch.sign(p_from) * torch.maximum(s_from, s_to)
    return if_re, if_im, it_re, it_im, p_from, q_from, p_to, q_to, s_max


def _map_set_points(g: GridTensors, des_soc, P_load, P_pot, P_set_gen, Q_set_gen, P_set_des, Q_set_des):
    """Steps 1-2 of the transition: feasible injections + SoC update."""
    spec = g.spec
    B = des_soc.shape[0]
    dt = spec.delta_t

    # Loads: clip + fixed Q/P ratio (devices.py:156-167).
    load_p = torch.clamp(P_load, g.load_p_min, g.load_p_max)
    load_q = load_p * g.load_qp

    # Generators: clip the potential, then cap P by it (devices.py:181-187, 280-304).
    p_pot = torch.clamp(P_pot, g.gen_p_min, g.gen_p_max)
    gen_h = g.gen_h0.expand(B, -1, -1).clone()
    gen_h[:, :, POLY_ROW_P_CAP] = p_pot

    # Storage: SoC-rate caps on (dis)charging (devices.py:501-514).
    des_h = g.des_h0.expand(B, -1, -1).clone()
    des_h[:, :, POLY_ROW_P_CAP] = g.des_eff * (des_soc - g.des_soc_min) / dt
    des_h[:, :, POLY_ROW_P_FLOOR] = -(des_soc - g.des_soc_max) / (dt * g.des_eff)

    # One exact projection for all controllable devices, lanes last.
    h = torch.cat([gen_h, des_h], dim=1).permute(1, 2, 0)  # [C, m, B]
    px = torch.cat([P_set_gen, P_set_des], dim=-1).to(g.dtype).T  # [C, B]
    py = torch.cat([Q_set_gen, Q_set_des], dim=-1).to(g.dtype).T
    x, y = g.projector(px, py, h)
    proj_p, proj_q = x.T, y.T  # [B, C]
    gen_p, gen_q = proj_p[:, : spec.n_gen], proj_q[:, : spec.n_gen]
    des_p, des_q = proj_p[:, spec.n_gen :], proj_q[:, spec.n_gen :]

    # SoC update with round-trip efficiency asymmetry + clip (devices.py:524-545).
    new_soc = torch.where(
        des_p <= 0,
        des_soc - dt * g.des_eff * des_p,
        des_soc - dt * des_p / g.des_eff,
    )
    new_soc = torch.clamp(new_soc, g.des_soc_min, g.des_soc_max)

    # Device injection vectors, slack initialized to 0 (simulator.py:520-523).
    zero_slack = torch.zeros((B, 1), dtype=g.dtype, device=g.device)
    dev_p = torch.cat([zero_slack, load_p.expand(B, -1), gen_p, des_p], dim=-1)[:, g.dev_perm]
    dev_q = torch.cat([zero_slack, load_q.expand(B, -1), gen_q, des_q], dim=-1)[:, g.dev_perm]
    return dev_p, dev_q, new_soc, p_pot


def _reward(g: GridTensors, dev_p, gen_p_pot, v_re, v_im, br_s):
    """Energy loss + constraint penalty (simulator.py:638-683)."""
    spec = g.spec
    e_loss = torch.sum(g.eloss_mask * dev_p, dim=-1)
    if spec.n_rer:
        curtail = torch.clamp_min(gen_p_pot[..., g.rer_gen_idx] - dev_p[..., g.rer_pos], 0.0)
        e_loss = e_loss + torch.sum(curtail, dim=-1)
    e_loss = e_loss * spec.delta_t

    v_magn = torch.sqrt(v_re * v_re + v_im * v_im)
    v_pen = torch.sum(
        torch.clamp_min(v_magn - g.bus_v_max, 0.0) + torch.clamp_min(g.bus_v_min - v_magn, 0.0), dim=-1
    )
    br_pen = torch.sum(torch.clamp_min(torch.abs(br_s) - g.br_rate, 0.0), dim=-1)
    penalty = (v_pen + br_pen) * spec.delta_t * spec.lamb

    return -(e_loss + penalty), e_loss, penalty


def transition(
    g: GridTensors,
    des_soc,
    P_load,
    P_pot,
    P_set_gen,
    Q_set_gen,
    P_set_des,
    Q_set_des,
    x_tol=1e-5,
    max_iter=100,
    pf_method="tree",
) -> TransitionResult:
    """One physics transition (simulator.py:464-537). All inputs in p.u.

    ``des_soc [B, n_des]``, ``P_load [B, n_load]``, ``P_pot [B, n_gen]``,
    ``P_set_gen, Q_set_gen [B, n_gen]``, ``P_set_des, Q_set_des [B, n_des]``.
    ``pf_method`` must be ``"tree"`` (radial grids only).
    """
    if pf_method not in PF_METHODS:
        raise ValueError("pf_method %r is not supported; the port has %s" % (pf_method, PF_METHODS))
    if g.tree is None:
        raise ValueError(
            "pf_method='tree' requires a radial network (a tree rooted at the "
            "slack bus); this network is meshed or disconnected"
        )
    spec = g.spec
    dev_p, dev_q, new_soc, p_pot = _map_set_points(
        g, des_soc, P_load, P_pot, P_set_gen, Q_set_gen, P_set_des, Q_set_des
    )

    # Bus aggregation through the static incidence (simulator.py:539-549).
    bus_p = dev_p @ g.inc_bus_dev.T
    bus_q = dev_q @ g.inc_bus_dev.T

    # Newton-Raphson load flow; the slack bus is internal index 0.
    v_re, v_im, _, _, converged = solve_pfe_tree(
        g.tree, bus_p[:, 1:], bus_q[:, 1:], x_tol=x_tol, max_iter=max_iter
    )

    # Nodal currents I = Y V and slack power (solve_load_flow.py:54-72; NaN
    # slack power becomes +inf).  V_slack = 1 + 0j, so S_slack = conj(I_0).
    i_re = v_re @ g.Y_re.T - v_im @ g.Y_im.T
    i_im = v_im @ g.Y_re.T + v_re @ g.Y_im.T
    inf = torch.tensor(float("inf"), dtype=g.dtype, device=g.device)
    p0 = torch.where(torch.isnan(i_re[:, 0]), inf, i_re[:, 0])
    q0 = torch.where(torch.isnan(i_im[:, 0]), inf, -i_im[:, 0])
    bus_p = torch.cat([p0[:, None], bus_p[:, 1:]], dim=-1)
    bus_q = torch.cat([q0[:, None], bus_q[:, 1:]], dim=-1)
    slack = int(spec.slack_pos)
    dev_p = torch.cat([dev_p[:, :slack], p0[:, None], dev_p[:, slack + 1 :]], dim=-1)
    dev_q = torch.cat([dev_q[:, :slack], q0[:, None], dev_q[:, slack + 1 :]], dim=-1)

    if_re, if_im, it_re, it_im, p_from, q_from, p_to, q_to, s_max = compute_branch_flows(g, v_re, v_im)

    state = SimState(
        dev_p=dev_p,
        dev_q=dev_q,
        des_soc=new_soc,
        gen_p_pot=p_pot,
        bus_v_re=v_re,
        bus_v_im=v_im,
        bus_i_re=i_re,
        bus_i_im=i_im,
        bus_p=bus_p,
        bus_q=bus_q,
        br_if_re=if_re,
        br_if_im=if_im,
        br_it_re=it_re,
        br_it_im=it_im,
        br_p_from=p_from,
        br_q_from=q_from,
        br_p_to=p_to,
        br_q_to=q_to,
        br_s=s_max,
        pfe_converged=converged,
    )
    reward, e_loss, penalty = _reward(g, dev_p, p_pot, v_re, v_im, s_max)
    return TransitionResult(state, reward, e_loss, penalty, converged)


def sim_reset(g: GridTensors, s0, x_tol=1e-5, max_iter=100, pf_method="tree") -> SimState:
    """Apply initial state vectors ``s0 [B, k]`` (reference layout,
    MW/MVAr/MWh units) to the grid (simulator.py:225-293).

    ``s0 = [dev_p (d), dev_q (d), des_soc (n_des), gen_p_max (n_gen), ...]``;
    trailing entries (aux vars) are ignored here.
    """
    spec = g.spec
    d = spec.n_dev
    base = spec.baseMVA
    P_dev = s0[:, :d] / base
    Q_dev = s0[:, d : 2 * d] / base
    soc_target = s0[:, 2 * d : 2 * d + spec.n_des] / base
    P_max = s0[:, 2 * d + spec.n_des : 2 * d + spec.n_des + spec.n_gen] / base

    P_set_des = P_dev[:, g.des_pos]
    # Pre-set each storage SoC to empty/full so the requested injection is
    # feasible during the transition (simulator.py:273-278).
    soc_pre = torch.where(P_set_des <= 0, g.des_soc_min, g.des_soc_max)

    res = transition(
        g,
        soc_pre,
        P_load=P_dev[:, g.load_pos],
        P_pot=P_max,
        P_set_gen=P_dev[:, g.gen_pos],
        Q_set_gen=Q_dev[:, g.gen_pos],
        P_set_des=P_set_des,
        Q_set_des=Q_dev[:, g.des_pos],
        x_tol=x_tol,
        max_iter=max_iter,
        pf_method=pf_method,
    )
    # Override the SoC with the requested initial value (simulator.py:284-288;
    # the reference does not clip it here).
    return dataclasses.replace(res.state, des_soc=soc_target.to(g.dtype))
