"""The physics transition on tensors.

The counterpart of ``gym_anm_tpu.core.transition`` (``transition``,
``resolve_solver_path`` and ``sim_reset``), i.e. of the reference's
``Simulator.transition`` (simulator.py:464-537) and ``Simulator.reset``
(simulator.py:225-293):

1. map requested device set-points onto feasible (P, Q) injections (loads:
   clip + Q/P ratio; generators/storage: exact polytope projection),
2. update storage SoC,
3. aggregate bus injections with the static bus-device incidence,
4. solve the AC power flow (see :func:`resolve_solver_path`),
5. recover slack/bus/branch electrical quantities,
6. compute the energy-loss + constraint-penalty reward.

``pf_method="fused"``/``"fused_hybrid"`` run all six stages in one launch of
the whole-transition kernel (``ops/step_cuda.py``).  Each kernel runs on a
CUDA float32 batch; on the CPU its plain PyTorch twin runs instead.
``pf_method="tree_xla"`` runs the tree-NR kernel's plain twin on every
device (the JAX package's XLA level sweep, an ablation).

All power quantities are per-unit; complex quantities are (re, im) real
pairs.  Dynamic inputs carry one leading batch axis ``[B, k]``.  The
incidence and admittance products are one-shot contractions in the working
dtype: float32 products stay in full float32 (TF32 is never enabled here).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops.nr_cuda import NN_MAX, solve_pfe_nr
from ..ops.power_flow import cmul as _cmul, solve_pfe
from ..ops.step_cuda import fused_transition, tree_form
from ..ops.tree_cuda import solve_pfe_tree
from .grid import GridTensors, POLY_ROW_P_CAP, POLY_ROW_P_FLOOR
from .state import SimState

# Every solver path of the JAX package.
PF_METHODS = ("tree", "tree_xla", "pallas", "hybrid", "fused", "fused_hybrid", "scan", "while", "xla_hybrid")
# The methods the dense kernels compute; they take systems of at most NN_MAX
# unknowns.  Past NN_MAX, "fused" runs on a radial grid without pivoting in
# the whole-transition kernel's tree form, which takes any size.
DENSE_KERNEL_METHODS = ("pallas", "fused", "fused_hybrid")


class TransitionResult(NamedTuple):
    state: SimState
    reward: torch.Tensor
    e_loss: torch.Tensor
    penalty: torch.Tensor
    pfe_converged: torch.Tensor


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


def dense_kernels_refusal(pf_method: str, n_bus: int) -> ValueError:
    """The error of a dense-kernel method on a grid beyond ``NN_MAX``
    unknowns."""
    n = 2 * (n_bus - 1)
    return ValueError(
        "pf_method=%r unsupported at %d buses: the per-lane %d x %d Jacobian exceeds the dense kernels' %d "
        "unknowns. Use 'tree' (exact), 'fused' (exact, on a radial grid without pivoting), 'hybrid' "
        "(chord-only) or 'scan'." % (pf_method, n_bus, n, n, NN_MAX)
    )


def resolve_solver_path(g: GridTensors, pf_method: str, nr_pivot: bool):
    """The solver :func:`transition` dispatches to, as ``(path,
    effective_pf_method)``; the single source of the dispatch.

    ``path`` is ``"fused_kernel"`` (the whole-transition kernel),
    ``"nr_kernel"`` (the dense-NR kernel), ``"tree_kernel"`` (the tree-NR
    kernel, radial grids only), ``"tree_plain"`` (``"tree_xla"``: the
    tree-NR kernel's plain twin on every device, the counterpart of the JAX
    package's XLA level sweep; the one path where a kernel's plain twin runs
    on the card on purpose, as an ablation) or ``"torch"`` (the plain
    ``solve_pfe``).  The kernels run on a CUDA float32 batch and their plain
    twins on the CPU.  ``effective_pf_method`` is ``pf_method`` after the
    JAX package's semantic downgrades: a grid without a load, a generator
    and a storage unit runs ``"fused"`` as ``"pallas"`` and
    ``"fused_hybrid"`` as ``"hybrid"``.  On a grid of more than ``NN_MAX``
    unknowns, which the dense kernels do not take, ``"fused"`` runs the
    whole-transition kernel in its tree form where the grid has one and
    ``nr_pivot`` is off (:func:`~gym_anm_tpu_torch.ops.step_cuda.tree_form`);
    otherwise ``"pallas"``, ``"fused"`` and ``"fused_hybrid"`` raise
    (:func:`dense_kernels_refusal`).  ``"hybrid"`` is there the JAX
    package's chord-only ablation of that size
    (``gym_anm_tpu/envs/feeder141.py``), which both packages compute on the
    plain solver.
    """
    if pf_method not in PF_METHODS:
        raise ValueError("pf_method %r is not supported; the port has %s" % (pf_method, PF_METHODS))
    if pf_method in ("tree", "tree_xla"):
        if g.tree is None:
            raise ValueError(
                "pf_method=%r requires a radial network (a tree rooted at the "
                "slack bus); this network is meshed or disconnected" % (pf_method,)
            )
        return ("tree_kernel" if pf_method == "tree" else "tree_plain"), pf_method
    if 2 * (g.spec.n_bus - 1) > NN_MAX:
        if pf_method == "fused" and g.step is not None and tree_form(g.step, pivot=nr_pivot):
            return "fused_kernel", "fused"
        if pf_method in DENSE_KERNEL_METHODS:
            raise dense_kernels_refusal(pf_method, g.spec.n_bus)
        return "torch", pf_method
    eff = pf_method
    if eff in ("fused", "fused_hybrid"):
        if g.step is not None:
            return "fused_kernel", eff
        eff = "pallas" if eff == "fused" else "hybrid"
    if eff in ("pallas", "hybrid"):
        return "nr_kernel", eff
    return "torch", eff


def capturable(path: str) -> bool:
    """Whether a CUDA graph can hold a transition on the solver ``path``
    (:func:`resolve_solver_path`'s): the kernels' paths.  The plain solvers
    end their NR loops on a host read of the lanes' convergence, which a
    capture cannot make."""
    return path in ("tree_kernel", "nr_kernel", "fused_kernel")


def _fused(g: GridTensors, args, x_tol, max_iter, chord_iters, nr_pivot) -> TransitionResult:
    """The whole transition in one launch (``ops/step_cuda.py``)."""
    o = fused_transition(
        g.step, *args, x_tol=x_tol, max_iter=max_iter, chord_iters=chord_iters, pivot=nr_pivot
    )
    converged = o.diff[:, 0] <= x_tol
    e_loss, penalty = o.e_loss[:, 0], o.penalty[:, 0]
    state = SimState(
        dev_p=o.dev_p,
        dev_q=o.dev_q,
        des_soc=o.soc_new,
        gen_p_pot=o.p_pot,
        bus_v_re=o.v_re,
        bus_v_im=o.v_im,
        bus_i_re=o.i_re,
        bus_i_im=o.i_im,
        bus_p=o.bus_p,
        bus_q=o.bus_q,
        br_if_re=o.if_re,
        br_if_im=o.if_im,
        br_it_re=o.it_re,
        br_it_im=o.it_im,
        br_p_from=o.p_from,
        br_q_from=o.q_from,
        br_p_to=o.p_to,
        br_q_to=o.q_to,
        br_s=o.s_max,
        pfe_converged=converged,
    )
    return TransitionResult(state, -(e_loss + penalty), e_loss, penalty, converged)


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
    chord_iters=16,
    nr_pivot=False,
    v_init=None,
) -> TransitionResult:
    """One physics transition (simulator.py:464-537). All inputs in p.u.

    ``des_soc [B, n_des]``, ``P_load [B, n_load]``, ``P_pot [B, n_gen]``,
    ``P_set_gen, Q_set_gen [B, n_gen]``, ``P_set_des, Q_set_des [B, n_des]``.

    ``pf_method`` (one of :data:`PF_METHODS`, dispatched by
    :func:`resolve_solver_path`): ``"tree"`` is exact per-lane NR with the
    tree block elimination (radial grids), ``"tree_xla"`` the same in plain
    PyTorch; ``"pallas"`` dense per-lane NR,
    ``"hybrid"`` the same after ``chord_iters`` chord iterations;
    ``"fused"``/``"fused_hybrid"`` those two solves inside the
    whole-transition kernel; ``"scan"``/``"while"``/``"xla_hybrid"`` the
    plain ``solve_pfe`` methods.  ``max_iter`` is the true-NR budget (the
    tail after the chord prefix for the hybrid methods); ``nr_pivot``
    turns on partial pivoting in the dense NR elimination.

    ``v_init`` optionally warm-starts the power flow from bus voltages
    ``(v_re [B, n], v_im [B, n])``, e.g. the previous step's
    (``SimState.bus_v_re/bus_v_im``): per lane the solve starts from
    whichever of {warm point, flat start} has the smaller true mismatch;
    absorbing and reborn lanes (zero or out-of-window voltages) flat-start,
    and the convergence decision is unchanged.  The fused paths have no warm
    start and raise.
    """
    path, method = resolve_solver_path(g, pf_method, nr_pivot)
    if v_init is not None and path == "fused_kernel":
        # As in the JAX package: the whole-transition kernel has no warm form.
        raise ValueError(
            "warm starts (v_init) are not supported on the fused whole-transition "
            "kernel; use pf_method='pallas'/'hybrid'/'tree' for warm-started solves"
        )
    chord = chord_iters if method in ("hybrid", "fused_hybrid") else 0
    if path == "fused_kernel":
        args = (des_soc, P_load, P_pot, P_set_gen, Q_set_gen, P_set_des, Q_set_des)
        return _fused(g, args, x_tol, max_iter, chord, nr_pivot)
    spec = g.spec
    dev_p, dev_q, new_soc, p_pot = _map_set_points(
        g, des_soc, P_load, P_pot, P_set_gen, Q_set_gen, P_set_des, Q_set_des
    )

    # Bus aggregation through the static incidence (simulator.py:539-549).
    bus_p = dev_p @ g.inc_bus_dev.T
    bus_q = dev_q @ g.inc_bus_dev.T

    # Newton-Raphson load flow; the slack bus is internal index 0.
    p_in, q_in = bus_p[:, 1:], bus_q[:, 1:]
    if path in ("tree_kernel", "tree_plain"):
        v_re, v_im, _, _, converged = solve_pfe_tree(
            g.tree, p_in, q_in, x_tol=x_tol, max_iter=max_iter, init=v_init, plain=path == "tree_plain"
        )
    elif path == "nr_kernel":
        v_re, v_im, _, _, converged = solve_pfe_nr(
            g.Y_re, g.Y_im, g.J0inv, p_in, q_in,
            x_tol=x_tol, max_iter=max_iter, chord_iters=chord, pivot=nr_pivot, init=v_init,
        )
    else:
        v_re, v_im, _, _, converged = solve_pfe(
            g.Y_re, g.Y_im, p_in, q_in, x_tol=x_tol, max_iter=max_iter,
            method="hybrid" if method == "xla_hybrid" else method, chord_iters=chord_iters, J0inv=g.J0inv,
            init=v_init,
        )

    # Nodal currents I = Y V and slack power (solve_load_flow.py:54-72; NaN
    # slack power becomes +inf).  V_slack = 1 + 0j, so S_slack = conj(I_0).
    i_re = v_re @ g.Y_re.T - v_im @ g.Y_im.T
    i_im = v_im @ g.Y_re.T + v_re @ g.Y_im.T
    p0 = torch.where(torch.isnan(i_re[:, 0]), g.inf, i_re[:, 0])
    q0 = torch.where(torch.isnan(i_im[:, 0]), g.inf, -i_im[:, 0])
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


def sim_reset(
    g: GridTensors, s0, x_tol=1e-5, max_iter=100, pf_method="tree", chord_iters=16, nr_pivot=False
) -> SimState:
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
        chord_iters=chord_iters,
        nr_pivot=nr_pivot,
    )
    # Override the SoC with the requested initial value (simulator.py:284-288;
    # the reference does not clip it here).
    return dataclasses.replace(res.state, des_soc=soc_target.to(g.dtype))
