"""The whole physics transition in one launch: the CUDA kernel and its plain
PyTorch twin.

The counterpart of ``gym_anm_tpu.ops.pallas_step``.  Per env lane it computes
what the TPU kernel ``_step_tile_kernel`` computes: load clipping and the Q/P
ratio, generator-potential clipping and the storage SoC-rate polytope rows,
the exact projection of every set-point onto its capability polytope (the
point, the feet of the perpendiculars, then the vertices, with a running
minimum), the SoC update, device assembly and bus aggregation, the NR
solve, slack recovery (NaN becomes +inf), branch currents and flows, and the
energy-loss and penalty terms.

The solve takes one of two forms, chosen by :func:`tree_form` from the grid
and the call: on a radial grid (one with a tree schedule,
:class:`~gym_anm_tpu_torch.ops.tree_cuda.DeviceSchedule`) without a chord
prefix or pivoting, the tree-NR kernel's leaf-to-root block elimination on
the grid's slots (:func:`~gym_anm_tpu_torch.ops.tree_cuda.tree_newton_plain`
or its kernel form, ``csrc/tree_core.cuh``); otherwise the dense NR
(:func:`~gym_anm_tpu_torch.ops.nr_cuda.nr_core_plain` or its kernel form).
Both are exact Newton steps on the same equations from the flat start.  The
dense form takes at most 64 unknowns; the tree form takes a radial grid of
any size whose lane a block's shared memory holds.

Both versions work on packed batch-last buffers: the lane inputs ``[K_in,
B]`` (``soc, P_load, P_pot, P_set_gen, Q_set_gen, P_set_des, Q_set_des``)
and the outputs ``[K_out, B]`` (the :class:`FusedStepOutputs` fields in
order).  :func:`fused_transition` packs ``[B, k]`` inputs, dispatches on the
device (a CUDA float32 batch launches ``csrc/step_fused.cu``, a CPU batch
runs :func:`fused_transition_plain`, a CUDA float64 batch raises) and hands
the fields back batch-first as views of one transposed buffer.

The grid's constants come from :class:`StepTables`, built once per grid,
with the grid's tree schedule where it has one.
The plain twin follows the kernel's order of operations; the projection's
vertex determinants are taken from the normals in the working dtype, as the
TPU kernel does, not precomputed in float64 as ``LanesProjector`` does.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.grid import POLY_ROW_P_CAP, POLY_ROW_P_FLOOR
from .nr_cuda import NN_MAX, nr_core_plain, nr_dense_flops_per_lane, nr_flops_per_lane
from .power_flow import flat_start_jacobian_inv_np
from .tree_cuda import DeviceSchedule, device_counters, sum_counters, tree_newton_plain, tree_nr_flops_per_lane

# Launches of the CUDA kernel in this process (one per successful launch).
KERNEL_LAUNCHES = 0
# Those of them that solved in the tree form (:func:`tree_form`).
TREE_LAUNCHES = 0
# Lane-solves of the fused transition in this process, the kernel's and the
# plain twin's (B a call).  Like KERNEL_LAUNCHES, a host count that a CUDA
# graph's replay adds its captured solves to.
LANE_SOLVES = 0
# The NR iterations of those lane-solves (chord steps included), on the
# devices that solved them: per device an int64 [2], the iterations summed
# over lanes and the lanes that ended unconverged.  The kernel adds to them
# in its epilogue, so a replayed CUDA graph counts without a host read; the
# plain twin adds the same in PyTorch.  They are not the tree-NR kernel's
# (``tree_cuda.iteration_counts``).
_ITERATION_COUNTS: dict = {}

# The kernel's table and size slots, in the order of the enums of
# csrc/step_fused.cu.
FLOAT_TABLES = (
    "Yre", "Yim", "J0inv", "Gx", "Gy", "h0", "loadc", "genc", "desc", "busv", "eloss", "rate", "brcoef",
)
INT_TABLES = ("load_pos", "gen_pos", "des_pos", "bus_ptr", "bus_dev", "br_ft", "rer", "cand")
DIMS = ("n", "d", "L", "n_load", "n_gen", "n_des", "n_rer", "slack", "rows", "cap_row", "floor_row", "n_cand")
# The tree form's schedule tables (attributes of the DeviceSchedule) and
# sizes, in the order of the enums of csrc/step_fused.cu.
TREE_TABLES = ("ycols", "par", "children", "levels", "slot_sel", "busm1_slot")
TREE_DIMS = ("S", "maxC", "n_levels")


def iteration_counts(device) -> torch.Tensor:
    """``device``'s iteration counters (see ``_ITERATION_COUNTS``), made on
    first use.  Building :class:`StepTables` makes them, before any CUDA
    graph that runs the transition on the device can be captured."""
    return device_counters(_ITERATION_COUNTS, device)


class IterationCounts(NamedTuple):
    """The fused transition's counters, summed over devices.  Its second
    slot is not the tree-NR solve's ``budget_hits``: a dense solve's chord
    prefix and a NaN lane end unconverged before the NR budget."""
    iterations: int
    unconverged: int  # lanes that ended unconverged, NaN lanes included


def read_iteration_counts() -> IterationCounts:
    """The counters of every lane-solve of the fused transition in this
    process, on every device (a host read of each device's counters)."""
    return IterationCounts(*sum_counters(_ITERATION_COUNTS))


class FusedStepOutputs(NamedTuple):
    """The transition's outputs, batch-first ``[B, k]``; ``n_iter`` (the NR
    iterations, as floats) is the port's addition to the JAX package's 22
    fields."""

    dev_p: torch.Tensor
    dev_q: torch.Tensor
    soc_new: torch.Tensor
    p_pot: torch.Tensor
    v_re: torch.Tensor
    v_im: torch.Tensor
    i_re: torch.Tensor
    i_im: torch.Tensor
    bus_p: torch.Tensor
    bus_q: torch.Tensor
    if_re: torch.Tensor
    if_im: torch.Tensor
    it_re: torch.Tensor
    it_im: torch.Tensor
    p_from: torch.Tensor
    q_from: torch.Tensor
    p_to: torch.Tensor
    q_to: torch.Tensor
    s_max: torch.Tensor
    e_loss: torch.Tensor
    penalty: torch.Tensor
    diff: torch.Tensor
    n_iter: torch.Tensor


def fused_transition_supported(spec) -> bool:
    """The fused transition needs at least one load, one generator and one
    storage unit (as in the JAX package); otherwise ``pf_method="fused"``
    runs the unfused ``"pallas"`` path and ``"fused_hybrid"`` ``"hybrid"``."""
    return bool(spec.n_load and spec.n_gen and spec.n_des)


def _candidates(G, eps):
    """The projection's candidates in the TPU kernel's order: ``(r, -1)`` for
    the foot on row r, then ``(r, s)`` for the vertex of rows r < s, each
    kept only if present on some device (the host-side pruning of
    ``_project_lanes_in_kernel``, computed from the normals as stored)."""
    C, m, _ = G.shape
    g_finite = np.all(np.isfinite(G), axis=-1)
    g_nonzero = (np.abs(G).sum(axis=-1) > 0) & g_finite
    cand = [(r, -1) for r in range(m) if g_nonzero[:, r].any()]
    for r in range(m):
        for s in range(r + 1, m):
            det = G[:, r, 0] * G[:, s, 1] - G[:, r, 1] * G[:, s, 0]
            nrm = np.sqrt(np.maximum((G[:, r] ** 2).sum(-1) * (G[:, s] ** 2).sum(-1), 0.0))
            if (np.isfinite(det) & (np.abs(det) > eps * np.maximum(1.0, nrm))).any():
                cand.append((r, s))
    return tuple(cand)


class Structure(NamedTuple):
    """The int tables as Python tuples, for the plain twin's loops."""

    cand: tuple  # ((r, s), ...), s = -1 for a foot
    devs_at_bus: tuple  # per bus, the device positions attached to it
    rer_pairs: tuple  # ((gen index, device position), ...)
    positions: dict  # "load_pos" / "gen_pos" / "des_pos" -> device positions


@dataclasses.dataclass(frozen=True, eq=False)
class StepTables:
    """The grid's constants for the fused transition, on one device in one
    float dtype: the device-side form of the TPU kernel's ``_spec_static``
    closure and constant refs, with the kernel's host arguments built once."""

    dtype: torch.dtype
    device: torch.device  # the tables' device, as tensors report it
    eps: float  # projection tolerance: 1e-5 in float32, 1e-9 in float64
    delta_t: float
    dt_lamb: float  # delta_t * lamb
    dims: dict  # name -> int, see DIMS
    f: dict  # name -> float tensor, see FLOAT_TABLES
    i: dict  # name -> int32 tensor, see INT_TABLES
    c_args: tuple  # ctypes arrays: float-table pointers, int-table pointers, sizes
    tree: object  # tree_cuda.DeviceSchedule of a radial grid, None for a meshed one
    tree_args: tuple  # ctypes arrays: the schedule's table pointers and sizes; () without one

    @classmethod
    def from_spec(cls, spec, device, dtype: torch.dtype) -> "StepTables":
        if not fused_transition_supported(spec):
            raise ValueError("the fused transition needs a load, a generator and a storage unit")
        device = torch.device(device)
        eps = 1e-9 if dtype == torch.float64 else 1e-5
        G = np.concatenate([np.asarray(spec.gen_G), np.asarray(spec.des_G)], axis=0)  # [C, rows, 2]
        cand = _candidates(G, eps)
        inc = np.asarray(spec.inc_bus_dev)
        devs_at_bus = tuple(tuple(int(x) for x in np.nonzero(inc[b])[0]) for b in range(spec.n_bus))
        rer_pairs = tuple(
            (int(g), int(p)) for g, p in zip(np.asarray(spec.rer_gen_idx), np.asarray(spec.rer_pos))
        )
        a = lambda *xs: np.stack([np.asarray(x, np.float64) for x in xs], axis=1)
        floats = {
            "Yre": spec.Y_re,
            "Yim": spec.Y_im,
            "J0inv": flat_start_jacobian_inv_np(spec.Y_re, spec.Y_im, dtype=np.float64),
            "Gx": G[:, :, 0],
            "Gy": G[:, :, 1],
            "h0": np.concatenate([np.asarray(spec.gen_h0), np.asarray(spec.des_h0)], axis=0),
            "loadc": a(spec.load_p_min, spec.load_p_max, spec.load_qp),
            "genc": a(spec.gen_p_min, spec.gen_p_max),
            "desc": a(spec.des_soc_min, spec.des_soc_max, spec.des_eff),
            "busv": a(spec.bus_v_min, spec.bus_v_max),
            "eloss": spec.eloss_mask,
            "rate": spec.br_rate,
            "brcoef": np.concatenate([spec.br_aff, spec.br_aft, spec.br_atf, spec.br_att], axis=1),  # [L, 8]
        }
        bus_dev = [p for devs in devs_at_bus for p in devs]
        bus_ptr = np.cumsum([0] + [len(devs) for devs in devs_at_bus])
        ints = {
            "load_pos": spec.load_pos,
            "gen_pos": spec.gen_pos,
            "des_pos": spec.des_pos,
            "bus_ptr": bus_ptr,
            "bus_dev": bus_dev,
            "br_ft": np.stack([spec.br_f, spec.br_t], axis=1),
            "rer": np.asarray(rer_pairs, dtype=np.int64).reshape(-1, 2),
            "cand": np.asarray(cand, dtype=np.int64).reshape(-1, 2),
        }
        dims = dict(
            n=spec.n_bus, d=spec.n_dev, L=spec.n_branch, n_load=spec.n_load, n_gen=spec.n_gen,
            n_des=spec.n_des, n_rer=len(rer_pairs), slack=int(spec.slack_pos), rows=G.shape[1],
            cap_row=POLY_ROW_P_CAP, floor_row=POLY_ROW_P_FLOOR, n_cand=len(cand),
        )
        f = {
            k: torch.as_tensor(np.ascontiguousarray(v, np.float64), device=device).to(dtype)
            for k, v in floats.items()
        }
        i = {k: torch.as_tensor(np.ascontiguousarray(v, np.int32), device=device) for k, v in ints.items()}
        # The tensors above (and the schedule's) stay alive with the tables,
        # so the pointers do.
        c_args = (
            (ctypes.c_void_p * len(FLOAT_TABLES))(*(f[k].data_ptr() for k in FLOAT_TABLES)),
            (ctypes.c_void_p * len(INT_TABLES))(*(i[k].data_ptr() for k in INT_TABLES)),
            (ctypes.c_int * len(DIMS))(*(int(dims[k]) for k in DIMS)),
        )
        tree = DeviceSchedule.from_spec(spec, device, dtype)
        iteration_counts(device)
        tree_args = () if tree is None else (
            (ctypes.c_void_p * len(TREE_TABLES))(*(getattr(tree, k).data_ptr() for k in TREE_TABLES)),
            (ctypes.c_int * len(TREE_DIMS))(tree.sched.S, tree.sched.maxC, tree.levels.shape[0]),
        )
        return cls(
            dtype=dtype,
            device=f["Yre"].device,
            eps=eps,
            delta_t=float(spec.delta_t),
            dt_lamb=float(spec.delta_t) * float(spec.lamb),
            dims=dims,
            f=f,
            i=i,
            c_args=c_args,
            tree=tree,
            tree_args=tree_args,
        )

    @functools.cached_property
    def structure(self) -> Structure:
        """The int tables as Python tuples, read from the tensors once."""
        i = {k: t.tolist() for k, t in self.i.items()}
        ptr, dev = i["bus_ptr"], i["bus_dev"]
        return Structure(
            cand=tuple(tuple(c) for c in i["cand"]),
            devs_at_bus=tuple(tuple(dev[ptr[b] : ptr[b + 1]]) for b in range(len(ptr) - 1)),
            rer_pairs=tuple(tuple(r) for r in i["rer"]),
            positions={k: tuple(i[k]) for k in ("load_pos", "gen_pos", "des_pos")},
        )

    @property
    def in_rows(self):
        """Row counts of the packed lane inputs."""
        d = self.dims
        return (d["n_des"], d["n_load"], d["n_gen"], d["n_gen"], d["n_gen"], d["n_des"], d["n_des"])

    @property
    def out_rows(self):
        """Row counts of the packed outputs, one per :class:`FusedStepOutputs` field."""
        d = self.dims
        n, L = d["n"], d["L"]
        return (d["d"], d["d"], d["n_des"], d["n_gen"]) + (n,) * 6 + (L,) * 9 + (1, 1, 1, 1)


def tree_form(st: StepTables, chord_iters: int = 0, pivot: bool = False) -> bool:
    """Whether the fused transition solves in the tree form: on a grid with a
    tree schedule, without a chord prefix and without pivoting.  The kernel
    and its plain twin follow it alike."""
    return st.tree is not None and chord_iters == 0 and not pivot


def step_fused_flops_per_lane(st: StepTables, nr_iters: int, chord_iters: int = 0, pivot: bool = False) -> int:
    """FLOPs one lane of the fused transition needs when its power flow
    takes ``chord_iters`` chord and ``nr_iters`` NR steps, counted from
    ``csrc/step_fused.cu`` with the conventions of
    :func:`~gym_anm_tpu_torch.ops.nr_cuda.nr_dense_flops_per_lane`, which
    counts the dense form's solve;
    :func:`~gym_anm_tpu_torch.ops.tree_cuda.tree_nr_flops_per_lane` counts
    the tree form's (:func:`tree_form`), plus 8 per bus for the slack's
    current.

    The projection is counted per device over the pruned candidate table:
    a foot 18, a vertex 25, plus 4 per active polytope row for each
    feasibility test the kernel reaches (the point's, and a candidate's
    when it is valid; a candidate is assumed to land on finite
    coordinates).  The rest: loads 1 each, storage rate caps 6 and SoC
    update 3 each, 2 per polytope row for the tolerances, 2 per extra
    device summed into a bus, 51 per branch, 2 per device and 2 per
    renewable for the energy loss, 8 per bus for the voltage penalty, 4
    more."""
    d = st.dims
    n_gen, R = d["n_gen"], d["rows"]
    gx, gy = st.f["Gx"].cpu().numpy(), st.f["Gy"].cpu().numpy()
    gfin = np.isfinite(gx) & np.isfinite(gy)
    hfin = np.isfinite(st.f["h0"].cpu().numpy())
    hfin[:, d["cap_row"]] = True  # the potential or discharge cap of this step
    hfin[n_gen:, d["floor_row"]] = True  # the charge cap
    feas = 4 * (gfin & hfin).sum(axis=1)  # one feasibility test, per device
    proj = 0
    for c in range(gx.shape[0]):
        proj += 2 * R + feas[c]
        for r, s in st.structure.cand:
            if s < 0:
                valid = (abs(gx[c, r]) + abs(gy[c, r]) > 0) and gfin[c, r] and hfin[c, r]
                proj += 18 + (feas[c] if valid else 0)
            else:
                det = gx[c, r] * gy[c, s] - gy[c, r] * gx[c, s]
                nrm = np.sqrt(max((gx[c, r] ** 2 + gy[c, r] ** 2) * (gx[c, s] ** 2 + gy[c, s] ** 2), 0.0))
                valid = np.isfinite(det) and abs(det) > st.eps * max(1.0, nrm) and hfin[c, r] and hfin[c, s]
                proj += 25 + (feas[c] if valid else 0)
    per_bus = np.diff(st.i["bus_ptr"].cpu().numpy())[1:]
    aggregate = 2 * int(np.maximum(per_bus - 1, 0).sum())
    rest = (d["n_load"] + 9 * d["n_des"] + aggregate + 51 * d["L"] + 2 * d["d"] + 2 * d["n_rer"]
            + 8 * d["n"] + 4)
    if tree_form(st, chord_iters, pivot):
        solve = tree_nr_flops_per_lane(st.tree.sched.S, nr_iters) + 8 * d["n"]
    else:
        solve = nr_dense_flops_per_lane(d["n"], nr_iters, chord_iters)
    return int(proj) + rest + solve


def fused_step_flops_per_lane(spec, max_iter: int, chord_iters: int = 0, pivot: bool = False) -> int:
    """Analytic FLOP count of one lane's fused transition on the TPU, a copy
    of ``gym_anm_tpu.ops.pallas_step.fused_step_flops_per_lane``: the NR
    term of :func:`~gym_anm_tpu_torch.ops.nr_cuda.nr_flops_per_lane` plus
    the projection over every candidate, SoC update, bus aggregation,
    branch flows and reward.  Bounds on the card use
    :func:`step_fused_flops_per_lane` instead."""
    n = spec.n_bus
    C = spec.n_gen + spec.n_des
    m_rows = np.asarray(spec.gen_G).shape[1]
    n_cand = m_rows + m_rows * (m_rows - 1) // 2
    proj = C * n_cand * (4 * m_rows + 35)
    aggregate = 4 * n * spec.n_dev
    flows = 44 * spec.n_branch
    reward = 8 * n + 6 * spec.n_branch
    soc = 12 * spec.n_des
    nr = nr_flops_per_lane(n, max_iter, chord_iters, pivot=pivot)
    return nr + proj + aggregate + flows + reward + soc


def _project_plain(st: StepTables, px, py, h):
    """Exact projection of ``(px, py) [C, B]`` onto ``{G x <= h}``, ``h [C,
    rows, B]``, over the candidates of ``st.structure.cand`` with a running
    minimum."""
    gx, gy = st.f["Gx"], st.f["Gy"]  # [C, rows]
    hfin = torch.isfinite(h)
    tol = st.eps * (1.0 + torch.where(hfin, h.abs(), torch.zeros_like(h)))
    bound = h + tol
    gfin = torch.isfinite(gx) & torch.isfinite(gy)
    inactive = ~(gfin[:, :, None] & hfin)

    def feasible(x, y):
        gxv = gx[:, :, None] * x[:, None, :] + gy[:, :, None] * y[:, None, :]
        return ((gxv <= bound) | inactive).all(dim=1)

    best_x, best_y = px, py
    best_d = torch.where(feasible(px, py), torch.zeros_like(px), torch.full_like(px, float("inf")))
    for r, s in st.structure.cand:
        gxr, gyr, hr = gx[:, r : r + 1], gy[:, r : r + 1], h[:, r]
        if s < 0:
            gg = gxr * gxr + gyr * gyr
            gg_safe = torch.where(gg > 0, gg, torch.ones_like(gg))
            coef = ((gxr * px + gyr * py) - hr) / gg_safe
            x, y = px - coef * gxr, py - coef * gyr
            valid = ((gxr.abs() + gyr.abs() > 0) & gfin[:, r : r + 1]) & hfin[:, r]
        else:
            gxs, gys, hs = gx[:, s : s + 1], gy[:, s : s + 1], h[:, s]
            det = gxr * gys - gyr * gxs
            nrm = torch.sqrt(torch.clamp_min((gxr * gxr + gyr * gyr) * (gxs * gxs + gys * gys), 0.0))
            det_ok = torch.isfinite(det) & (det.abs() > st.eps * torch.clamp_min(nrm, 1.0))
            safe_det = torch.where(det_ok, det, torch.ones_like(det))
            x = (hr * gys - hs * gyr) / safe_det
            y = (gxr * hs - gxs * hr) / safe_det
            valid = (det_ok & hfin[:, r]) & hfin[:, s]
        dx, dy = x - px, y - py
        d = dx * dx + dy * dy
        ok = valid & torch.isfinite(x) & torch.isfinite(y) & feasible(x, y) & (d < best_d)
        best_x = torch.where(ok, x, best_x)
        best_y = torch.where(ok, y, best_y)
        best_d = torch.where(ok, d, best_d)
    return best_x, best_y


def _tree_solve_plain(st: StepTables, bus_p, bus_q, x_tol, max_iter):
    """The tree form's solve, as the kernel takes it: the non-slack buses'
    injections (lists of ``[B]`` rows in bus order) into the schedule's
    slots (a pad slot injects 0), :func:`tree_newton_plain`, then V and I in
    bus order, the slack's V at 1+0j and its current the sequential sum over
    row 0 of Y (the dense form's).  Returns what ``nr_core_plain`` returns;
    adds nothing to the tree-NR kernel's counters."""
    ds = st.tree
    zero = torch.zeros_like(bus_p[0])
    p = torch.stack(bus_p + [zero])[ds.slot_sel]
    q = torch.stack(bus_q + [zero])[ds.slot_sel]
    vr_s, vi_s, ir_s, ii_s, diff, it = tree_newton_plain(ds, p, q, x_tol=x_tol, max_iter=max_iter)
    vr = torch.cat([torch.ones_like(zero)[None], vr_s[ds.busm1_slot]])
    vi = torch.cat([zero[None], vi_s[ds.busm1_slot]])
    yr, yi = st.f["Yre"][0], st.f["Yim"][0]
    ir0, ii0 = zero, zero
    for k in range(vr.shape[0]):
        ir0 = ir0 + (yr[k] * vr[k] - yi[k] * vi[k])
        ii0 = ii0 + (yr[k] * vi[k] + yi[k] * vr[k])
    ir = torch.cat([ir0[None], ir_s[ds.busm1_slot]])
    ii = torch.cat([ii0[None], ii_s[ds.busm1_slot]])
    return vr, vi, ir, ii, diff, it


def fused_transition_plain(st: StepTables, lanes_in, x_tol=1e-5, max_iter=10, chord_iters=0, pivot=False):
    """The plain twin of the fused kernel on packed buffers: ``lanes_in
    [K_in, B]`` -> ``[K_out, B]``, in the tables' dtype on any device, in the
    form :func:`tree_form` chooses."""
    dm = st.dims
    n_load, n_gen, n_des, d = dm["n_load"], dm["n_gen"], dm["n_des"], dm["d"]
    dt = st.delta_t
    soc, pload, ppot, psg, qsg, psd, qsd = torch.split(lanes_in, st.in_rows)
    zero = soc[0] * 0.0
    dev_p, dev_q = [zero] * d, [zero] * d

    loadc, genc, desc = st.f["loadc"], st.f["genc"], st.f["desc"]
    load_p = torch.clamp(pload, loadc[:, 0:1], loadc[:, 1:2])
    load_q = load_p * loadc[:, 2:3]
    p_pot = torch.clamp(ppot, genc[:, 0:1], genc[:, 1:2])
    eff = desc[:, 2:3]
    dcap = eff * (soc - desc[:, 0:1]) / dt
    ccap = -(soc - desc[:, 1:2]) / (dt * eff)
    h = st.f["h0"][:, :, None].expand(-1, -1, soc.shape[1]).clone()
    h[:n_gen, dm["cap_row"]] = p_pot
    h[n_gen:, dm["cap_row"]] = dcap
    h[n_gen:, dm["floor_row"]] = ccap
    x, y = _project_plain(st, torch.cat([psg, psd]), torch.cat([qsg, qsd]), h)
    gen_p, gen_q, des_p, des_q = x[:n_gen], y[:n_gen], x[n_gen:], y[n_gen:]
    soc_new = torch.where(des_p <= 0, soc - (dt * eff) * des_p, soc - (dt * des_p) / eff)
    soc_new = torch.clamp(soc_new, desc[:, 0:1], desc[:, 1:2])
    devices = ((load_p, load_q, "load_pos"), (gen_p, gen_q, "gen_pos"), (des_p, des_q, "des_pos"))
    for p_rows, q_rows, pos in devices:
        for k, dd in enumerate(st.structure.positions[pos]):
            dev_p[dd], dev_q[dd] = p_rows[k], q_rows[k]

    bus_p, bus_q = [zero], [zero]
    for devs in st.structure.devs_at_bus[1:]:
        ap, aq = zero, zero
        for k, dd in enumerate(devs):
            ap = dev_p[dd] if k == 0 else ap + dev_p[dd]
            aq = dev_q[dd] if k == 0 else aq + dev_q[dd]
        bus_p.append(ap)
        bus_q.append(aq)
    if tree_form(st, chord_iters, pivot):
        vr, vi, ir, ii, diff, it = _tree_solve_plain(st, bus_p[1:], bus_q[1:], x_tol, max_iter)
    else:
        vr, vi, ir, ii, diff, it = nr_core_plain(
            st.f["Yre"], st.f["Yim"], st.f["J0inv"], torch.stack(bus_p[1:]), torch.stack(bus_q[1:]),
            x_tol=x_tol, max_iter=max_iter, chord_iters=chord_iters, pivot=pivot,
        )
    inf = torch.full_like(zero, float("inf"))
    p0 = torch.where(torch.isnan(ir[0]), inf, ir[0])
    q0 = torch.where(torch.isnan(ii[0]), inf, -ii[0])
    dev_p[dm["slack"]], dev_q[dm["slack"]] = p0, q0
    bus_p[0], bus_q[0] = p0, q0

    ft = st.i["br_ft"].long()
    cf = st.f["brcoef"]
    c = [cf[:, k : k + 1] for k in range(8)]
    vfr, vfi, vtr, vti = vr[ft[:, 0]], vi[ft[:, 0]], vr[ft[:, 1]], vi[ft[:, 1]]
    if_re = c[0] * vfr - c[1] * vfi + c[2] * vtr - c[3] * vti
    if_im = c[0] * vfi + c[1] * vfr + c[2] * vti + c[3] * vtr
    it_re = c[6] * vtr - c[7] * vti + c[4] * vfr - c[5] * vfi
    it_im = c[6] * vti + c[7] * vtr + c[4] * vfi + c[5] * vfr
    p_f = vfr * if_re + vfi * if_im
    q_f = vfi * if_re - vfr * if_im
    p_t = vtr * it_re + vti * it_im
    q_t = vti * it_re - vtr * it_im
    s_f, s_t = torch.sqrt(p_f * p_f + q_f * q_f), torch.sqrt(p_t * p_t + q_t * q_t)
    s_max = torch.sign(p_f) * torch.maximum(s_f, s_t)

    br_pen = torch.zeros_like(zero)
    over = torch.clamp_min(s_max.abs() - st.f["rate"][:, None], 0.0)
    for l in range(dm["L"]):
        br_pen = br_pen + over[l]
    e_loss = torch.zeros_like(zero)
    eloss = st.f["eloss"]
    for k in range(d):
        e_loss = e_loss + eloss[k] * dev_p[k]
    for gi, dpos in st.structure.rer_pairs:
        e_loss = e_loss + torch.clamp_min(p_pot[gi] - dev_p[dpos], 0.0)
    e_loss = e_loss * dt
    busv = st.f["busv"]
    v_pen = torch.zeros_like(zero)
    vmag = torch.sqrt(vr * vr + vi * vi)
    for b in range(dm["n"]):
        over_v = torch.clamp_min(vmag[b] - busv[b, 1], 0.0) + torch.clamp_min(busv[b, 0] - vmag[b], 0.0)
        v_pen = v_pen + over_v
    penalty = (v_pen + br_pen) * st.dt_lamb

    rows = [torch.stack(dev_p), torch.stack(dev_q), soc_new, p_pot, vr, vi, ir, ii, torch.stack(bus_p),
            torch.stack(bus_q), if_re, if_im, it_re, it_im, p_f, q_f, p_t, q_t, s_max,
            e_loss[None], penalty[None], diff[None], it.to(lanes_in.dtype)[None]]
    _count_plain(it, diff, x_tol)
    return torch.cat(rows)


def _count_plain(it, diff, x_tol):
    """The kernel's epilogue count, in PyTorch, for the plain twin."""
    global LANE_SOLVES
    counts = iteration_counts(it.device)
    counts[0] += it.sum()
    counts[1] += (~(diff <= x_tol)).sum()
    LANE_SOLVES += it.shape[0]


def _check_kernel_args(st: StepTables, lanes_in, tree: bool):
    if not lanes_in.is_cuda:
        raise ValueError("lanes_in must be a CUDA tensor for the fused-transition kernel")
    if lanes_in.dtype != torch.float32:
        raise TypeError("the fused-transition kernel takes float32 only; lanes_in is %s" % lanes_in.dtype)
    if not lanes_in.is_contiguous():
        raise ValueError("lanes_in must be contiguous")
    if lanes_in.dim() != 2 or lanes_in.shape[0] != sum(st.in_rows) or lanes_in.shape[1] == 0:
        raise ValueError("lanes_in must be [K_in=%d, B>0]; got %s" % (sum(st.in_rows), tuple(lanes_in.shape)))
    if st.dtype != torch.float32 or st.device != lanes_in.device:
        raise ValueError("the step tables must be float32 on the inputs' device")
    if not tree and 2 * (st.dims["n"] - 1) > NN_MAX:
        raise ValueError("the fused-transition kernel's dense form solves systems of up to %d unknowns" % NN_MAX)


def fused_transition_cuda(st: StepTables, lanes_in, x_tol=1e-5, max_iter=10, chord_iters=0, pivot=False):
    """Launch the CUDA fused-transition kernel (``csrc/step_fused.cu``) on a
    packed float32 CUDA buffer ``lanes_in [K_in, B]``, in the form
    :func:`tree_form` chooses; returns ``[K_out, B]``.  Raises on anything
    else and when the launch fails.  The launch adds the lanes' iterations
    to the device's :func:`iteration_counts` itself."""
    global KERNEL_LAUNCHES, TREE_LAUNCHES, LANE_SOLVES
    from ._build import load_library

    tree = tree_form(st, chord_iters, pivot)
    _check_kernel_args(st, lanes_in, tree)
    lib = load_library()
    B = lanes_in.shape[1]
    out = torch.empty((sum(st.out_rows), B), dtype=torch.float32, device=lanes_in.device)
    common = (ctypes.c_float(st.delta_t), ctypes.c_float(st.dt_lamb), lanes_in.data_ptr(), out.data_ptr(), B,
              ctypes.c_float(x_tol), int(max_iter))
    counts = iteration_counts(lanes_in.device).data_ptr()
    stream = torch.cuda.current_stream(lanes_in.device).cuda_stream
    if tree:
        rc = lib.step_fused_tree_f32(*st.c_args, *st.tree_args, *common, counts, stream)
    else:
        rc = lib.step_fused_f32(*st.c_args, *common, int(chord_iters), int(bool(pivot)), counts, stream)
    if rc != 0:
        raise RuntimeError("fused-transition kernel launch failed: CUDA error %d" % rc)
    KERNEL_LAUNCHES += 1
    TREE_LAUNCHES += int(tree)
    LANE_SOLVES += B
    return out


def step_fused_geometry(st: StepTables, chord_iters: int = 0, pivot: bool = False) -> dict:
    """The kernel's launch geometry on the current card for the tables'
    grid, in the form :func:`tree_form` chooses (the fields of
    ``_build.GEOMETRY_FIELDS``)."""
    from ._build import load_library, read_geometry

    lib = load_library()
    if tree_form(st, chord_iters, pivot):
        return read_geometry(lib.step_fused_tree_geometry, st.c_args[2], st.tree_args[1])
    return read_geometry(lib.step_fused_geometry, st.c_args[2], int(chord_iters))


def pack_inputs(des_soc, P_load, P_pot, P_set_gen, Q_set_gen, P_set_des, Q_set_des):
    """The ``[B, k]`` lane inputs as one batch-last buffer ``[K_in, B]``."""
    return torch.cat([a.T for a in (des_soc, P_load, P_pot, P_set_gen, Q_set_gen, P_set_des, Q_set_des)])


def unpack_outputs(st: StepTables, packed) -> FusedStepOutputs:
    """``[K_out, B]`` -> batch-first field views of one transposed copy."""
    return FusedStepOutputs(*torch.split(packed.T.contiguous(), st.out_rows, dim=1))


def fused_transition(
    st: StepTables, des_soc, P_load, P_pot, P_set_gen, Q_set_gen, P_set_des, Q_set_des,
    x_tol=1e-5, max_iter=10, chord_iters=0, pivot=False,
) -> FusedStepOutputs:
    """The whole transition on ``[B, k]`` batches.  A CUDA batch launches the
    kernel (float32 only); a CPU batch runs :func:`fused_transition_plain`."""
    lanes_in = pack_inputs(des_soc, P_load, P_pot, P_set_gen, Q_set_gen, P_set_des, Q_set_des)
    run = fused_transition_cuda if lanes_in.is_cuda else fused_transition_plain
    packed = run(st, lanes_in, x_tol=x_tol, max_iter=max_iter, chord_iters=chord_iters, pivot=pivot)
    return unpack_outputs(st, packed)
