"""Tree-structured Newton-Raphson power flow: the CUDA kernel and its plain
PyTorch version.

The counterpart of ``gym_anm_tpu.ops.pallas_tree``.  Per env lane it
computes the exact polar NR power flow of a radial grid, the same thing as
the TPU kernel ``_tree_tile_kernel``:

* flat start (theta = 0, |V| = 1; the slack is pinned at 1 + 0j) or, given a
  warm point, the per-lane best of {warm, flat}: the warm point where its
  mismatch is finite and smaller than the flat start's;
* per iteration: V, then I = YV over the tree edges (diagonal, parent read
  through the runs, children pushed through the runs), the mismatch
  F = V conj(I) - S and its inf-norm; lanes whose norm is above ``x_tol``
  build the 2x2 polar Jacobian blocks D/L/U, eliminate leaf to root
  (effective diagonal, adjugate inverse, Schur push of M U and M b to the
  parent with M = L D^-1), back-substitute root first and take the step;
* a lane whose mismatch is not above ``x_tol`` (NaN included) is frozen.

The mismatch is evaluated once after each update and carried, as
``gym_anm_tpu.ops.tree_nr.solve_pfe_tree`` does, so ``diff`` is always the
mismatch of the returned point and ``converged = diff <= x_tol``.

Both versions run on the slot layout of :func:`build_tree_schedule`:
non-slack buses renumbered leaves first into contiguous levels, with the
parent map decomposed into constant-offset runs ``(src, k, dst)`` meaning
``parent_slot(src + i) = dst + i``.  The kernel reads the same map as each
slot's parent and its children in run order (:func:`gather_tables`), so a
parent that gathers its children's terms adds them in the order the plain
version pushes them.

:func:`solve_pfe_tree` dispatches on the tensor's device: a CUDA float32
tensor launches the kernel (``csrc/tree_nr.cu``, its solve in
``csrc/tree_core.cuh``); a CPU tensor runs :func:`solve_pfe_tree_plain`.
A CUDA float64 tensor raises: there is no fallback from the GPU to the
plain version or to the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .power_flow import cmul as _cmul, warm_init_theta_vm
from .tree_nr import build_tree_info

# Column layout of the per-slot static table ``ycols [S, 8]``.
_YC_DIAG_RE, _YC_DIAG_IM = 0, 1  # Y[bus, bus]
_YC_UP_RE, _YC_UP_IM = 2, 3  # Y[bus, parent]
_YC_DOWN_RE, _YC_DOWN_IM = 4, 5  # Y[parent, bus]
_YC_HASPAR, _YC_PAD = 6, 7  # non-slack-parent mask; pad-slot mask

# Launches of the CUDA kernel in this process (one per successful launch).
KERNEL_LAUNCHES = 0
# Lane-solves of the tree-NR solve in this process, the kernel's and the
# plain version's (B a solve).  Like KERNEL_LAUNCHES, a host count that a
# CUDA graph's replay adds its captured solves to.
LANE_SOLVES = 0
# The Newton iterations of those lane-solves, on the devices that solved
# them: per device an int64 [2], the iterations summed over lanes and the
# lanes that ended at the NR budget unconverged.  The kernel adds to them in
# its epilogue, so a replayed CUDA graph counts without a host read; the
# plain version adds the same in PyTorch.
_ITERATION_COUNTS: dict = {}


def device_counters(store: dict, device) -> torch.Tensor:
    """The int64 [2] counters that ``store`` keeps for ``device``, made on
    first use (outside inference mode, so that any step may add to them)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    counts = store.get(device)
    if counts is None:
        with torch.inference_mode(False):
            counts = store[device] = torch.zeros((2,), dtype=torch.int64, device=device)
    return counts


def sum_counters(store: dict) -> tuple:
    """The two counters of ``store`` summed over its devices (a host read of
    each device's)."""
    a = b = 0
    for counts in store.values():
        n, m = counts.tolist()
        a, b = a + n, b + m
    return a, b


def iteration_counts(device) -> torch.Tensor:
    """``device``'s iteration counters (see ``_ITERATION_COUNTS``), made on
    first use.  Building a :class:`DeviceSchedule` makes them, before any
    CUDA graph that solves on the device can be captured (a capture would
    record their zeroing into the graph)."""
    return device_counters(_ITERATION_COUNTS, device)


class IterationCounts(NamedTuple):
    """The tree-NR solve's counters, summed over devices."""
    iterations: int
    budget_hits: int  # lanes that ended at the NR budget unconverged


def read_iteration_counts() -> IterationCounts:
    """The counters of every lane-solve in this process, on every device (a
    host read of each device's counters)."""
    return IterationCounts(*sum_counters(_ITERATION_COUNTS))


def _count_plain(n_iter, diff, x_tol, max_iter):
    """The kernel's epilogue count, in PyTorch, for a plain solve."""
    global LANE_SOLVES
    counts = iteration_counts(n_iter.device)
    counts[0] += n_iter.sum()
    counts[1] += ((n_iter == max_iter) & ~(diff <= x_tol)).sum()
    LANE_SOLVES += n_iter.shape[0]


def tree_nr_flops_per_lane(S: int, n_iter: int, warm: bool = False) -> int:
    """FLOPs one lane of the tree-NR solve needs for ``n_iter`` NR steps,
    counted from ``csrc/tree_core.cuh`` (transcendentals and divides count 1,
    compares and selects 0; each slot has at most one parent, so the
    children's terms a parent gathers count once per slot).  Per slot: one
    mismatch evaluation 39, one NR step 173 (Jacobian blocks 108,
    elimination and Schur push 49, back substitution 14, update 2).  A warm
    start evaluates the warm point too; the kernel's evaluation again of a
    point already evaluated (a lane that keeps the flat start, a frozen lane
    beside active ones in a warp) is not work the solve needs and is not
    counted.  The JAX package's ``tree_pallas_flops_per_lane`` over-counts
    the kernel (it still charges a removed U rebuild), so it is not
    reused."""
    return S * (39 * (2 if warm else 1) + n_iter * (173 + 39))


@dataclasses.dataclass(frozen=True, eq=False)
class TreeSchedule:
    """Host-side (NumPy) slot schedule for one radial network."""

    n_bus: int
    S: int  # padded slot count
    levels: tuple  # ((off, W, k), ...) leaves first; W = padded width
    runs: tuple  # per level: ((src, k, dst), ...): parent(src+i) = dst+i
    slot_busm1: np.ndarray  # [S] bus-1 of the node at each slot; -1 = pad
    busm1_slot: np.ndarray  # [m] slot of bus b+1 (inverse of the above)
    ycols: np.ndarray  # [S, 8] static table (see _YC_*)
    maxC: int  # max children per node


def build_tree_schedule(br_f, br_t, n_bus, Y_re, Y_im, align: int = 1, dtype=np.float32):
    """Derive the slot schedule, or ``None`` for non-radial networks.

    A copy of ``gym_anm_tpu.ops.pallas_tree.build_tree_schedule`` (equal to
    it on every field for the same ``align``), with two differences: the
    default ``align`` is 1 (exact levels, no pad slots), and ``dtype`` sets
    the type of ``ycols`` (float64 for the plain version's float64 solves).
    ``align`` pads each level to a multiple of this many rows; pad slots
    carry zero admittances and an identity diagonal block.
    """
    tree = build_tree_info(br_f, br_t, n_bus, Y_re, Y_im)
    if tree is None:
        return None
    m = tree.bus.shape[0]
    L = len(tree.levels)
    lvl_eo = [list(range(lo, hi)) for lo, hi in tree.levels]

    # Top-down within-level ordering: nodes sort by their parent's final
    # position, so chain links become constant-offset runs; slack-parent
    # nodes go last (they take no push and would otherwise break runs).
    order = [None] * L
    pos = {}  # eo -> (level, idx in final order)
    for l in range(L - 1, -1, -1):
        if l == L - 1:
            order[l] = list(lvl_eo[l])
        else:

            def key(e):
                pe = int(tree.par_eo[e])
                if pe == m:  # slack parent
                    return (L, 0, e)
                return pos[pe] + (e,)

            order[l] = sorted(lvl_eo[l], key=key)
        for i, e in enumerate(order[l]):
            pos[e] = (l, i)

    # Slot layout.
    pad = lambda k: -(-k // align) * align
    offs, widths = [], []
    off = 0
    for l in range(L):
        k = len(order[l])
        offs.append(off)
        widths.append(pad(k))
        off += widths[-1]
    S = off
    slot_of_eo = {}
    slot_busm1 = np.full(S, -1, dtype=np.int64)
    for l in range(L):
        for i, e in enumerate(order[l]):
            slot_of_eo[e] = offs[l] + i
            slot_busm1[offs[l] + i] = int(tree.bus[e]) - 1
    busm1_slot = np.empty(m, dtype=np.int64)
    for s in range(S):
        if slot_busm1[s] >= 0:
            busm1_slot[slot_busm1[s]] = s

    # Run decomposition of the parent map, per (child) level.
    runs = []
    for l in range(L):
        lruns = []
        cur = None  # [src, k, dst]
        for i, e in enumerate(order[l]):
            pe = int(tree.par_eo[e])
            if pe == m:
                cur = None
                continue
            src, dst = offs[l] + i, slot_of_eo[pe]
            if cur is not None and src == cur[0] + cur[1] and dst == cur[2] + cur[1]:
                cur[1] += 1
            else:
                cur = [src, 1, dst]
                lruns.append(cur)
        runs.append(tuple((a, b, c) for a, b, c in lruns))

    # Static per-slot table.
    Y_re = np.asarray(Y_re, np.float64)
    Y_im = np.asarray(Y_im, np.float64)
    yc = np.zeros((S, 8), dtype=dtype)
    for l in range(L):
        for i, e in enumerate(order[l]):
            s = offs[l] + i
            b = int(tree.bus[e])
            pb = int(tree.par_bus[e])
            yc[s, _YC_DIAG_RE] = Y_re[b, b]
            yc[s, _YC_DIAG_IM] = Y_im[b, b]
            yc[s, _YC_UP_RE] = Y_re[b, pb]
            yc[s, _YC_UP_IM] = Y_im[b, pb]
            yc[s, _YC_DOWN_RE] = Y_re[pb, b]
            yc[s, _YC_DOWN_IM] = Y_im[pb, b]
            yc[s, _YC_HASPAR] = 1.0 if tree.has_par[e] else 0.0
    yc[slot_busm1 < 0, _YC_PAD] = 1.0

    return TreeSchedule(
        n_bus=n_bus,
        S=S,
        levels=tuple(zip(offs, widths, (len(o) for o in order))),
        runs=tuple(runs),
        slot_busm1=slot_busm1,
        busm1_slot=busm1_slot,
        ycols=yc,
        maxC=tree.ch_eo.shape[1],
    )


def gather_tables(sched: TreeSchedule):
    """Each slot's parent and children, from the runs: ``par [S]`` (-1 under
    the slack) and ``children [maxC, S]`` (-1 padded), both int32.  A slot's
    children are listed in the order of the runs, which is the order in
    which the plain version pushes their terms to it."""
    par = np.full(sched.S, -1, dtype=np.int32)
    kids = [[] for _ in range(sched.S)]
    for lruns in sched.runs:
        for src, k, dst in lruns:
            for i in range(k):
                par[src + i] = dst + i
                kids[dst + i].append(src + i)
    children = np.full((sched.maxC, sched.S), -1, dtype=np.int32)
    for s, ks in enumerate(kids):
        children[: len(ks), s] = ks
    return par, children


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceSchedule:
    """A :class:`TreeSchedule` with its tables on one device.

    ``levels [L, 2]`` holds ``(off, W)``; ``par`` and ``children`` are
    :func:`gather_tables`.  The kernel stages these once per block and reads
    them in runtime loops, so one binary serves every grid.
    """

    sched: TreeSchedule
    ycols: torch.Tensor  # [S, 8] in the working float type
    levels: torch.Tensor  # [L, 2] int32
    par: torch.Tensor  # [S] int32
    children: torch.Tensor  # [maxC, S] int32
    slot_sel: torch.Tensor  # [S] int64: bus-1 at each slot, m for pads
    busm1_slot: torch.Tensor  # [m] int64

    @classmethod
    def from_spec(cls, spec, device, dtype: torch.dtype):
        """The schedule of a radial grid, or ``None`` if it is meshed."""
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        sched = build_tree_schedule(spec.br_f, spec.br_t, spec.n_bus, spec.Y_re, spec.Y_im, dtype=np_dtype)
        if sched is None:
            return None
        device = torch.device(device)
        iteration_counts(device)
        m = spec.n_bus - 1
        par, children = gather_tables(sched)
        levels = np.asarray([(off, W) for off, W, _ in sched.levels], dtype=np.int32)
        return cls(
            sched=sched,
            ycols=torch.as_tensor(sched.ycols, device=device).to(dtype),
            levels=torch.as_tensor(levels, device=device),
            par=torch.as_tensor(par, device=device),
            children=torch.as_tensor(children, device=device),
            slot_sel=torch.as_tensor(np.where(sched.slot_busm1 >= 0, sched.slot_busm1, m), device=device),
            busm1_slot=torch.as_tensor(sched.busm1_slot, device=device),
        )


def _blocks(a, b, wre, wim, ure, uim, t1r=None, t1i=None):
    """2x2 polar Jacobian block entries (solve_load_flow.py:123-164) for
    row-bus voltage (a, b), current term w and Y vn term u; ``t1`` adds the
    diagonal-only vn conj(I) piece."""
    dSa_re = a * wim - b * wre
    dSa_im = a * wre + b * wim
    dSm_re = a * ure + b * uim
    dSm_im = b * ure - a * uim
    if t1r is not None:
        dSm_re = dSm_re + t1r
        dSm_im = dSm_im + t1i
    return dSa_re, dSm_re, dSa_im, dSm_im


def tree_newton_plain(ds: DeviceSchedule, p, q, x_tol=1e-5, max_iter=10, init=None):
    """Plain PyTorch tree-NR solve on the slot layout, batch-last: the plain
    twin of ``csrc/tree_core.cuh::newton``, which the tree-NR kernel and the
    fused transition's tree form share.

    ``p, q``: ``[S, B]`` non-slack injections in slot order, float32 or
    float64 on any device.  ``init`` optionally gives a warm point
    ``(theta [S, B], vm [S, B])`` in slot order (:func:`warm_point`); each
    lane starts from it where its mismatch is finite and smaller than the
    flat start's.  Returns ``(v_re, v_im, i_re, i_im [S, B], diff [B],
    n_iter [B] int32)`` in slot order: the voltages and currents I = YV of
    the last evaluated point.  Counts nothing.
    """
    sched = ds.sched
    S, B = p.shape
    dt, dev = p.dtype, p.device
    yc = ds.ycols.to(dt)
    col = lambda c: yc[:, c : c + 1]  # [S, 1]
    ydr, ydi = col(_YC_DIAG_RE), col(_YC_DIAG_IM)
    yur, yui = col(_YC_UP_RE), col(_YC_UP_IM)
    ywr, ywi = col(_YC_DOWN_RE), col(_YC_DOWN_IM)
    hp, padm = col(_YC_HASPAR), col(_YC_PAD)
    realm = 1.0 - padm
    all_runs = [r for lruns in sched.runs for r in lruns]

    def eval_point(theta, vm):
        """(vr, vi, vpr, vpi, ir, ii, Fp, Fq, diff) at (theta, vm)."""
        vr = vm * torch.cos(theta)
        vi = vm * torch.sin(theta)
        # Parent voltages: the slack's 1+0j, overwritten through the runs.
        vpr = torch.ones((S, B), dtype=dt, device=dev)
        vpi = torch.zeros((S, B), dtype=dt, device=dev)
        for src, k, dst in all_runs:
            vpr[src : src + k] = vr[dst : dst + k]
            vpi[src : src + k] = vi[dst : dst + k]
        # Child contributions to I = YV, pushed parent-ward through the runs.
        cwr, cwi = _cmul(ywr, ywi, vr, vi)
        air = torch.zeros((S, B), dtype=dt, device=dev)
        aii = torch.zeros((S, B), dtype=dt, device=dev)
        for src, k, dst in all_runs:
            air[dst : dst + k] += cwr[src : src + k]
            aii[dst : dst + k] += cwi[src : src + k]
        dr, di = _cmul(ydr, ydi, vr, vi)
        ur, ui = _cmul(yur, yui, vpr, vpi)
        ir = dr + ur + air
        ii = di + ui + aii
        Fp = realm * (vr * ir + vi * ii - p)
        Fq = realm * (vi * ir - vr * ii - q)
        diff = torch.maximum(Fp.abs().amax(dim=0), Fq.abs().amax(dim=0))  # NaN propagates
        return vr, vi, vpr, vpi, ir, ii, Fp, Fq, diff

    def newton_step(vr, vi, vpr, vpi, ir, ii, Fp, Fq):
        """The NR step (x0, x1) = J^-1 F by leaf-to-root block elimination."""
        vmag = torch.sqrt(vr * vr + vi * vi)
        vnr, vni = vr / vmag, vi / vmag
        pmag = torch.sqrt(vpr * vpr + vpi * vpi)  # slack parents: 1
        pnr, pni = vpr / pmag, vpi / pmag

        # Diagonal: w = I - Y_ii v ; u = Y_ii vn ; t1 = vn conj(I).
        yvr, yvi = _cmul(ydr, ydi, vr, vi)
        ure, uim = _cmul(ydr, ydi, vnr, vni)
        t1r = vnr * ir + vni * ii
        t1i = vni * ir - vnr * ii
        D00, D01, D10, D11 = _blocks(vr, vi, ir - yvr, ii - yvi, ure, uim, t1r, t1i)
        D00 = D00 + padm  # pad slots: identity diagonal block
        D11 = D11 + padm
        # L = J[par, node]: row voltage v_par, w = -Y_down v, u = Y_down vn.
        wre, wim = _cmul(ywr, ywi, vr, vi)
        ure, uim = _cmul(ywr, ywi, vnr, vni)
        L = [hp * x for x in _blocks(vpr, vpi, -wre, -wim, ure, uim)]
        # U = J[node, par]: row voltage v, w = -Y_up v_par, u = Y_up vn_par.
        wre, wim = _cmul(yur, yui, vpr, vpi)
        ure, uim = _cmul(yur, yui, pnr, pni)
        U = [hp * x for x in _blocks(vr, vi, -wre, -wim, ure, uim)]

        # Schur accumulators; overwritten with D^-1 and the effective rhs
        # once a level is eliminated.
        a00, a01, a10, a11, ab0, ab1 = (torch.zeros((S, B), dtype=dt, device=dev) for _ in range(6))
        for (off, W, _), lruns in zip(sched.levels, sched.runs):
            sl = slice(off, off + W)
            d00 = D00[sl] - a00[sl]
            d01 = D01[sl] - a01[sl]
            d10 = D10[sl] - a10[sl]
            d11 = D11[sl] - a11[sl]
            b0 = Fp[sl] - ab0[sl]
            b1 = Fq[sl] - ab1[sl]
            det = d00 * d11 - d01 * d10
            i00, i01, i10, i11 = d11 / det, -d01 / det, -d10 / det, d00 / det
            a00[sl], a01[sl], a10[sl], a11[sl] = i00, i01, i10, i11
            ab0[sl], ab1[sl] = b0, b1

            l00, l01, l10, l11 = (x[sl] for x in L)
            M00 = l00 * i00 + l01 * i10
            M01 = l00 * i01 + l01 * i11
            M10 = l10 * i00 + l11 * i10
            M11 = l10 * i01 + l11 * i11
            u00, u01, u10, u11 = (x[sl] for x in U)
            pushes = (
                (a00, M00 * u00 + M01 * u10),
                (a01, M00 * u01 + M01 * u11),
                (a10, M10 * u00 + M11 * u10),
                (a11, M10 * u01 + M11 * u11),
                (ab0, M00 * b0 + M01 * b1),
                (ab1, M10 * b0 + M11 * b1),
            )
            for src, kk, dst in lruns:
                s0 = src - off
                for acc, val in pushes:
                    acc[dst : dst + kk] += val[s0 : s0 + kk]

        # Back-substitution, root level first (slack parents read 0).
        x0 = torch.zeros((S, B), dtype=dt, device=dev)
        x1 = torch.zeros((S, B), dtype=dt, device=dev)
        for (off, W, _), lruns in zip(reversed(sched.levels), reversed(sched.runs)):
            sl = slice(off, off + W)
            xp0 = torch.zeros((W, B), dtype=dt, device=dev)
            xp1 = torch.zeros((W, B), dtype=dt, device=dev)
            for src, kk, dst in lruns:
                xp0[src - off : src - off + kk] = x0[dst : dst + kk]
                xp1[src - off : src - off + kk] = x1[dst : dst + kk]
            r0 = ab0[sl] - (U[0][sl] * xp0 + U[1][sl] * xp1)
            r1 = ab1[sl] - (U[2][sl] * xp0 + U[3][sl] * xp1)
            x0[sl] = a00[sl] * r0 + a01[sl] * r1
            x1[sl] = a10[sl] * r0 + a11[sl] * r1
        return x0, x1

    theta = torch.zeros((S, B), dtype=dt, device=dev)
    vm = torch.ones((S, B), dtype=dt, device=dev)
    ev = eval_point(theta, vm)
    if init is not None:
        th_w, vm_w = init
        ev_w = eval_point(th_w, vm_w)
        use_w = torch.isfinite(ev_w[-1]) & (ev_w[-1] < ev[-1])
        theta = torch.where(use_w, th_w, theta)
        vm = torch.where(use_w, vm_w, vm)
        ev = tuple(torch.where(use_w, a, b) for a, b in zip(ev_w, ev))
    n_iter = torch.zeros((B,), dtype=torch.int32, device=dev)
    for _ in range(max_iter):
        active = ev[-1] > x_tol  # NaN freezes the lane
        if not bool(active.any()):
            break
        x0, x1 = newton_step(*ev[:-1])
        theta = torch.where(active, theta - x0, theta)
        vm = torch.where(active, vm - x1, vm)
        n_iter = n_iter + active.to(torch.int32)
        new = eval_point(theta, vm)
        # Frozen lanes keep their carried values (their point did not move).
        ev = tuple(torch.where(active, a, b) for a, b in zip(new, ev))
    return ev[0], ev[1], ev[4], ev[5], ev[-1], n_iter


def solve_pfe_tree_plain(ds: DeviceSchedule, p, q, x_tol=1e-5, max_iter=10, init=None):
    """The tree-NR kernel's plain twin: :func:`tree_newton_plain`, returning
    ``(v_re [S, B], v_im [S, B], diff [B], n_iter [B] int32)`` in slot order
    and adding the solve to the process's counters as the kernel does."""
    v_re, v_im, _, _, diff, n_iter = tree_newton_plain(ds, p, q, x_tol=x_tol, max_iter=max_iter, init=init)
    _count_plain(n_iter, diff, x_tol, max_iter)
    return v_re, v_im, diff, n_iter


def _check_kernel_args(ds: DeviceSchedule, p, q, init):
    for name, t in (("p", p), ("q", q)) + (() if init is None else (("theta_w", init[0]), ("vm_w", init[1]))):
        if not t.is_cuda:
            raise ValueError("%s must be a CUDA tensor for the tree-NR kernel" % name)
        if t.dtype != torch.float32:
            raise TypeError("the tree-NR kernel takes float32 only; %s is %s" % (name, t.dtype))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
        if t.dim() != 2 or t.shape[0] != ds.sched.S:
            raise ValueError("%s must be [S=%d, B]; got %s" % (name, ds.sched.S, tuple(t.shape)))
    if any(t.shape != p.shape or t.device != p.device for t in (q,) + (() if init is None else tuple(init))):
        raise ValueError("p, q and the warm point must have one shape and one device")
    if ds.ycols.device != p.device or ds.ycols.dtype != torch.float32:
        raise ValueError("the schedule must be float32 on the inputs' device")
    if p.shape[1] == 0:
        raise ValueError("empty batch")


def tree_nr_geometry(ds: DeviceSchedule) -> dict:
    """The kernel's launch geometry for this schedule on the current CUDA
    device: threads a lane, lanes a block, threads a block, dynamic shared
    bytes a block and resident blocks an SM."""
    from ._build import load_library, read_geometry

    lib = load_library()
    return read_geometry(lib.tree_nr_geometry, ds.sched.S, ds.sched.maxC, ds.levels.shape[0])


def solve_pfe_tree_cuda(ds: DeviceSchedule, p, q, x_tol=1e-5, max_iter=10, init=None):
    """Launch the CUDA tree-NR kernel (``csrc/tree_nr.cu``).

    Same contract as :func:`solve_pfe_tree_plain`, for contiguous float32
    CUDA tensors; raises on anything else and when the launch fails.  The
    launch adds the lanes' iterations and budget hits to the device's
    :func:`iteration_counts` itself.
    """
    global KERNEL_LAUNCHES, LANE_SOLVES
    from ._build import load_library

    _check_kernel_args(ds, p, q, init)
    lib = load_library()
    S, B = p.shape
    v_re = torch.empty_like(p)
    v_im = torch.empty_like(p)
    diff = torch.empty((B,), dtype=torch.float32, device=p.device)
    n_iter = torch.empty((B,), dtype=torch.int32, device=p.device)
    th_w, vm_w = (None, None) if init is None else (init[0].data_ptr(), init[1].data_ptr())
    stream = torch.cuda.current_stream(p.device).cuda_stream
    rc = lib.tree_nr_solve_f32(
        p.data_ptr(), q.data_ptr(), th_w, vm_w, ds.ycols.data_ptr(),
        ds.par.data_ptr(), ds.children.data_ptr(), ds.levels.data_ptr(),
        S, ds.sched.maxC, ds.levels.shape[0], B, ctypes.c_float(x_tol), int(max_iter),
        v_re.data_ptr(), v_im.data_ptr(), diff.data_ptr(), n_iter.data_ptr(),
        iteration_counts(p.device).data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError("tree-NR kernel launch failed: CUDA error %d" % rc)
    KERNEL_LAUNCHES += 1
    LANE_SOLVES += B
    return v_re, v_im, diff, n_iter


def warm_point(ds: DeviceSchedule, v_re, v_im):
    """The warm point ``(theta [S, B], vm [S, B])`` in slot order from bus
    voltages ``v_re, v_im [B, n]`` (:func:`warm_init_theta_vm`: lanes with a
    non-finite or out-of-window voltage get the flat start; pad slots too)."""
    B, n = v_re.shape
    th_b, vm_b, _ = warm_init_theta_vm(v_re, v_im, n - 1, v_re.dtype)  # [m, B] bus order
    th = torch.cat([th_b, torch.zeros((1, B), dtype=th_b.dtype, device=th_b.device)])[ds.slot_sel]
    vm = torch.cat([vm_b, torch.ones((1, B), dtype=vm_b.dtype, device=vm_b.device)])[ds.slot_sel]
    return th.contiguous(), vm.contiguous()


def solve_pfe_tree(ds: DeviceSchedule, p, q, x_tol=1e-5, max_iter=10, init=None, plain=False):
    """Batched tree-NR solve.

    ``p, q``: ``[B, m]`` non-slack bus injections in bus order (1..n-1).
    ``init`` optionally warm-starts from previous bus voltages ``(v_re
    [B, n], v_im [B, n])`` with the per-lane best-of-{warm, flat} guard.
    A CUDA tensor launches the kernel (float32 only); a CPU tensor runs the
    plain version, and so does any tensor with ``plain=True`` (the
    ``"tree_xla"`` ablation).  Returns ``(v_re [B, n], v_im [B, n], diff [B],
    n_iter [B], converged [B])`` batch-first, like the JAX solvers.
    """
    B = p.shape[0]
    dt, dev = p.dtype, p.device
    # Bus order -> slot order (pads read a zero row), batch-last.
    zero = torch.zeros((1, B), dtype=dt, device=dev)
    pT = torch.cat([p.T, zero], dim=0)[ds.slot_sel].contiguous()
    qT = torch.cat([q.T, zero], dim=0)[ds.slot_sel].contiguous()
    warm = None if init is None else warm_point(ds, init[0].to(dt), init[1].to(dt))
    solver = solve_pfe_tree_cuda if p.is_cuda and not plain else solve_pfe_tree_plain
    vr_s, vi_s, diff, n_iter = solver(ds, pT, qT, x_tol=x_tol, max_iter=max_iter, init=warm)
    # Slot order -> bus order with the pinned slack row.
    vr = torch.cat([torch.ones((1, B), dtype=dt, device=dev), vr_s[ds.busm1_slot]], dim=0)
    vi = torch.cat([zero, vi_s[ds.busm1_slot]], dim=0)
    return vr.T, vi.T, diff, n_iter, diff <= x_tol
