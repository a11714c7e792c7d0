"""Tree-structured Newton-Raphson power flow: the CUDA kernel and its plain
PyTorch version.

The counterpart of ``gym_anm_tpu.ops.pallas_tree``.  Per env lane it
computes the exact polar NR power flow of a radial grid, the same thing as
the TPU kernel ``_tree_tile_kernel``:

* flat start (theta = 0, |V| = 1; the slack is pinned at 1 + 0j);
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
``parent_slot(src + i) = dst + i``.

:func:`solve_pfe_tree` dispatches on the tensor's device: a CUDA float32
tensor launches the kernel (``csrc/tree_nr.cu``); a CPU tensor runs
:func:`solve_pfe_tree_plain`.  A CUDA float64 tensor raises: there is no
fallback from the GPU to the plain version or to the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .tree_nr import build_tree_info

# Column layout of the per-slot static table ``ycols [S, 8]``.
_YC_DIAG_RE, _YC_DIAG_IM = 0, 1  # Y[bus, bus]
_YC_UP_RE, _YC_UP_IM = 2, 3  # Y[bus, parent]
_YC_DOWN_RE, _YC_DOWN_IM = 4, 5  # Y[parent, bus]
_YC_HASPAR, _YC_PAD = 6, 7  # non-slack-parent mask; pad-slot mask

# Launches of the CUDA kernel in this process (one per successful launch).
KERNEL_LAUNCHES = 0


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


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceSchedule:
    """A :class:`TreeSchedule` with its tables on one device.

    ``levels [L, 2]`` holds ``(off, W)``; the runs of level ``l`` are rows
    ``run_ptr[l]:run_ptr[l + 1]`` of ``runs [R, 3]`` (``src, k, dst``).  The
    kernel reads these in runtime loops, so one binary serves every grid.
    """

    sched: TreeSchedule
    ycols: torch.Tensor  # [S, 8] in the working float type
    levels: torch.Tensor  # [L, 2] int32
    run_ptr: torch.Tensor  # [L + 1] int32
    runs: torch.Tensor  # [R, 3] int32
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
        m = spec.n_bus - 1
        flat = [r for lruns in sched.runs for r in lruns]
        run_ptr = np.cumsum([0] + [len(lruns) for lruns in sched.runs])
        i32 = lambda a, w: torch.as_tensor(np.asarray(a, dtype=np.int32).reshape(-1, w), device=device)
        return cls(
            sched=sched,
            ycols=torch.as_tensor(sched.ycols, device=device).to(dtype),
            levels=i32([(off, W) for off, W, _ in sched.levels], 2),
            run_ptr=i32(run_ptr, 1).reshape(-1),
            runs=i32(flat, 3),
            slot_sel=torch.as_tensor(np.where(sched.slot_busm1 >= 0, sched.slot_busm1, m), device=device),
            busm1_slot=torch.as_tensor(sched.busm1_slot, device=device),
        )


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


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


def solve_pfe_tree_plain(ds: DeviceSchedule, p, q, x_tol=1e-5, max_iter=10):
    """Plain PyTorch tree-NR solve on the slot layout, batch-last.

    ``p, q``: ``[S, B]`` non-slack injections in slot order, float32 or
    float64 on any device.  Returns ``(v_re [S, B], v_im [S, B], diff [B],
    n_iter [B] int32)`` in slot order.
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
    return ev[0], ev[1], ev[-1], n_iter


def _check_kernel_args(ds: DeviceSchedule, p, q):
    for name, t in (("p", p), ("q", q)):
        if not t.is_cuda:
            raise ValueError("%s must be a CUDA tensor for the tree-NR kernel" % name)
        if t.dtype != torch.float32:
            raise TypeError("the tree-NR kernel takes float32 only; %s is %s" % (name, t.dtype))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
        if t.dim() != 2 or t.shape[0] != ds.sched.S:
            raise ValueError("%s must be [S=%d, B]; got %s" % (name, ds.sched.S, tuple(t.shape)))
    if p.shape != q.shape or p.device != q.device:
        raise ValueError("p and q must have one shape and one device")
    if ds.ycols.device != p.device or ds.ycols.dtype != torch.float32:
        raise ValueError("the schedule must be float32 on the inputs' device")
    if p.shape[1] == 0:
        raise ValueError("empty batch")


def solve_pfe_tree_cuda(ds: DeviceSchedule, p, q, x_tol=1e-5, max_iter=10):
    """Launch the CUDA tree-NR kernel (``csrc/tree_nr.cu``).

    Same contract as :func:`solve_pfe_tree_plain`, for contiguous float32
    CUDA tensors; raises on anything else and when the launch fails.
    """
    global KERNEL_LAUNCHES
    from ._build import load_library

    _check_kernel_args(ds, p, q)
    lib = load_library()
    S, B = p.shape
    scratch = torch.empty((lib.tree_nr_scratch_planes(), S, B), dtype=torch.float32, device=p.device)
    v_re = torch.empty_like(p)
    v_im = torch.empty_like(p)
    diff = torch.empty((B,), dtype=torch.float32, device=p.device)
    n_iter = torch.empty((B,), dtype=torch.int32, device=p.device)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    rc = lib.tree_nr_solve_f32(
        p.data_ptr(), q.data_ptr(), ds.ycols.data_ptr(),
        ds.levels.data_ptr(), ds.run_ptr.data_ptr(), ds.runs.data_ptr(),
        S, ds.levels.shape[0], B, ctypes.c_float(x_tol), int(max_iter),
        scratch.data_ptr(), v_re.data_ptr(), v_im.data_ptr(), diff.data_ptr(), n_iter.data_ptr(),
        stream,
    )
    if rc != 0:
        raise RuntimeError("tree-NR kernel launch failed: CUDA error %d" % rc)
    KERNEL_LAUNCHES += 1
    return v_re, v_im, diff, n_iter


def solve_pfe_tree(ds: DeviceSchedule, p, q, x_tol=1e-5, max_iter=10):
    """Batched tree-NR solve.

    ``p, q``: ``[B, m]`` non-slack bus injections in bus order (1..n-1).
    A CUDA tensor launches the kernel (float32 only); a CPU tensor runs the
    plain version.  Returns ``(v_re [B, n], v_im [B, n], diff [B],
    n_iter [B], converged [B])`` batch-first, like the JAX solvers.
    """
    B = p.shape[0]
    dt, dev = p.dtype, p.device
    # Bus order -> slot order (pads read a zero row), batch-last.
    zero = torch.zeros((1, B), dtype=dt, device=dev)
    pT = torch.cat([p.T, zero], dim=0)[ds.slot_sel].contiguous()
    qT = torch.cat([q.T, zero], dim=0)[ds.slot_sel].contiguous()
    solver = solve_pfe_tree_cuda if p.is_cuda else solve_pfe_tree_plain
    vr_s, vi_s, diff, n_iter = solver(ds, pT, qT, x_tol=x_tol, max_iter=max_iter)
    # Slot order -> bus order with the pinned slack row.
    vr = torch.cat([torch.ones((1, B), dtype=dt, device=dev), vr_s[ds.busm1_slot]], dim=0)
    vi = torch.cat([zero, vi_s[ds.busm1_slot]], dim=0)
    return vr.T, vi.T, diff, n_iter, diff <= x_tol
