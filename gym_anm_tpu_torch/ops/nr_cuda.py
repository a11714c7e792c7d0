"""Dense batched Newton-Raphson power flow: the CUDA kernel and its plain
PyTorch twin.

The counterpart of ``gym_anm_tpu.ops.pallas_nr``.  Per env lane it computes
the same thing as the TPU kernel ``_nr_tile_kernel`` and its body
``nr_core``:

* flat start (theta = 0, |V| = 1; the slack pinned at 1 + 0j) or, given a
  warm point (the TPU kernel's ``warm=True`` form), whichever of {warm,
  flat} has the smaller mismatch: the warm point only where its mismatch is
  finite and strictly smaller;
* an optional chord prefix of ``chord_iters`` steps x <- x - J0inv F(x) with
  the host-computed flat-start Jacobian inverse; lanes the prefix made worse
  (or NaN) restart from the flat start, keeping their iteration count;
* ``max_iter`` true-NR steps: I = YV as an exact sequential sum, the full
  ``[2m, 2m]`` polar Jacobian, Gaussian elimination of ``[J | F]``
  (pivot-free, or partial pivoting on the first row of largest magnitude
  with ``pivot=True``), back substitution and the step;
* a lane whose mismatch is not above ``x_tol`` (NaN included) is frozen.

:func:`nr_core_plain` is the plain twin, in the kernel's order of
operations (``csrc/nr_core.cuh``), batch-last on ``[*, B]`` tensors of any
float dtype and device.  :func:`solve_pfe_nr` dispatches on the tensor's
device: a CUDA float32 tensor launches the kernel (``csrc/nr_dense.cu``); a
CPU tensor runs the plain twin; a CUDA float64 tensor raises.  There is no
fallback from the GPU.  The plain twin with pivoting is also the port's
plain dense solver (``ops/power_flow.py::solve_pfe``).
"""

from __future__ import annotations

import ctypes

import torch

from .precision import full_precision

# Launches of the CUDA kernel in this process (one per successful launch).
KERNEL_LAUNCHES = 0
# The kernel solves systems of 2(n-1) <= NN_MAX unknowns.
NN_MAX = 64


def nr_dense_flops_per_lane(n: int, nr_iters: int, chord_iters: int = 0, warm: bool = False) -> int:
    """FLOPs one lane of the dense-NR solve needs for ``chord_iters`` chord
    steps and ``nr_iters`` NR steps, counted from ``csrc/nr_core.cuh``;
    ``warm`` adds the warm point's evaluation.

    Adds, multiplies, divides, square roots and sines/cosines count 1;
    compares, selects, absolute values and row swaps 0 (so pivoting adds
    none).  With m = n - 1 and nn = 2m: one evaluation (V, I = YV, F)
    ``8 n^2 + 12 m``; one NR step the Jacobian ``28 m^2 + 6 m + 6 n``, the
    triangular elimination ``sum_{j<nn} j (2 j + 3)``, the back
    substitution ``nn^2 + nn``, the update ``2 m`` and an evaluation; one
    chord step ``2 nn^2 + 2 m`` and an evaluation.  The flat-start
    evaluation the kernel repeats on a lane restarted after the chord
    prefix, or warm-started where the flat start won, is not counted, so on
    such lanes this is a slight undercount.
    """
    m = n - 1
    nn = 2 * m
    evaluate = 8 * n * n + 12 * m
    eliminate = sum(j * (2 * j + 3) for j in range(nn))
    nr_step = (28 * m * m + 6 * m + 6 * n) + eliminate + (nn * nn + nn) + 2 * m + evaluate
    chord_step = 2 * nn * nn + 2 * m + evaluate
    return (2 if warm else 1) * evaluate + chord_iters * chord_step + nr_iters * nr_step


def nr_flops_per_lane(n: int, max_iter: int, chord_iters: int = 0, pivot: bool = True) -> int:
    """Analytic FLOP count of one lane's solve on the TPU, a copy of
    ``gym_anm_tpu.ops.pallas_nr.nr_flops_per_lane``.

    It counts the TPU kernel's masked full-matrix elimination, ``(4 if
    pivot else 2) nn^2 (nn + 1)`` per step, about 3x (pivot-free) what the
    CUDA kernel's triangular elimination does; bounds on the card use
    :func:`nr_dense_flops_per_lane` instead.
    """
    m = n - 1
    nn = 2 * m
    ge = (4 if pivot else 2) * nn * nn * (nn + 1)
    nr_iter = 42 * n * n + ge + nn * nn + 30 * n
    chord_iter = 2 * nn * nn + 8 * n * n + 20 * n
    setup = 8 * n * n + 10 * n
    return setup + chord_iters * chord_iter + max_iter * nr_iter


def _construct_v(theta, vm):
    """V = [1+0j, vm exp(j theta)] as (re, im), ``[m, B]`` -> ``[n, B]``."""
    one = torch.ones((1,) + tuple(theta.shape[1:]), dtype=vm.dtype, device=vm.device)
    return torch.cat([one, vm * torch.cos(theta)]), torch.cat([torch.zeros_like(one), vm * torch.sin(theta)])


def _yv(Yre, Yim, vr, vi):
    """I = YV as the sequential sum over k of ``Y[:, k] v[k]``, the
    kernel's order."""
    ir = torch.zeros_like(vr)
    ii = torch.zeros_like(vi)
    for k in range(Yre.shape[0]):
        yr, yi = Yre[:, k : k + 1], Yim[:, k : k + 1]
        ir = ir + (yr * vr[k] - yi * vi[k])
        ii = ii + (yr * vi[k] + yi * vr[k])
    return ir, ii


def _evaluate(Yre, Yim, theta, vm, p, q):
    """(vr, vi, ir, ii, F, diff) at (theta, vm); diff is NaN where F is."""
    vr, vi = _construct_v(theta, vm)
    ir, ii = _yv(Yre, Yim, vr, vi)
    s_re = vr * ir + vi * ii
    s_im = vi * ir - vr * ii
    F = torch.cat([s_re[1:] - p, s_im[1:] - q])
    return vr, vi, ir, ii, F, F.abs().amax(dim=0)


def _system(Yre, Yim, vr, vi, ir, ii, F):
    """The augmented system ``[J | F]`` ``[nn, nn + 1, B]`` at (V, I)."""
    n = Yre.shape[0]
    vmag = torch.sqrt(vr * vr + vi * vi)
    vnr, vni = vr / vmag, vi / vmag
    yr, yi = Yre[1:, 1:, None], Yim[1:, 1:, None]
    diag = torch.eye(n - 1, dtype=torch.bool, device=vr.device)[:, :, None]
    zero = torch.zeros((), dtype=vr.dtype, device=vr.device)
    a, b = vr[1:, None, :], vi[1:, None, :]  # row bus i
    ck = lambda x: x[None, 1:, :]  # column bus k
    yv_re = yr * ck(vr) - yi * ck(vi)
    yv_im = yr * ck(vi) + yi * ck(vr)
    w_re = torch.where(diag, ir[1:, None, :], zero) - yv_re
    w_im = torch.where(diag, ii[1:, None, :], zero) - yv_im
    u_re = yr * ck(vnr) - yi * ck(vni)
    u_im = yr * ck(vni) + yi * ck(vnr)
    t1_re = (vnr * ir + vni * ii)[1:, None, :]
    t1_im = (vni * ir - vnr * ii)[1:, None, :]
    top = torch.cat([a * w_im - b * w_re, torch.where(diag, t1_re, zero) + (a * u_re + b * u_im)], dim=1)
    bot = torch.cat([a * w_re + b * w_im, torch.where(diag, t1_im, zero) + (b * u_re - a * u_im)], dim=1)
    return torch.cat([torch.cat([top, bot], dim=0), F[:, None, :]], dim=1)


def _solve_system(Ab, pivot):
    """Eliminate ``[J | F]`` in place and back-substitute; returns dx
    ``[nn, B]``.  Each row's sum ``sum_{j>r} A_rj x_j`` accumulates as the
    ``x_j`` become known (j descending), as the kernel does."""
    nn, _, B = Ab.shape
    lanes = torch.arange(B, device=Ab.device)
    for k in range(nn):
        if pivot:
            piv = k + torch.argmax(Ab[k:, k, :].abs(), dim=0)  # first maximal row
            row_k = Ab[k].clone()
            row_p = Ab[piv, :, lanes].T  # [nn + 1, B]
            Ab[piv, :, lanes] = row_k.T
            Ab[k] = row_p
        factor = Ab[k + 1 :, k, :] / Ab[k, k, :]
        Ab[k + 1 :, k + 1 :] = Ab[k + 1 :, k + 1 :] - factor[:, None, :] * Ab[k, None, k + 1 :]
    acc = torch.zeros((nn, B), dtype=Ab.dtype, device=Ab.device)
    dx = torch.empty_like(acc)
    for k in range(nn - 1, -1, -1):
        dx[k] = (Ab[k, nn] - acc[k]) / Ab[k, k]
        acc[:k] = acc[:k] + Ab[:k, k] * dx[k]
    return dx


def chord_product(J0inv, F):
    """The chord step ``J0inv @ F`` (``[2m, 2m] x [2m, B]``) as one library
    product, as the JAX package's XLA solver computes it, with TF32 off
    whatever the caller set (a one-shot contraction stays in full
    float32)."""
    with full_precision():
        return J0inv @ F


def nr_core_plain(Yre, Yim, J0inv, p, q, *, x_tol, max_iter, chord_iters, pivot=False, init=None,
                  chord_matmul=False):
    """The plain twin of the kernel's per-lane solve, batch-last.

    ``Yre, Yim [n, n]``, ``J0inv [2m, 2m]`` (read when ``chord_iters > 0``),
    ``p, q [m, B]``.  ``init`` optionally gives a warm point ``(theta [m, B],
    vm [m, B])``, sanitised by
    :func:`~gym_anm_tpu_torch.ops.power_flow.warm_init_theta_vm`: each lane
    starts from it where its mismatch is finite and smaller than the flat
    start's; lanes the chord prefix made worse restart from the flat start
    either way.  ``chord_matmul`` computes each chord step as one
    :func:`chord_product` instead of the kernel's column-by-column sum (the
    plain solver ``ops/power_flow.py::solve_pfe`` sets it; the kernel's
    twin keeps the default).  Returns ``(vr, vi, ir, ii, diff, it)``: the bus
    voltages and currents ``[n, B]`` of the last accepted point, its
    mismatch inf-norm ``[B]`` and the chord + NR iterations ``[B]`` int32.
    Lanes stop as the kernel's do; the loops end once no lane is active.
    """
    m = Yre.shape[0] - 1
    B = p.shape[1]
    theta = torch.zeros((m, B), dtype=p.dtype, device=p.device)
    vm = torch.ones_like(theta)
    vr, vi, ir, ii, F, diff = _evaluate(Yre, Yim, theta, vm, p, q)
    flat = (theta, vm, vr, vi, ir, ii, F, diff)
    it = torch.zeros((B,), dtype=torch.int32, device=p.device)

    def step(active, theta, vm, dx, carried):
        """Take the step on active lanes; the others keep ``carried``."""
        new = _evaluate(Yre, Yim, theta - dx[:m], vm - dx[m:], p, q)
        return (torch.where(active, a, b) for a, b in zip((theta - dx[:m], vm - dx[m:]) + new, carried))

    state = flat
    if init is not None:
        warm = (init[0], init[1]) + _evaluate(Yre, Yim, init[0], init[1], p, q)
        use_w = torch.isfinite(warm[-1]) & (warm[-1] < diff)
        state = tuple(torch.where(use_w, a, b) for a, b in zip(warm, flat))
    if chord_iters > 0:
        diff0 = state[-1]
        for _ in range(chord_iters):
            active = state[-1] > x_tol  # NaN freezes the lane
            if not bool(active.any()):
                break
            F = state[6]
            if chord_matmul:
                dx = chord_product(J0inv, F)
            else:
                dx = torch.zeros_like(F)
                for j in range(2 * m):
                    dx = dx + J0inv[:, j : j + 1] * F[j]
            state = tuple(step(active, state[0], state[1], dx, state))
            it = it + active.to(torch.int32)
        bad = ~torch.isfinite(state[-1]) | (state[-1] > diff0)  # worsened: restart flat
        state = tuple(torch.where(bad, a, b) for a, b in zip(flat, state))
    for _ in range(max_iter):
        active = state[-1] > x_tol
        if not bool(active.any()):
            break
        theta, vm, vr, vi, ir, ii, F, _ = state
        dx = _solve_system(_system(Yre, Yim, vr, vi, ir, ii, F), pivot)
        state = tuple(step(active, theta, vm, dx, state))
        it = it + active.to(torch.int32)
    _, _, vr, vi, ir, ii, _, diff = state
    return vr, vi, ir, ii, diff, it


def _check_kernel_args(Y_re, Y_im, J0inv, p, q, init):
    n = Y_re.shape[0]
    m = n - 1
    for name, t in (("p", p), ("q", q)) + (() if init is None else (("theta_w", init[0]), ("vm_w", init[1]))):
        if not t.is_cuda:
            raise ValueError("%s must be a CUDA tensor for the dense-NR kernel" % name)
        if t.dtype != torch.float32:
            raise TypeError("the dense-NR kernel takes float32 only; %s is %s" % (name, t.dtype))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
        if t.dim() != 2 or t.shape[0] != m:
            raise ValueError("%s must be [m=%d, B]; got %s" % (name, m, tuple(t.shape)))
    if any(t.shape != p.shape or t.device != p.device for t in (q,) + (() if init is None else tuple(init))):
        raise ValueError("p, q and the warm point must have one shape and one device")
    if 2 * m > NN_MAX:
        raise ValueError("the dense-NR kernel solves up to %d unknowns; this grid has %d" % (NN_MAX, 2 * m))
    for name, t, shape in (("Y_re", Y_re, (n, n)), ("Y_im", Y_im, (n, n)), ("J0inv", J0inv, (2 * m, 2 * m))):
        ok = t.device == p.device and t.dtype == torch.float32 and t.is_contiguous() and tuple(t.shape) == shape
        if not ok:
            raise ValueError("%s must be a contiguous float32 %s tensor on the inputs' device" % (name, shape))
    if p.shape[1] == 0:
        raise ValueError("empty batch")


def solve_pfe_nr_cuda(Y_re, Y_im, J0inv, p, q, x_tol=1e-5, max_iter=10, chord_iters=0, pivot=False, init=None):
    """Launch the CUDA dense-NR kernel (``csrc/nr_dense.cu``).

    ``p, q [m, B]`` contiguous float32 CUDA tensors; ``Y_re, Y_im [n, n]`` and
    ``J0inv [2m, 2m]`` on the same device; ``init`` an optional warm point
    ``(theta [m, B], vm [m, B])`` like them (:func:`nr_core_plain`).  Returns ``(v_re [n, B], v_im
    [n, B], diff [B], n_iter [B] int32)``; raises on anything else and when
    the launch fails.
    """
    global KERNEL_LAUNCHES
    from ._build import load_library

    _check_kernel_args(Y_re, Y_im, J0inv, p, q, init)
    lib = load_library()
    n = Y_re.shape[0]
    B = p.shape[1]
    v_re = torch.empty((n, B), dtype=torch.float32, device=p.device)
    v_im = torch.empty_like(v_re)
    diff = torch.empty((B,), dtype=torch.float32, device=p.device)
    n_iter = torch.empty((B,), dtype=torch.int32, device=p.device)
    th_w, vm_w = (None, None) if init is None else (init[0].data_ptr(), init[1].data_ptr())
    rc = lib.nr_dense_solve_f32(
        Y_re.data_ptr(), Y_im.data_ptr(), J0inv.data_ptr(), p.data_ptr(), q.data_ptr(), th_w, vm_w,
        n, B, ctypes.c_float(x_tol), int(max_iter), int(chord_iters), int(bool(pivot)),
        v_re.data_ptr(), v_im.data_ptr(), diff.data_ptr(), n_iter.data_ptr(),
        torch.cuda.current_stream(p.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError("dense-NR kernel launch failed: CUDA error %d" % rc)
    KERNEL_LAUNCHES += 1
    return v_re, v_im, diff, n_iter


def nr_dense_geometry(n: int, chord_iters: int = 0) -> dict:
    """The kernel's launch geometry on the current card for an n-bus grid:
    threads a lane, lanes a block, threads a block, dynamic shared bytes a
    block and the blocks one SM keeps resident (``_build.GEOMETRY_FIELDS``)."""
    from ._build import load_library, read_geometry

    return read_geometry(load_library().nr_dense_geometry, int(n), int(chord_iters))


def solve_pfe_nr(Y_re, Y_im, J0inv, p, q, x_tol=1e-5, max_iter=10, chord_iters=0, pivot=False, init=None):
    """Batched dense-NR solve, the port of ``solve_pfe_pallas``.

    ``p, q [B, m]`` non-slack injections.  ``init`` optionally warm-starts
    from previous bus voltages ``(v_re [B, n], v_im [B, n])``, sanitised by
    :func:`~gym_anm_tpu_torch.ops.power_flow.warm_init_theta_vm`, with the
    per-lane best-of-{warm, flat} guard.  A CUDA tensor launches the kernel
    (float32 only); a CPU tensor runs :func:`nr_core_plain`.  Returns
    ``(v_re [B, n], v_im [B, n], diff [B], n_iter [B], converged [B])``.
    """
    from .power_flow import warm_init_theta_vm

    pT, qT = p.T.contiguous(), q.T.contiguous()
    warm = None
    if init is not None:
        th, vm, _ = warm_init_theta_vm(init[0], init[1], p.shape[1], p.dtype)
        warm = (th.contiguous(), vm.contiguous())
    kw = dict(x_tol=x_tol, max_iter=max_iter, chord_iters=chord_iters, pivot=pivot, init=warm)
    if p.is_cuda:
        vr, vi, diff, n_iter = solve_pfe_nr_cuda(Y_re, Y_im, J0inv, pT, qT, **kw)
    else:
        vr, vi, _, _, diff, n_iter = nr_core_plain(Y_re, Y_im, J0inv, pT, qT, **kw)
    return vr.T, vi.T, diff, n_iter, diff <= x_tol
