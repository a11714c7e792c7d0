"""Batched Newton-Raphson AC power flow in plain PyTorch, all-real arithmetic.

The counterpart of ``gym_anm_tpu.ops.power_flow`` (the reference solver
``gym_anm/simulator/solve_load_flow.py:7-226``): :func:`solve_pfe` with the
methods ``scan``, ``while`` and ``hybrid`` (the flat start, an optional
chord prefix, then true-NR steps; the inf-norm of the mismatch <= x_tol
stops a lane, NaN freezes it; ``init=`` warm-starts each lane from the
better of {warm point, flat start}), the host builder
:func:`flat_start_jacobian_inv_np` and :func:`warm_init_theta_vm`, the warm
point of every solver's warm start.

The JAX package's XLA solver and the body of its dense-NR kernel compute the
same iteration, so one plain solver serves both here: :func:`solve_pfe` runs
the dense-NR kernel's plain twin
(:func:`~gym_anm_tpu_torch.ops.nr_cuda.nr_core_plain`) with partial
pivoting, as the XLA solver pivots, and with each chord step as one
``J0inv @ F`` product (TF32 off), as the XLA solver's chord step is one
``jnp.dot``.  It stays plain PyTorch on every device: it is the
counterpart of XLA code, not of a TPU kernel.

The slack bus is index 0 with its voltage pinned at 1 + 0j.
"""

from __future__ import annotations

import numpy as np
import torch

from .nr_cuda import nr_core_plain

METHODS = ("scan", "while", "hybrid")


def cmul(ar, ai, br, bi):
    """(ar + j ai) * (br + j bi) -> (re, im)."""
    return ar * br - ai * bi, ar * bi + ai * br


def flat_start_jacobian_inv_np(Y_re, Y_im, dtype=None):
    """Inverse of the flat-start NR Jacobian, on the host in NumPy.

    A copy of ``gym_anm_tpu.ops.power_flow.flat_start_jacobian_inv_np``: at
    the flat start the polar Jacobian is a fixed function of the admittance
    matrix, so its inverse is the constant iteration matrix of the chord
    method.  Computed in float64, cast to ``dtype`` (default: Y's dtype).
    """
    Y = np.asarray(Y_re, np.float64) + 1j * np.asarray(Y_im, np.float64)
    n = Y.shape[0]
    v = np.ones(n, dtype=complex)  # flat start: theta=0, |V|=1
    i0 = Y @ v
    w = np.diag(i0) - Y * v[None, :]  # delta_ik (Yv)_i - Y_ik v_k
    dSa = 1j * v[:, None] * np.conj(w)
    vn = v / np.abs(v)
    u = Y * vn[None, :]
    dSm = np.diag(vn * np.conj(i0)) + v[:, None] * np.conj(u)
    J0 = np.block(
        [
            [dSa[1:, 1:].real, dSm[1:, 1:].real],
            [dSa[1:, 1:].imag, dSm[1:, 1:].imag],
        ]
    )
    out_dt = dtype if dtype is not None else np.asarray(Y_re).dtype
    return np.linalg.inv(J0).astype(out_dt)


def warm_init_theta_vm(v_re, v_im, m, dt):
    """Per-lane (theta, vm, valid) from previous-step bus voltages.

    A copy of ``gym_anm_tpu.ops.power_flow.warm_init_theta_vm``.  ``v_re,
    v_im [..., n]`` (batch-first, the layout solvers return and ``SimState``
    stores).  Returns batch-last ``theta, vm [m, B]`` and a per-lane
    ``valid [B]``: a lane is a usable warm start only when every bus voltage
    is finite and its magnitude lies inside 0.25..4 p.u.; absorbing zero
    states, diverged solutions and other invalid lanes get the flat start.
    The convergence decision is never affected: it stays on the true
    mismatch at ``x_tol``.
    """
    vr = torch.movedim(v_re.to(dt), -1, 0)[1:]  # [m, B]
    vi = torch.movedim(v_im.to(dt), -1, 0)[1:]
    vm = torch.sqrt(vr * vr + vi * vi)
    theta = torch.atan2(vi, vr)
    finite = torch.all(torch.isfinite(vr) & torch.isfinite(vi), dim=0)
    window = torch.all((vm > 0.25) & (vm < 4.0), dim=0)
    valid = finite & window
    theta = torch.where(valid[None, :], theta, torch.zeros_like(theta))
    vm = torch.where(valid[None, :], vm, torch.ones_like(vm))
    return theta, vm, valid


def solve_pfe(Y_re, Y_im, p, q, x_tol=1e-5, max_iter=100, method="scan", chord_iters=16, J0inv=None, init=None):
    """Newton-Raphson solve of the AC power-flow equations.

    ``Y_re, Y_im [n, n]`` tensors; ``p, q [B, m]`` non-slack injections in
    p.u., on the device and in the dtype of the solve.

    ``method``: ``"scan"`` is the JAX package's masked fixed-budget loop and
    ``"while"`` its early-exit twin; they give identical results, and here
    both are one loop that stops once no lane is active (a masked step
    changes nothing).  ``"hybrid"`` first runs ``chord_iters`` chord
    iterations x <- x - J0inv F(x) with the constant flat-start Jacobian
    inverse ``J0inv [2m, 2m]`` (computed from Y when not given); lanes the
    chord phase made worse (or NaN) restart the ``max_iter`` true-NR
    iterations from the flat start.

    ``init`` optionally warm-starts from previous bus voltages ``(v_re
    [B, n], v_im [B, n])``: each lane starts from whichever of {warm point,
    flat start} has the smaller true mismatch, lanes with non-finite or
    out-of-window voltages flat-start (:func:`warm_init_theta_vm`), and the
    convergence decision is unchanged.

    Returns ``(v_re [B, n], v_im [B, n], diff [B], n_iter [B] int32,
    converged [B])``; ``n_iter`` counts the chord and the NR iterations.
    """
    if method not in METHODS:
        raise ValueError("method %r is not one of %s" % (method, METHODS))
    chord = chord_iters if method == "hybrid" else 0
    if chord > 0:
        if J0inv is None:
            J0inv = flat_start_jacobian_inv_np(Y_re.cpu().numpy(), Y_im.cpu().numpy())
        J0inv = torch.as_tensor(J0inv, device=p.device).to(p.dtype)
    warm = None if init is None else warm_init_theta_vm(init[0], init[1], p.shape[1], p.dtype)[:2]
    vr, vi, _, _, diff, n_iter = nr_core_plain(
        Y_re, Y_im, J0inv, p.T, q.T, x_tol=x_tol, max_iter=max_iter, chord_iters=chord, pivot=True, init=warm,
        chord_matmul=True,
    )
    return vr.T, vi.T, diff, n_iter, diff <= x_tol
