"""The 141-bus multi-trunk feeder task on tensors.

The counterpart of ``make_core`` of ``gym_anm_tpu.envs.feeder141``: the
synthetic 141-bus network of four trunks with short laterals
(:func:`~gym_anm_tpu_torch.envs.feeder_networks.make_multi_feeder_network`)
under the dynamics of the 33-bus feeder task (:mod:`.feeder33`: stochastic
loads around a daily profile, stochastic renewable potentials, the
time-of-day index as the one auxiliary variable).

The Gymnasium class ``Feeder141Env`` lives in :mod:`.feeder141_gym` and
is reached here too, imported on first access.
"""

from __future__ import annotations

import torch

from ..core.transition import resolve_solver_path


def pf_max_iter_for(pf_method: str) -> int:
    """The calibrated NR budgets at this size: 0 for the chord-only hybrids,
    18 for the tree solves (the JAX package's rollout-measured p100 = 15
    including termination-adjacent lanes), ``"fused"`` included, whose
    solve is the tree solve here, and 6 for dense NR."""
    if pf_method in ("hybrid", "xla_hybrid"):
        return 0
    if pf_method in ("tree", "tree_xla", "fused"):
        return 18
    return 6


def make_core(
    dtype=torch.float32, device="cuda", pf_max_iter=None, pf_method="tree", chord_iters=28, x_tol=None,
    nr_pivot=False, warm_start=False, network=None,
):
    """Build the feeder141 :class:`~gym_anm_tpu_torch.core.env_core.EnvCore`
    computing on ``device`` (the card unless the caller passes ``"cpu"``) in
    ``dtype``.

    ``pf_method``: ``"tree"`` (the default) is the exact per-lane NR of the
    tree-NR kernel and ``"tree_xla"`` its plain twin; ``"fused"`` is the
    whole transition in one launch of the fused-transition kernel, whose
    solve is here the tree-NR kernel's (its tree form, without pivoting);
    ``"hybrid"`` and ``"xla_hybrid"`` are chord-only (``chord_iters`` iterations of one
    ``[280, 280] x [280, B]`` product each, lanes the chord cannot converge
    flagged unconverged: an ablation); ``"scan"`` and ``"while"`` are dense
    per-lane NR for verification.  All but ``"tree"`` and ``"fused"`` run
    plain PyTorch; ``"pallas"`` and ``"fused_hybrid"`` (the dense kernels)
    are refused.
    ``pf_max_iter=None`` takes :func:`pf_max_iter_for`.  ``x_tol=None``
    takes 3e-5 in float32 and 1e-5 in float64 for every method: the float32
    mismatch of this network plateaus just above the reference's 1e-5 on
    full-load lanes whatever the solver (3e-5 is 3 kVA on the 100 MVA base).
    ``warm_start`` warm-starts each step's solve from the previous step's
    voltages (off by default).  ``network`` replaces the 141-bus network
    (:func:`~gym_anm_tpu_torch.envs.feeder_networks.make_multi_feeder_network`)
    with another network dict under the same dynamics and budgets.
    """
    from .feeder33 import make_core as feeder_make_core
    from .feeder_networks import make_multi_feeder_network

    if x_tol is None:
        x_tol = 1e-5 if dtype == torch.float64 else 3e-5
    core = feeder_make_core(
        dtype=dtype,
        device=device,
        pf_max_iter=pf_max_iter_for(pf_method) if pf_max_iter is None else pf_max_iter,
        pf_method=pf_method,
        chord_iters=chord_iters,
        nr_pivot=nr_pivot,
        warm_start=warm_start,
        network=make_multi_feeder_network() if network is None else network,
        x_tol=x_tol,
    )
    # Refuse here what the transition would refuse at its first step.
    resolve_solver_path(core.grid, pf_method, nr_pivot)
    return core


def __getattr__(name):
    # The Gymnasium class, imported only when asked for: the batched path
    # (make_core and the hooks) never imports Gymnasium.
    if name == "Feeder141Env":
        from .feeder141_gym import Feeder141Env

        return Feeder141Env
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
