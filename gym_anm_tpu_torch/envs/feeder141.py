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

# The power-flow methods the JAX package refuses at this size: its per-lane
# 560 x 560 Jacobian tiles exceed the TPU's VMEM, and the port's dense
# kernels take systems of at most 64 unknowns.
REFUSED_METHODS = ("pallas", "fused", "fused_hybrid")
# The JAX package's calibrated tree-NR budget at this size: rollout-measured
# p100 = 15 including termination-adjacent lanes.
TREE_MAX_ITER = 18


def make_core(
    dtype=torch.float32, device="cuda", pf_max_iter=None, pf_method="tree", x_tol=None, warm_start=False
):
    """Build the feeder141 :class:`~gym_anm_tpu_torch.core.env_core.EnvCore`
    computing on ``device`` (the card unless the caller passes ``"cpu"``) in
    ``dtype``.

    ``pf_method="tree"`` (the exact per-lane NR of the tree-NR kernel) is
    the only method ported at this size; ``pf_max_iter=None`` takes its
    calibrated budget of 18.  ``x_tol=None`` takes 3e-5 in float32 and 1e-5
    in float64: the float32 mismatch of this network plateaus just above the
    reference's 1e-5 on full-load lanes whatever the solver, so every
    float32 configuration uses 3e-5 (3 kVA on the 100 MVA base).
    ``warm_start`` warm-starts each step's solve from the previous step's
    voltages (off by default).
    """
    from .feeder33 import make_core as feeder_make_core
    from .feeder_networks import make_multi_feeder_network

    if pf_method in REFUSED_METHODS:
        raise ValueError(
            "pf_method=%r unsupported at 141 buses: the per-lane 280 x 280 Jacobian exceeds the "
            "dense kernels' 64 unknowns. Use 'tree'." % (pf_method,)
        )
    if pf_method != "tree":
        raise ValueError(
            "pf_method=%r is not ported for the 141-bus task yet (ROADMAP, Queue 1 item 8); "
            "use 'tree'" % (pf_method,)
        )
    if x_tol is None:
        x_tol = 1e-5 if dtype == torch.float64 else 3e-5
    return feeder_make_core(
        dtype=dtype,
        device=device,
        pf_max_iter=TREE_MAX_ITER if pf_max_iter is None else pf_max_iter,
        pf_method=pf_method,
        warm_start=warm_start,
        network=make_multi_feeder_network(),
        x_tol=x_tol,
    )


def __getattr__(name):
    # The Gymnasium class, imported only when asked for: the batched path
    # (make_core and the hooks) never imports Gymnasium.
    if name == "Feeder141Env":
        from .feeder141_gym import Feeder141Env

        return Feeder141Env
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
