"""Baran and Wu's 33-bus feeder task on tensors.

Baran and Wu's published 12.66 kV feeder (IEEE Trans. Power Delivery
4(2), 1989; MATPOWER's ``case33bw``) at its published loads, with three PV
units and two storage units added
(:func:`~gym_anm_tpu_torch.envs.feeder_networks.make_baran_wu_33_network`),
under the dynamics of the 33-bus feeder task (:mod:`.feeder33`: loads drawn
around a daily profile, renewable potentials drawn, the time-of-day index
as the one auxiliary variable).  At the published loading most buses past
the feeder's middle sit below 0.95 p.u., so the reward's voltage penalty is
at work.

The Gymnasium class ``Baranwu33Env`` lives in :mod:`.baranwu33_gym` and is
reached here too, imported on first access.
"""

from __future__ import annotations

import torch


def make_core(
    dtype=torch.float32, device="cuda", pf_max_iter=None, pf_method="tree", chord_iters=16, nr_pivot=False,
    warm_start=False, network=None, x_tol=1e-5,
):
    """Build the baranwu33 :class:`~gym_anm_tpu_torch.core.env_core.EnvCore`
    computing on ``device`` (the card unless the caller passes ``"cpu"``) in
    ``dtype``: :func:`.feeder33.make_core` on Baran and Wu's feeder, or on
    ``network`` when one is passed.  ``x_tol`` 1e-5 on the 100 MVA base is
    1 kW; ``pf_max_iter=None`` takes feeder33's budgets."""
    from .feeder33 import make_core as feeder_make_core
    from .feeder_networks import make_baran_wu_33_network

    return feeder_make_core(
        dtype=dtype,
        device=device,
        pf_max_iter=pf_max_iter,
        pf_method=pf_method,
        chord_iters=chord_iters,
        nr_pivot=nr_pivot,
        warm_start=warm_start,
        network=make_baran_wu_33_network() if network is None else network,
        x_tol=x_tol,
    )


def __getattr__(name):
    # The Gymnasium class, imported only when asked for: the batched path
    # (make_core and the hooks) never imports Gymnasium.
    if name == "Baranwu33Env":
        from .baranwu33_gym import Baranwu33Env

        return Baranwu33Env
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
