"""Join a rank to its process group from a torchrun-style environment.

The counterpart of ``jax.distributed.initialize`` in
``scripts/multiproc_dist.py``.  A launcher on each host (``torchrun``, a
cluster scheduler, or :func:`~.dryrun.run_ranks`) starts one process a
card and gives it five variables:

* ``RANK``: the rank's place among every rank of every host;
* ``WORLD_SIZE``: the number of ranks;
* ``LOCAL_RANK``: its place among its host's ranks, which picks its card;
* ``MASTER_ADDR``, ``MASTER_PORT``: where the rendezvous store is served:
  by rank 0, or by the launcher when ``TORCHELASTIC_USE_AGENT_STORE`` is
  ``True`` (as ``torchrun`` sets it, and :func:`~.dryrun.run_ranks`).

:func:`init_from_env` reads them, sets the card and joins the group
through ``env://``.  There is no single-process fallback and no switch
from ``nccl`` to ``gloo``: a missing variable or card raises.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_from_env(backend: str = "nccl") -> torch.device:
    """Set this rank's device from ``LOCAL_RANK`` (``nccl``: card
    ``cuda:LOCAL_RANK`` of the host's visible cards; ``gloo``: the CPU),
    initialize the default process group through ``env://`` and return the
    device.

    Raises when a variable of :data:`LAUNCH_VARS` is missing or empty, when
    ``backend`` is neither ``nccl`` nor ``gloo``, and over ``nccl`` when the
    host has no card ``LOCAL_RANK``.
    """
    missing = [k for k in LAUNCH_VARS if not os.environ.get(k)]
    if missing:
        raise RuntimeError("the launch environment lacks %s (set by torchrun or the host's launcher)"
                           % ", ".join(missing))
    if backend not in ("nccl", "gloo"):
        raise ValueError("backend must be 'nccl' (cards) or 'gloo' (CPU processes), not %r" % backend)
    rank, world, local = (int(os.environ[k]) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if local >= cards:
            raise RuntimeError("LOCAL_RANK=%d, but this host sees %d cards" % (local, cards))
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    else:
        device = torch.device("cpu")
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return device
