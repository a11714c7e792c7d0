"""Data-parallel batching of environment lanes over ``torch.distributed``.

The counterpart of ``gym_anm_tpu.parallel.sharding``.  Stepping ANM
environments is embarrassingly parallel across the batch, so the scaling is
pure data parallelism over a 1-D mesh named ``("env",)``.  JAX shards one
process's batch over a mesh of local devices and XLA inserts the
collectives; here one process (a rank) drives one card, the ranks are
joined in a process group (``nccl`` on cards, ``gloo`` on the CPU), and the
few collectives are explicit calls of this module:

* :func:`make_mesh` spans every rank of the initialized group (it raises
  without one: there is no single-process fallback);
* :func:`batch_sharding` gives each rank a contiguous slice of the leading
  (lane) axis of a global batch, :func:`shard_batch` places it on the
  rank's device and :func:`gather_batch` gathers it back (what
  ``np.asarray`` of a sharded array gives a JAX user);
* :func:`replicated` broadcasts from rank 0;
* the dp trainers and the sharded MPC solve reduce and gather through
  :func:`all_reduce_mean_` and :func:`all_gather`.

:data:`COLLECTIVES` counts every collective these helpers issue in this
process, the analog of the JAX dry run's checks on the compiled program's
collectives: a dp update issues some, stepping environments none.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import _flatten, _unflatten

ENV_AXIS = "env"
# Collectives issued by this module's helpers in this process.
COLLECTIVES = 0
# The backend each mesh device type runs on; a mismatch is refused.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(n_devices=None, device_type="cuda"):
    """A 1-D ``DeviceMesh`` named ``("env",)`` over every rank of the
    initialized process group, one card (or one CPU process) a rank.

    Raises without an initialized group, when ``n_devices`` is not the
    group's size, and when the group's backend is not the one of
    ``device_type`` (``nccl`` for ``"cuda"``, ``gloo`` for ``"cpu"``).
    """
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialized process group: call torch.distributed.init_process_group "
            "in each rank first (torch.multiprocessing or torchrun, one process a card)"
        )
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError("the mesh spans every rank: n_devices=%s, but the group has %d" % (n_devices, world))
    backend = dist.get_backend()
    if BACKENDS.get(device_type) != backend:
        raise ValueError("a %r mesh runs on %r, but the group's backend is %r"
                         % (device_type, BACKENDS.get(device_type), backend))
    return DeviceMesh(device_type, list(range(world)), mesh_dim_names=(ENV_AXIS,))


def rank_device(mesh) -> torch.device:
    """This rank's device: its card (``cuda:<local rank>``, set when the rank
    started) or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def rank_seed(seed: int, rank: int) -> int:
    """A generator seed of its own for each ``(seed, rank)``."""
    return int(np.random.SeedSequence([int(seed), int(rank)]).generate_state(1)[0])


def _map_arrays(fn, tree):
    """``tree`` with ``fn`` applied to each tensor and array leaf; other
    leaves (numbers, strings) pass unchanged."""
    leaves = []
    _flatten(tree, leaves)
    mapped = [fn(torch.as_tensor(x)) if isinstance(x, (torch.Tensor, np.ndarray)) else x for x in leaves]
    return _unflatten(tree, iter(mapped))


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """This rank's contiguous slice of the leading (lane) axis of every
    global batch (JAX's ``NamedSharding(mesh, P("env"))``)."""

    mesh: object

    def lanes(self, B: int) -> slice:
        """This rank's lanes of a global batch of ``B``; raises unless the
        mesh size divides ``B``."""
        n, r = self.mesh.size(), self.mesh.get_local_rank()
        if B % n:
            raise ValueError("a batch of %d lanes does not split evenly over %d ranks" % (B, n))
        k = B // n
        return slice(r * k, (r + 1) * k)

    def place(self, tree):
        """This rank's slice of every leaf's leading axis, on its device."""
        dev = rank_device(self.mesh)
        return _map_arrays(lambda x: x[self.lanes(x.shape[0])].to(dev), tree)


@dataclasses.dataclass(frozen=True)
class Replicated:
    """Every rank holds rank 0's copy (JAX's ``NamedSharding(mesh, P())``)."""

    mesh: object

    def place(self, tree):
        """Every leaf broadcast from rank 0, on this rank's device (a copy:
        the caller's tensors are left as they were)."""
        dev = rank_device(self.mesh)
        return _map_arrays(lambda x: broadcast_(x.to(dev, copy=True).contiguous(), self.mesh), tree)


def batch_sharding(mesh) -> BatchSharding:
    return BatchSharding(mesh)


def replicated(mesh) -> Replicated:
    return Replicated(mesh)


def shard_batch(tree, mesh):
    """Place a batched tree with its leading axis split over the mesh: this
    rank keeps its lanes, on its device."""
    return batch_sharding(mesh).place(tree)


def gather_batch(tree, mesh):
    """The global batch of every leaf, gathered along the leading axis from
    every rank's slice (rank order, one ``all_gather`` a leaf), on this
    rank's device."""
    dev = rank_device(mesh)
    return _map_arrays(lambda x: all_gather(x.to(dev), mesh), tree)


def _count():
    global COLLECTIVES
    COLLECTIVES += 1


def broadcast_(t: torch.Tensor, mesh, src: int = 0) -> torch.Tensor:
    """Overwrite ``t`` with rank ``src``'s ``t``."""
    _count()
    dist.broadcast(t, src=src, group=mesh.get_group())
    return t


def all_gather(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``t`` concatenated along the leading axis, in rank order
    (equal shapes on every rank; booleans travel as bytes)."""
    _count()
    x = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size())]
    dist.all_gather(parts, x, group=mesh.get_group())
    out = torch.cat(parts)
    return out.bool() if t.dtype == torch.bool else out


def all_reduce_mean_(t: torch.Tensor, mesh) -> torch.Tensor:
    """Overwrite ``t`` with the mean of every rank's ``t`` (a sum, then one
    division: every rank ends with the same bits)."""
    _count()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.get_group())
    return t.div_(mesh.size())


def _flat_(tensors, fn):
    """Run ``fn`` on the tensors concatenated into one buffer, then copy the
    buffer back: one collective for them all."""
    flat = fn(torch.cat([t.reshape(-1) for t in tensors]))
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def broadcast_params_(modules, mesh):
    """Every parameter and buffer of ``modules`` overwritten with rank 0's."""
    with torch.no_grad():
        _flat_([t for m in modules for t in list(m.parameters()) + list(m.buffers())], lambda f: broadcast_(f, mesh))


def average_grads_(params, mesh):
    """The gradients of ``params`` replaced by their mean over the ranks (one
    ``all_reduce``); parameters without a gradient are skipped."""
    grads = [p.grad for p in params if p.grad is not None]
    if grads:
        _flat_(grads, lambda f: all_reduce_mean_(f, mesh))
