"""Data-parallel batching of environment lanes over ``torch.distributed``.

The counterpart of ``gym_anm_tpu.parallel.sharding``.  Stepping ANM
environments is embarrassingly parallel across the batch, so the scaling is
pure data parallelism over a 1-D mesh named ``("env",)``.  JAX shards one
process's batch over a mesh of local devices and XLA inserts the
collectives; here one process (a rank) drives one card, the ranks are
joined in a process group (``nccl`` on cards, ``gloo`` on the CPU), and the
few collectives are explicit calls of this module:

* :func:`make_mesh` spans every rank of the initialized group (it raises
  without one: there is no single-process fallback); with ``tp > 1`` it is
  the 2-D ``dp x tp`` mesh ``("env", "tp")`` of the JAX dry run, whose
  second dimension splits the PPO actor-critic's torso
  (:mod:`.tensor`).  Lanes, generator seeds and every helper below follow
  the dp coordinate (:func:`dp_rank`) and the dp group: ranks that share a
  dp coordinate hold the same lanes and draw the same numbers, as JAX's
  ``P("env")`` replicated over ``tp`` does;
* :func:`batch_sharding` gives each rank a contiguous slice of the leading
  (lane) axis of a global batch, :func:`shard_batch` places it on the
  rank's device and :func:`gather_batch` gathers it back (what
  ``np.asarray`` of a sharded array gives a JAX user);
* :func:`replicated` broadcasts from rank 0;
* the dp trainers and the sharded MPC solve reduce and gather through
  :func:`all_reduce_mean_` and :func:`all_gather`.

:data:`COLLECTIVES` counts every collective these helpers and the tp layers
issue in this process, :data:`TP_COLLECTIVES` those of them on a tp group:
the analog of the JAX dry run's checks on the compiled program's
collectives: a dp update issues some, stepping environments none.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import _flatten, _unflatten

ENV_AXIS = "env"
TP_AXIS = "tp"
# Collectives issued by this module's helpers and by the tp layers in this
# process, and those of them that ran on a tp group.
COLLECTIVES = 0
TP_COLLECTIVES = 0
# The backend each mesh device type runs on; a mismatch is refused.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(n_devices=None, device_type="cuda", tp=1):
    """A ``DeviceMesh`` over every rank of the initialized process group,
    one card (or one CPU process) a rank: 1-D ``("env",)`` at ``tp == 1``,
    else ``(world // tp, tp)`` named ``("env", "tp")``, rank ``r`` at dp
    coordinate ``r // tp`` and tp coordinate ``r % tp``.

    Raises without an initialized group, when ``n_devices`` is not the
    group's size, when ``tp`` does not divide it, and when the group's
    backend is not the one of ``device_type`` (``nccl`` for ``"cuda"``,
    ``gloo`` for ``"cpu"``).
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
    tp = int(tp)
    if tp < 1 or world % tp:
        raise ValueError("tp=%d does not divide the group's %d ranks" % (tp, world))
    if tp == 1:
        return DeviceMesh(device_type, list(range(world)), mesh_dim_names=(ENV_AXIS,))
    return DeviceMesh(device_type, np.arange(world).reshape(world // tp, tp).tolist(),
                      mesh_dim_names=(ENV_AXIS, TP_AXIS))


def dp_size(mesh) -> int:
    """The mesh's number of dp coordinates (lane shards)."""
    return mesh.size(0)


def dp_rank(mesh) -> int:
    """This rank's dp coordinate: which shard of the lanes it holds."""
    return mesh.get_local_rank(0)


def tp_size(mesh) -> int:
    """The mesh's tp width (1 on a 1-D mesh)."""
    return mesh.size(1) if mesh.ndim == 2 else 1


def tp_rank(mesh) -> int:
    """This rank's tp coordinate (0 on a 1-D mesh)."""
    return mesh.get_local_rank(1) if mesh.ndim == 2 else 0


def dp_group(mesh):
    """The ranks that share this rank's tp coordinate, one a dp coordinate."""
    return mesh.get_group(0)


def tp_group(mesh):
    """The ranks that share this rank's dp coordinate (``None`` on a 1-D
    mesh: there is no tp group)."""
    return mesh.get_group(1) if mesh.ndim == 2 else None


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
        """This rank's lanes of a global batch of ``B`` (those of its dp
        coordinate); raises unless the dp size divides ``B``."""
        n, r = dp_size(self.mesh), dp_rank(self.mesh)
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
        """Every leaf broadcast from rank 0 to every rank of the mesh, on
        this rank's device (a copy: the caller's tensors are left as they
        were)."""
        dev = rank_device(self.mesh)
        return _map_arrays(lambda x: _broadcast(x.to(dev, copy=True).contiguous(), None), tree)


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


def count_collective(tp: bool = False):
    """Count one collective issued in this process (``tp``: on a tp group)."""
    global COLLECTIVES, TP_COLLECTIVES
    COLLECTIVES += 1
    TP_COLLECTIVES += bool(tp)


def _broadcast(t: torch.Tensor, group) -> torch.Tensor:
    """Overwrite ``t`` with the ``t`` of the first rank of ``group`` (the
    whole group when ``None``)."""
    count_collective()
    dist.broadcast(t, src=0 if group is None else dist.get_global_rank(group, 0), group=group)
    return t


def broadcast_(t: torch.Tensor, mesh) -> torch.Tensor:
    """Overwrite ``t`` with the ``t`` of dp coordinate 0 (the rank of this
    tp coordinate there)."""
    return _broadcast(t, dp_group(mesh))


def all_gather(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every dp coordinate's ``t`` concatenated along the leading axis, in
    dp order (equal shapes on every rank; booleans travel as bytes)."""
    count_collective()
    x = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(x) for _ in range(dp_size(mesh))]
    dist.all_gather(parts, x, group=dp_group(mesh))
    out = torch.cat(parts)
    return out.bool() if t.dtype == torch.bool else out


def all_reduce_mean_(t: torch.Tensor, mesh) -> torch.Tensor:
    """Overwrite ``t`` with the mean of every dp coordinate's ``t`` (a sum,
    then one division: every rank ends with the same bits)."""
    count_collective()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=dp_group(mesh))
    return t.div_(dp_size(mesh))


def _flat_(tensors, fn):
    """Run ``fn`` on the tensors concatenated into one buffer, then copy the
    buffer back: one collective for them all."""
    flat = fn(torch.cat([t.reshape(-1) for t in tensors]))
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def broadcast_params_(modules, mesh):
    """Every parameter and buffer of ``modules`` overwritten with those of
    dp coordinate 0."""
    with torch.no_grad():
        _flat_([t for m in modules for t in list(m.parameters()) + list(m.buffers())], lambda f: broadcast_(f, mesh))


def average_grads_(params, mesh):
    """The gradients of ``params`` replaced by their mean over the dp
    coordinates (one ``all_reduce``); parameters without a gradient are
    skipped."""
    grads = [p.grad for p in params if p.grad is not None]
    if grads:
        _flat_(grads, lambda f: all_reduce_mean_(f, mesh))
