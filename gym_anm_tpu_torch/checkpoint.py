"""Checkpoint and resume of environment, simulator and learner state.

The counterpart of ``gym_anm_tpu.checkpoint``: every piece of dynamic state
is a tree of tensors (:class:`~gym_anm_tpu_torch.core.env_core.EnvState`,
:class:`~gym_anm_tpu_torch.core.state.SimState`, a trainer's weights and
optimiser moments, ...), so a checkpoint is a ``.npz`` file of the leaves
in flattening order plus a fingerprint of the tree's structure:

    >>> save_pytree("rollout.npz", env_state)
    >>> env_state = load_pytree("rollout.npz", like=env_state)

A tree is made of dataclasses, NamedTuples, dicts, lists and tuples; its
leaves are tensors, NumPy arrays and Python scalars (``None`` is kept as
structure).  ``load_pytree`` restores onto the structure of a ``like``
template with the same fingerprint, checking every leaf's shape and dtype,
so that a stale or mismatched checkpoint fails loudly instead of producing
garbage physics.  A tensor comes back on the template leaf's device.
"""

from __future__ import annotations

import dataclasses
import json
import numbers

import numpy as np
import torch

__all__ = ["save_pytree", "load_pytree"]

_STRUCT_KEY = "__pytree_structure__"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, leaves: list) -> str:
    """Append the leaves of ``tree`` to ``leaves``; return its structure."""
    if tree is None:
        return "None"
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        parts = ("%s=%s" % (f.name, _flatten(getattr(tree, f.name), leaves)) for f in dataclasses.fields(tree))
        return "%s(%s)" % (type(tree).__name__, ",".join(parts))
    if _is_namedtuple(tree):
        parts = ("%s=%s" % (k, _flatten(v, leaves)) for k, v in zip(tree._fields, tree))
        return "%s(%s)" % (type(tree).__name__, ",".join(parts))
    if isinstance(tree, dict):
        return "{%s}" % ",".join("%r:%s" % (k, _flatten(v, leaves)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        inner = ",".join(_flatten(v, leaves) for v in tree)
        return "[%s]" % inner if isinstance(tree, list) else "(%s)" % inner
    if isinstance(tree, (torch.Tensor, np.ndarray, numbers.Number, str)):
        leaves.append(tree)
        return "*"
    raise TypeError("cannot checkpoint a leaf of type %s" % type(tree).__name__)


def _unflatten(tree, leaves):
    """``tree`` with its leaves replaced, in order, from the iterator."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _unflatten(getattr(tree, f.name), leaves)
                                            for f in dataclasses.fields(tree)})
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(v, leaves) for v in tree))
    if isinstance(tree, dict):
        return type(tree)((k, _unflatten(v, leaves)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree) -> None:
    """Serialise a tree of tensors, arrays and scalars to ``path``
    (``.npz``).  Tensors are copied to the host; the structure is stored as
    a fingerprint checked on load, the leaves positionally."""
    leaves = []
    structure = _flatten(tree, leaves)
    arrays = [_to_numpy(leaf) for leaf in leaves]
    payload = {"leaf_%d" % i: a for i, a in enumerate(arrays)}
    meta = {
        "structure": structure,
        "n_leaves": len(arrays),
        "shapes": [list(a.shape) for a in arrays],
        "dtypes": [str(a.dtype) for a in arrays],
    }
    payload[_STRUCT_KEY] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    with open(path, "wb") as fh:
        np.savez(fh, **payload)


def _restore(arr: np.ndarray, ref):
    """The saved array as a leaf of the template's kind."""
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(arr).to(ref.device)
    if isinstance(ref, np.ndarray):
        return arr
    return type(ref)(arr.item())


def load_pytree(path: str, like):
    """Restore a tree saved by :func:`save_pytree` onto the structure of
    ``like`` (its leaf values are ignored).  Raises ``ValueError`` on any
    structure, shape or dtype mismatch."""
    ref_leaves = []
    structure = _flatten(like, ref_leaves)
    with np.load(path) as data:
        meta = json.loads(bytes(data[_STRUCT_KEY]).decode())
        if meta["structure"] != structure:
            raise ValueError(
                "checkpoint structure mismatch:\n  saved: %s\n  expected: %s" % (meta["structure"], structure)
            )
        if meta["n_leaves"] != len(ref_leaves):
            raise ValueError("checkpoint has %d leaves, template has %d" % (meta["n_leaves"], len(ref_leaves)))
        new_leaves = []
        for i, ref in enumerate(ref_leaves):
            arr = data["leaf_%d" % i]
            want = _to_numpy(ref) if not isinstance(ref, torch.Tensor) else None
            want_shape = tuple(ref.shape) if want is None else want.shape
            want_dtype = torch.empty((), dtype=ref.dtype).numpy().dtype if want is None else want.dtype
            if arr.shape != want_shape:
                raise ValueError("leaf %d: saved shape %s != template shape %s" % (i, arr.shape, want_shape))
            if arr.dtype != want_dtype:
                raise ValueError("leaf %d: saved dtype %s != template dtype %s" % (i, arr.dtype, want_dtype))
            new_leaves.append(_restore(arr, ref))
    return _unflatten(like, iter(new_leaves))
