"""Full float32 for one-shot contractions.

TF32 keeps 10 bits of a float32 mantissa.  A product that is computed once
and not refined (a chord step of the power flow, a KKT factorization of the
MPC agents) runs with TF32 off, whatever the caller set globally.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def full_precision():
    """TF32 off for CUDA matrix products inside the block; the previous
    settings are restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def in_full_precision(f):
    """``f`` run under :func:`full_precision`."""

    @functools.wraps(f)
    def g(*args, **kwargs):
        with full_precision():
            return f(*args, **kwargs)

    return g
