"""Alias of :mod:`gym_anm_tpu_torch.constants` at the reference's import path."""

from ...constants import *  # noqa: F401,F403
from ...constants import BRANCH_H, BUS_H, DEV_H, STATE_VARIABLES  # noqa: F401
