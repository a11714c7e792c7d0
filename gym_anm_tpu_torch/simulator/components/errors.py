"""Alias of :mod:`gym_anm_tpu_torch.errors` at the reference's import path."""

from ...errors import *  # noqa: F401,F403
from ...errors import (  # noqa: F401
    BaseMVAError,
    BranchSpecError,
    BusSpecError,
    DeviceSpecError,
    GenSpecError,
    InputNetworkFileError,
    LoadSpecError,
    PFEError,
    StorageSpecError,
    UnitConversionError,
)
