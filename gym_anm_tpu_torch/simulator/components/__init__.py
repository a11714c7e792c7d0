"""Namespace compatibility with ``gym_anm.simulator.components``.

User code importing column maps, the state-variable registry, spec error
types, or the component view classes from the reference's paths keeps
working against this package.
"""

from ...constants import BRANCH_H, BUS_H, DEV_H, STATE_VARIABLES, headers_branch, headers_bus, headers_dev
from ...errors import (
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
from ..facade import BranchView as TransmissionLine
from ..facade import BusView as Bus
from ..facade import DeviceView as Device

__all__ = [
    "BUS_H",
    "DEV_H",
    "BRANCH_H",
    "STATE_VARIABLES",
    "headers_bus",
    "headers_dev",
    "headers_branch",
    "Bus",
    "Device",
    "TransmissionLine",
    "InputNetworkFileError",
    "BaseMVAError",
    "BranchSpecError",
    "BusSpecError",
    "DeviceSpecError",
    "GenSpecError",
    "LoadSpecError",
    "StorageSpecError",
    "PFEError",
    "UnitConversionError",
]
