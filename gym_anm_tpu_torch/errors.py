"""Exception hierarchy.

Combines the environment-level errors (reference ``gym_anm/errors.py:1-46``)
and the network-specification errors
(``gym_anm/simulator/components/errors.py:1-62``) in a single module; both
hierarchies keep the reference's class names so user except-clauses port
unchanged.
"""

from __future__ import annotations


# ---------------------------------------------------------------------------
# Environment-configuration errors (reference gym_anm/errors.py).
# ---------------------------------------------------------------------------
class ANMEnvConfigurationError(Exception):
    """Base class for exceptions relative to the construction of an ANM env."""


class ArgsError(ANMEnvConfigurationError):
    """Raised when one of the environment arguments is invalid."""


class ObsSpaceError(ANMEnvConfigurationError):
    """Raised when the observation space is not properly specified."""


class ObsNotSupportedError(ObsSpaceError):
    """Raised when an element of the observation vector is unsupported."""

    def __init__(self, wanted, allowed):
        super().__init__(
            "Observation type unsupported. Desired {} but we only support {}.".format(wanted, allowed)
        )


class UnitsNotSupportedError(ObsSpaceError):
    """Raised when the unit specified for an observation is unsupported."""

    def __init__(self, wanted, allowed, key):
        super().__init__(
            "Observation unit unsupported. Desired: {} but we only support {} for observation {}.".format(
                wanted, allowed, key
            )
        )


class EnvInitializationError(ANMEnvConfigurationError):
    """Raised when the environment encounters a problem during reset()."""


class EnvNextVarsError(ANMEnvConfigurationError):
    """Raised when something goes wrong with the next_vars() function."""


# ---------------------------------------------------------------------------
# Network-specification errors (reference simulator/components/errors.py).
# ---------------------------------------------------------------------------
class InputNetworkFileError(Exception):
    """Base class for exceptions relative to the network input dictionary."""

    def __init__(self, message=""):
        super().__init__(message)


class BaseMVAError(InputNetworkFileError):
    """Raised when the baseMVA for the network is <= 0."""

    def __init__(self):
        super().__init__("The network baseMVA should be > 0.")


class BranchSpecError(InputNetworkFileError):
    """Raised when the specs for a branch are not correctly specified."""


class BusSpecError(InputNetworkFileError):
    """Raised when the specs for a bus are not correctly specified."""


class DeviceSpecError(InputNetworkFileError):
    """Raised when the specs for a device are not correctly specified."""


class GenSpecError(DeviceSpecError):
    """Raised when the specs for a generator are not correctly specified."""


class LoadSpecError(DeviceSpecError):
    """Raised when the specs for a load are not correctly specified."""


class StorageSpecError(DeviceSpecError):
    """Raised when the specs for a storage unit are not correctly specified."""


class PFEError(Exception):
    """Raised when no solution to the network equations is found."""


class UnitConversionError(Exception):
    """Raised when a conversion between different units failed."""

    def __init__(self, old, new):
        super().__init__("Cannot convert from %s units to %s units" % (old, new))
