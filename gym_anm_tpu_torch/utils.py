"""Small utilities (mirrors the reference's gym_anm/utils.py surface)."""

import os


def get_package_root() -> str:
    """Absolute path of the installed gym_anm_tpu_torch package directory."""
    return os.path.dirname(os.path.abspath(__file__))
