"""Date helper for the ANM6 rendering clock (reference anm6_env/utils.py:5-23)."""

import datetime as dt

import numpy as np


def random_date(np_random: np.random.Generator, year: int) -> dt.datetime:
    """A datetime of 00:00 on a random day within ``year``."""
    random_day = dt.timedelta(days=float(np_random.integers(1, 365)))
    return dt.datetime(year, 1, 1) + random_day
