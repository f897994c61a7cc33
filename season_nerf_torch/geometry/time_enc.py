"""Capture times, calendar dates and their periodic encodings.

The counterpart of ``season_nerf_tpu/geometry/time_enc.py``: an IMD's UTC
timestamp -> (year fraction, day fraction) -> (cos, sin) pairs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from datetime import datetime, timedelta

import numpy as np


def time_encode(year_frac, day_frac):
    """4-dim periodic encoding: (cos, sin) of the year fraction and of the
    day fraction."""
    return np.array([np.cos(2 * math.pi * np.asarray(year_frac)),
                     np.sin(2 * math.pi * np.asarray(year_frac)),
                     np.cos(2 * math.pi * np.asarray(day_frac)),
                     np.sin(2 * math.pi * np.asarray(day_frac))])


def time_encode_year_only(year_frac):
    return np.array([np.cos(2 * math.pi * np.asarray(year_frac)),
                     np.sin(2 * math.pi * np.asarray(year_frac))])


def time_frac_to_date(time_frac, use_leap_year=False):
    """Year fraction -> 'Mon. D' display string."""
    months = ["Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug",
              "Sep", "Oct", "Nov", "Dec"]
    days = 366 if use_leap_year else 365
    year = 2020 if use_leap_year else 2021
    d = datetime(year, 1, 1) + timedelta(days=days * float(time_frac))
    return f"{months[d.month - 1]}. {d.day}"


def date_to_time_frac(month: int, day: int, use_leap_year=False):
    """(month, day) -> year fraction."""
    days = 366.0 if use_leap_year else 365.0
    year = 2040 if use_leap_year else 2041
    return (datetime(year, month, day) - datetime(year, 1, 1)).days / days


def year_frac_from_month_day(month, day, year=2015):
    """MM/DD -> day-of-year / days-in-year (the reference's convention)."""
    yday = datetime(year, month, day).timetuple().tm_yday
    ydays = datetime(year, 12, 31).timetuple().tm_yday
    return yday / ydays


@dataclass
class CaptureTime:
    """A parsed UTC capture time, ``YYYY-MM-DDThh:mm:ss.ddddddZ``."""
    year: int
    month: int
    day: int
    hour: int
    minute: int
    sec: float

    @classmethod
    def parse(cls, utc_str: str) -> "CaptureTime":
        date, rest = utc_str.split("T")
        year, month, day = date.split("-")
        hour, minute, sec = rest.split(":")
        sec = sec.rstrip("Z")
        return cls(int(year), int(month), int(day), int(hour), int(minute),
                   float(sec))

    @property
    def year_frac(self) -> float:
        yday = datetime(self.year, self.month, self.day).timetuple().tm_yday
        ydays = datetime(self.year, 12, 31).timetuple().tm_yday
        return yday / ydays

    @property
    def day_frac(self) -> float:
        return ((self.hour * 60 + self.minute) * 60 + self.sec) / (24 * 60 * 60)

    def encode(self):
        return time_encode(self.year_frac, self.day_frac)

    def to_datetime(self) -> datetime:
        return datetime(self.year, self.month, self.day, self.hour,
                        self.minute, int(self.sec),
                        int((self.sec - int(self.sec)) * 1_000_000))
