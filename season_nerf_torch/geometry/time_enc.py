"""Calendar dates to year fractions."""

from __future__ import annotations

from datetime import datetime


def year_frac_from_month_day(month, day, year=2015):
    """MM/DD -> day-of-year / days-in-year (the reference's convention)."""
    yday = datetime(year, month, day).timetuple().tm_yday
    ydays = datetime(year, 12, 31).timetuple().tm_yday
    return yday / ydays
