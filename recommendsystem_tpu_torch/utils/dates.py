"""Day-incremental training utilities.

Counterpart of ``recommendsystem_tpu/utils/dates.py``, the same pure
Python.  The reference imports ``trained_delta_days`` from its absent platform
(``rank/multi_head/model.py:9``) — day-partitioned incremental training
state.  These helpers supply that contract: enumerate the partition days
between the last trained day and today, for feeding
``data.loader.list_files(days=...)``.
"""

from __future__ import annotations

import datetime
from typing import List, Optional


def _parse(day: str) -> datetime.date:
    return datetime.datetime.strptime(day, "%Y%m%d").date()


def date_range(start_day: str, end_day: str) -> List[str]:
    """Inclusive list of YYYYMMDD days."""
    start, end = _parse(start_day), _parse(end_day)
    out = []
    d = start
    while d <= end:
        out.append(d.strftime("%Y%m%d"))
        d += datetime.timedelta(days=1)
    return out


def trained_delta_days(last_trained_day: Optional[str],
                       today: Optional[str] = None,
                       max_days: int = 30) -> List[str]:
    """Days still to train, oldest first: (last_trained_day, today].

    ``last_trained_day=None`` -> the trailing ``max_days`` window.
    """
    end = _parse(today) if today else datetime.date.today()
    if last_trained_day is None:
        start = end - datetime.timedelta(days=max_days - 1)
    else:
        start = _parse(last_trained_day) + datetime.timedelta(days=1)
    if start > end:
        return []
    days = date_range(start.strftime("%Y%m%d"), end.strftime("%Y%m%d"))
    return days[-max_days:]
