"""Small helpers of the port: the day arithmetic of the daily trainer."""

from .dates import date_range, trained_delta_days  # noqa: F401
