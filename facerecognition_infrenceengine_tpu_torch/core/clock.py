"""Timestamps for store documents."""

from __future__ import annotations

import datetime


def get_current_utc() -> datetime.datetime:
    """UTC now, naive: the form every ``lastUpdated`` in the store takes, so
    the gallery's ``$gte`` watermark compares like with like (a tz-aware
    value matches no naive one)."""
    return datetime.datetime.now(datetime.timezone.utc).replace(tzinfo=None)
