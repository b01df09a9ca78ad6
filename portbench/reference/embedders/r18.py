"""IResNet-18: the IResNet of ``r50.py`` at the depths the configuration
states."""

from __future__ import annotations

from .r50 import build  # noqa: F401
