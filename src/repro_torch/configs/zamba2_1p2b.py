"""Selectable config module for --arch (see registry.py for the
full annotated definition and source citation)."""
from .registry import ZAMBA2_1P2B, SMOKE

CONFIG = ZAMBA2_1P2B
SMOKE_CONFIG = SMOKE[CONFIG.name]
