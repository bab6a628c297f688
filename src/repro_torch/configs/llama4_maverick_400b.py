"""Selectable config module for --arch (see registry.py for the
full annotated definition and source citation)."""
from .registry import LLAMA4_MAVERICK_400B, SMOKE

CONFIG = LLAMA4_MAVERICK_400B
SMOKE_CONFIG = SMOKE[CONFIG.name]
