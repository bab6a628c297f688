"""Selectable config module for --arch (see registry.py for the
full annotated definition and source citation)."""
from .registry import INTERNVL2_1B, SMOKE

CONFIG = INTERNVL2_1B
SMOKE_CONFIG = SMOKE[CONFIG.name]
