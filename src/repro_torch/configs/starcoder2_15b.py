"""Selectable config module for --arch (see registry.py for the
full annotated definition and source citation)."""
from .registry import STARCODER2_15B, SMOKE

CONFIG = STARCODER2_15B
SMOKE_CONFIG = SMOKE[CONFIG.name]
