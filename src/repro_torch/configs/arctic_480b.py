"""Selectable config module for --arch (see registry.py for the
full annotated definition and source citation)."""
from .registry import ARCTIC_480B, SMOKE

CONFIG = ARCTIC_480B
SMOKE_CONFIG = SMOKE[CONFIG.name]
