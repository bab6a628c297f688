"""Selectable config module for --arch (see registry.py for the
full annotated definition and source citation)."""
from .registry import WHISPER_LARGE_V3, SMOKE

CONFIG = WHISPER_LARGE_V3
SMOKE_CONFIG = SMOKE[CONFIG.name]
