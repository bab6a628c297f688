"""Selectable config module for --arch (see registry.py for the
full annotated definition and source citation)."""
from .registry import LLAMA3_8B, SMOKE

CONFIG = LLAMA3_8B
SMOKE_CONFIG = SMOKE[CONFIG.name]
