"""Selectable config module for --arch (see registry.py for the
full annotated definition and source citation)."""
from .registry import DEEPSEEK_CODER_33B, SMOKE

CONFIG = DEEPSEEK_CODER_33B
SMOKE_CONFIG = SMOKE[CONFIG.name]
