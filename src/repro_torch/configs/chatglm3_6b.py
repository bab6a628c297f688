"""Selectable config module for --arch (see registry.py for the
full annotated definition and source citation)."""
from .registry import CHATGLM3_6B, SMOKE

CONFIG = CHATGLM3_6B
SMOKE_CONFIG = SMOKE[CONFIG.name]
