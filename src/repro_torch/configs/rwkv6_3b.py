"""Selectable config module for --arch (see registry.py for the
full annotated definition and source citation)."""
from .registry import RWKV6_3B, SMOKE

CONFIG = RWKV6_3B
SMOKE_CONFIG = SMOKE[CONFIG.name]
