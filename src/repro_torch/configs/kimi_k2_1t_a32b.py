"""--arch kimi-k2-1t-a32b (see registry for the full spec)."""
from .registry import ARCHS

CONFIG = ARCHS["kimi-k2-1t-a32b"]
