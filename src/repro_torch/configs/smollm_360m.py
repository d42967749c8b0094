"""--arch smollm-360m (see registry for the full spec)."""
from .registry import ARCHS

CONFIG = ARCHS["smollm-360m"]
