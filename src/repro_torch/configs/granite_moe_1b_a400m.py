"""--arch granite-moe-1b-a400m (see registry for the full spec)."""
from .registry import ARCHS

CONFIG = ARCHS["granite-moe-1b-a400m"]
