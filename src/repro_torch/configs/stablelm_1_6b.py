"""--arch stablelm-1.6b (see registry for the full spec)."""
from .registry import ARCHS

CONFIG = ARCHS["stablelm-1.6b"]
