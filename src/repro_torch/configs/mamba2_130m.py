"""--arch mamba2-130m (see registry for the full spec)."""
from .registry import ARCHS

CONFIG = ARCHS["mamba2-130m"]
