"""--arch internvl2-26b (see registry for the full spec)."""
from .registry import ARCHS

CONFIG = ARCHS["internvl2-26b"]
