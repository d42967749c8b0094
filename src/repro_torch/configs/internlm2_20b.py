"""--arch internlm2-20b (see registry for the full spec)."""
from .registry import ARCHS

CONFIG = ARCHS["internlm2-20b"]
