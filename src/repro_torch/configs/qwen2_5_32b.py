"""--arch qwen2.5-32b (see registry for the full spec)."""
from .registry import ARCHS

CONFIG = ARCHS["qwen2.5-32b"]
