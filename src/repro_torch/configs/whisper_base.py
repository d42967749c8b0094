"""--arch whisper-base (see registry for the full spec)."""
from .registry import ARCHS

CONFIG = ARCHS["whisper-base"]
