"""--arch jamba-1.5-large-398b (see registry for the full spec)."""
from .registry import ARCHS

CONFIG = ARCHS["jamba-1.5-large-398b"]
