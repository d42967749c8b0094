from .registry import ARCHS, get, names
from .shapes import SHAPES, ShapeSpec, cells, runnable

__all__ = ["ARCHS", "get", "names", "SHAPES", "ShapeSpec", "cells", "runnable"]
