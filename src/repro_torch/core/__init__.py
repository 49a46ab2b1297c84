"""Core building blocks of the PyTorch port (only the compile cache so far)."""
from .cache import CompileCache

__all__ = ["CompileCache"]
