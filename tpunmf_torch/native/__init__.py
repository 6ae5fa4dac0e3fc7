"""Native (C++) host code: the CSR panelizer of the out-of-core path.

Built with ``g++`` at first use (``loader.py``); a scipy path keeps the
panel API working where no compiler exists, and says that it was taken.
"""
from .loader import get_panelizer, native_available

__all__ = ["get_panelizer", "native_available"]
