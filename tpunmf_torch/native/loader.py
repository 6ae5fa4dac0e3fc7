"""ctypes loader of the native panelizer, which it compiles at first use.

Compiles ``panelize.cpp`` with ``g++`` into ``_build/`` beside this file
(not committed), and again whenever the source is newer than the
library, as ``tpunmf/native/loader.py`` does; for the baseline of the
host's architecture (no ``-march=native``), so that a built library
stays valid on another machine.  Where no compiler works,
``get_panelizer()`` returns None and ``data/sparse_panels.py`` takes its
scipy path; it records which path it took (``PanelStream.native``), and
``build_error`` keeps the compiler's message.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "panelize.cpp")
_SO = os.path.join(_HERE, "_build", "_panelize.so")

_lock = threading.Lock()
_lib = None
_failed = False
build_error: str | None = None


def _build() -> bool:
    global build_error
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    # a name of this process's own, so that processes building at once
    # (test workers) never load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
           "-pthread", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=120)
    except subprocess.CalledProcessError as err:
        build_error = err.stderr or str(err)
        return False
    except (subprocess.TimeoutExpired, FileNotFoundError) as err:
        build_error = str(err)
        return False
    os.replace(tmp, _SO)
    return True


def _load():
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _build():
                _failed = True
                return None
        lib = ctypes.CDLL(_SO)
        i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
        i64p, i32p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        lib.csr_panel_f32.argtypes = [i64p, i32p, f32p, i64, i64, i64, i64, f32p,
                                      ctypes.c_int]
        lib.csr_panel_f32.restype = None
        lib.csr_panel_f32_batch.argtypes = [i64p, i32p, f32p, i64, i64, i64, i64, i64,
                                            f32p, ctypes.c_int]
        lib.csr_panel_f32_batch.restype = None
        lib.csr_panel_nnz.argtypes = [i64p, i32p, i64, i64, i64, i64]
        lib.csr_panel_nnz.restype = ctypes.c_int64
        lib.csr_panel_bf16.argtypes = [i64p, i32p, f32p, i64, i64, i64, i64, u16p,
                                       ctypes.c_int]
        lib.csr_panel_bf16.restype = None
        lib.csr_tile_f32.argtypes = [i64p, i32p, f32p, i64, i64, i64, i64, i64, ctypes.c_int,
                                     f32p, ctypes.c_int]
        lib.csr_tile_f32.restype = None
        lib.csr_tile_bf16.argtypes = [i64p, i32p, f32p, i64, i64, i64, i64, i64, ctypes.c_int,
                                      u16p, ctypes.c_int]
        lib.csr_tile_bf16.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def get_panelizer():
    """The loaded ctypes library, or None where it could not be built."""
    return _load()
