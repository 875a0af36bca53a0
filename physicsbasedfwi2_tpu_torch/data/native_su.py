"""ctypes binding for the native SU trace reader (port of
``physicsbasedfwi2_tpu/data/native_su.py``).

This package's ``native/su_reader.cpp`` builds on demand through the
shared helper (:mod:`data._native_build`); callers fall back to the
pure-numpy parser in :mod:`data.prep` when no compiler / a broken cache
is present, so the package never hard-depends on the native path.
``native_reads`` counts the files the native parser read.
"""

from __future__ import annotations

import ctypes

import numpy as np

from physicsbasedfwi2_tpu_torch.data._native_build import load_native_lib

_lib = None
_lib_tried = False
native_reads = 0


def _get_lib():
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    lib = load_native_lib("su_reader.cpp")
    if lib is None:
        return None
    try:
        lib.su_parse.restype = ctypes.POINTER(ctypes.c_float)
        lib.su_parse.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int)]
        lib.su_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    except AttributeError:  # stale .so missing the symbols
        return None
    _lib = lib
    return lib


def native_available() -> bool:
    return _get_lib() is not None


def read_su_native(path: str):
    """([ntraces, ns] float32, dt_seconds) via the C++ parser (one
    file read), or None when the native library is unavailable;
    raises ValueError on malformed files (mirroring the numpy
    parser's contract)."""
    lib = _get_lib()
    if lib is None:
        return None
    ntr = ctypes.c_int64()
    ns = ctypes.c_int64()
    dt_us = ctypes.c_int64()
    rc = ctypes.c_int()
    buf = lib.su_parse(path.encode(), ctypes.byref(ntr),
                       ctypes.byref(ns), ctypes.byref(dt_us),
                       ctypes.byref(rc))
    if not buf:
        if rc.value == -1:
            raise ValueError(f"{path}: unreadable / too short for SU")
        if rc.value == -2:
            raise ValueError(f"{path}: no byte order yields a whole "
                             "number of consistent SU traces")
        raise ValueError(f"{path}: SU parse failed (rc={rc.value})")
    try:
        out = np.ctypeslib.as_array(
            buf, shape=(ntr.value, ns.value)).copy()
    finally:
        lib.su_free(buf)
    global native_reads
    native_reads += 1
    return out, dt_us.value * 1e-6
