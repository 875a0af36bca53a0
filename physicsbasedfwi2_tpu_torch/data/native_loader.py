"""ctypes bindings for the native threaded .npy prefetch loader (port of
``physicsbasedfwi2_tpu/data/native_loader.py``).

Builds this package's ``native/npy_loader.cpp`` on demand with g++ into
``build/native/`` (:mod:`data._native_build`); falls back to pure-numpy
loading when no compiler is available so the package never
hard-depends on the native path.  Host code: it feeds the device, it
runs on none.
"""

from __future__ import annotations

import ctypes

import numpy as np

from physicsbasedfwi2_tpu_torch.data._native_build import load_native_lib

_lib = None
_lib_tried = False


def _get_lib():
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    lib = load_native_lib("npy_loader.cpp", extra_flags=("-O3", "-lpthread"))
    if lib is None:
        return None
    try:
        lib.npy_loader_create.restype = ctypes.c_void_p
        lib.npy_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.npy_loader_next.restype = ctypes.c_int
        lib.npy_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.npy_loader_destroy.argtypes = [ctypes.c_void_p]
    except AttributeError:
        # a cached .so missing symbols: honor the documented
        # None-on-ANY-failure contract (numpy fallback engages)
        return None
    _lib = lib
    return lib


def native_available() -> bool:
    return _get_lib() is not None


class PrefetchNpyLoader:
    """Iterate float32 arrays from .npy paths with background
    prefetch. Falls back to numpy if the native lib is unavailable."""

    def __init__(self, paths, *, n_threads: int = 4, capacity: int = 8,
                 max_elems: int = 64 * 1024 * 1024):
        self.paths = list(paths)
        self._lib = _get_lib()
        self._i = 0
        self.max_elems = max_elems
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._h = self._lib.npy_loader_create(
                arr, len(self.paths), n_threads, capacity)
        else:
            self._h = None

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._i >= len(self.paths):
            raise StopIteration
        self._i += 1
        if self._h is None:
            return np.load(self.paths[self._i - 1]).astype(np.float32)
        buf = np.empty(self.max_elems, np.float32)
        shape = (ctypes.c_int64 * 8)()
        n = ctypes.c_int64()
        nd = self._lib.npy_loader_next(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.max_elems, shape, ctypes.byref(n))
        if nd < 0:
            raise IOError(
                f"native loader failed on {self.paths[self._i - 1]} "
                f"(code {nd})")
        out_shape = tuple(int(shape[i]) for i in range(nd))
        return buf[: n.value].reshape(out_shape).copy()

    def close(self):
        if self._h is not None and self._lib is not None:
            self._lib.npy_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
