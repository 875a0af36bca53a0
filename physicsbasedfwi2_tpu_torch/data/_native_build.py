"""Build-on-demand helper for the C++ host libraries (port of
``physicsbasedfwi2_tpu/data/_native_build.py``).

Used by :mod:`data.native_loader` (threaded npy prefetch) and
:mod:`data.native_su` (SU trace reader).  The sources are this
package's ``native/*.cpp``; ``g++`` compiles each into ``build/native/``
at the root of the checkout (git-ignored; under ``PBFWI_TORCH_BUILD_DIR``
when that is set), under a name that carries a hash of the source and
the flags, so an edited source is rebuilt.  Callers get None on ANY
failure, so their numpy fallbacks always engage:

- compiles to a temp file and atomically renames it, so a concurrent
  process never dlopens a half-written .so;
- wraps `ctypes.CDLL` itself (a corrupt cached object returns None
  instead of raising);
- tolerates a missing source file or compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
_build_lock = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("PBFWI_TORCH_BUILD_DIR")
    root = (Path(env) if env else
            Path(__file__).resolve().parents[2] / "build")
    return root / "native"


def load_native_lib(src_name: str, extra_flags: tuple = ()):
    """Build (if not built) and dlopen native/<src_name> -> CDLL or
    None."""
    src = _NATIVE_DIR / src_name
    flags = ("-O2", "-shared", "-fPIC", "-std=c++17", *extra_flags)
    with _build_lock:
        try:
            h = hashlib.sha256(src.read_bytes())
        except OSError:
            return None
        h.update(" ".join(flags).encode())
        so = build_dir() / f"lib{src.stem}_{h.hexdigest()[:16]}.so"
        if not so.exists():
            tmp = so.with_name(so.name + f".tmp{os.getpid()}")
            try:
                so.parent.mkdir(parents=True, exist_ok=True)
                subprocess.run(["g++", *flags[:4], "-o", str(tmp), str(src),
                                *flags[4:]], check=True, capture_output=True)
                os.replace(tmp, so)  # atomic: readers see old or new
            except (OSError, subprocess.CalledProcessError):
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                return None
        try:
            return ctypes.CDLL(str(so))
        except OSError:
            return None
