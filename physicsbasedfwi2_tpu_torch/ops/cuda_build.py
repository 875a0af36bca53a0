"""Build and load the hand-written CUDA kernels of ``csrc/``.

``nvcc`` compiles ``csrc/scalar2.cu`` for ``sm_90a`` into a shared
library with a plain C interface, which ``ctypes`` loads.  The build
runs at first use, never at import, into ``build/torch_kernels/`` at
the root of the checkout (git-ignored; ``PBFWI_TORCH_BUILD_DIR``
overrides it).  The library's file name carries a hash of the source,
so an edited source is rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_SOURCE = _CSRC / "scalar2.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of csrc/scalar2.cu's entry points (pointers, then ints)
_SIGNATURES = {
    "b1_forward2": [_P] * 10 + [_I] * 4 + [_P],
    "b2_fwi_l1_loss_grad": [_P] * 22 + [_I] * 6 + [_F, _P],
}

_lib = None


def build_dir() -> Path:
    env = os.environ.get("PBFWI_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


def library_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    return build_dir() / f"libpbfwi_scalar2_{digest}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "CUDA kernels cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> tuple[Path, float, str]:
    """Compile the kernels if the library for this source is missing.

    Returns (library path, build seconds, nvcc's ptxas report); the
    seconds are 0 and the report empty when the library already
    existed.  Writes to a temporary name and renames, so a concurrent
    build never loads a half-written library.
    """
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(_SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0, proc.stderr


def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first call and loaded once."""
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.pbfwi_error_string.argtypes = [ctypes.c_int]
        lib.pbfwi_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = load_library().pbfwi_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
