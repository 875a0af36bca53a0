"""Build and load the hand-written CUDA kernels of ``csrc/``.

``nvcc`` compiles each source of ``csrc/`` (``scalar2.cu``: kernels B1,
B2, B4a and B4b, B7a's and B7b's resident route, and B9's variants of the
resident forward sweep; ``elastic.cu``:
kernel B3 and the ring forward, which B8 runs with no free-surface row;
``acoustic.cu``: kernels B5 and B6; ``scalar2b.cu``: B7a's and B7b's
per-step route; ``cluster.cuh``: the helpers of the resident routes,
included by ``scalar2.cu``, ``elastic.cu`` and ``acoustic.cu``) for
``sm_90a``, one process per source, all started together, and links
the objects into one shared library with a plain C interface, which
``ctypes`` loads.
The build runs at first use, never at import, into
``build/torch_kernels/`` at the root of the checkout (git-ignored; ``PBFWI_TORCH_BUILD_DIR``
overrides it).  The library's file name carries a hash of the sources,
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
SOURCES = tuple(_CSRC / f for f in ("scalar2.cu", "elastic.cu", "acoustic.cu",
                                     "scalar2b.cu"))
# headers the sources include (the thread-block cluster helpers)
HEADERS = (_CSRC / "cluster.cuh",)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the entry points (pointers, then ints and floats)
_SIGNATURES = {
    # csrc/scalar2.cu
    "b1_forward2": [_P] * 10 + [_I] * 4 + [_P],
    "b2_fwi_l1_loss_grad": [_P] * 23 + [_I] * 6 + [_F, _P],
    "b4a_forward2_ckpt": [_P] * 11 + [_I] * 6 + [_P],
    "b4b_backward2": [_P] * 17 + [_I] * 5 + [_P],
    # the resident route of the same four (sizes, then the plan)
    "b1_forward2_resident": [_P] * 8 + [_I] * 9 + [_P],
    "b2_fwi_l1_loss_grad_resident": [_P] * 18 + [_I] * 11 + [_F, _P],
    "b4a_forward2_ckpt_resident": [_P] * 9 + [_I] * 11 + [_P],
    "b4b_backward2_resident": [_P] * 12 + [_I] * 10 + [_P],
    # B7a and B7b's resident route: B4's sweeps, checkpoints in pairs
    "b7a_forward2b_resident": [_P] * 9 + [_I] * 11 + [_P],
    "b7b_backward2b_resident": [_P] * 12 + [_I] * 10 + [_P],
    "pbfwi_resident_max_clusters": [_I] * 10 + [ctypes.POINTER(_I)],
    # B9: a variant of B2's forward sweep (resident only)
    "b9_variant_resident": [_P] * 12 + [_I] * 12 + [_P],
    # csrc/elastic.cu
    "b3_elastic_ring": [_P] * 9 + [_I] * 6 + [_F, _P],
    "b3_fused_elastic_loss_grad": [_P] * 19 + [_I] * 8 + [_F] * 3 + [_P],
    # its resident route (sizes, then the plan)
    "b3_fused_elastic_loss_grad_resident": [_P] * 17 + [_I] * 13
    + [_F] * 3 + [_P],
    "pbfwi_b3_max_clusters": [_I] * 9 + [ctypes.POINTER(_I)],
    # the ring forward's (and B8's) resident route
    "b3_elastic_ring_resident": [_P] * 8 + [_I] * 11 + [_F, _P],
    "pbfwi_ring_max_clusters": [_I] * 8 + [ctypes.POINTER(_I)],
    # csrc/acoustic.cu
    "b5_acoustic_forward": [_P] * 11 + [_I] * 4 + [_F, _P],
    "b6_checkpoints": [_P] * 11 + [_I] * 5 + [_F, _P],
    "b6_adjoint": [_P] * 18 + [_I] * 5 + [_F, _P],
    # their resident route (sizes, then the plan)
    "b5_acoustic_forward_resident": [_P] * 8 + [_I] * 9 + [_F, _P],
    "b6_checkpoints_resident": [_P] * 8 + [_I] * 10 + [_F, _P],
    "b6_adjoint_resident": [_P] * 15 + [_I] * 10 + [_F, _P],
    "pbfwi_b56_max_clusters": [_I] * 9 + [ctypes.POINTER(_I)],
    # csrc/scalar2b.cu (B7's per-step route)
    "b7a_forward2b": [_P] * 11 + [_I] * 6 + [_P],
    "b7b_backward2b": [_P] * 17 + [_I] * 5 + [_P],
}

_lib = None


def build_dir() -> Path:
    env = os.environ.get("PBFWI_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    return build_dir() / f"libpbfwi_kernels_{h.hexdigest()[:16]}.so"


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
    existed.  Writes to temporary names and renames, so a concurrent
    build never loads a half-written library.
    """
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    nvcc = _nvcc()
    objs = [out.with_name(f"{src.stem}.{tag}.o") for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = []
    for src, proc in zip(SOURCES, procs):
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"({proc.returncode}):\n{stdout}\n{stderr}")
        logs.append(f"{src.name}:\n{stderr}")
    tmp = out.with_name(f"{out.name}.{tag}")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stdout}\n{link.stderr}")
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)
    return out, time.perf_counter() - t0, "\n".join(logs)


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


def call(device, name: str, *args) -> None:
    """Call the C entry point ``name`` with ``device`` the current CUDA
    device (the entry points launch on the current device and ask it
    about occupancy; None keeps the current one), and raise on the error
    code it returns."""
    import torch
    with torch.cuda.device(device):
        err = getattr(load_library(), name)(*args)
    check(err, name)


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = load_library().pbfwi_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
