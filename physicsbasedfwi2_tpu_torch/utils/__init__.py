"""Misc utilities (diagnostics).

The JAX package's ``utils/cache.py`` (its persistent compile cache) has
no counterpart: the port compiles no graphs ahead of a run, and its
CUDA kernels are cached by ``ops/cuda_build.py``.
"""

from physicsbasedfwi2_tpu_torch.utils.diagnostics import (
    diagnose_params, grad_norms, is_legal,
)

__all__ = ["diagnose_params", "is_legal", "grad_norms"]
