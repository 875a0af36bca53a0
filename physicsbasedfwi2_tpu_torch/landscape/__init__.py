"""Loss-landscape analysis (port of ``physicsbasedfwi2_tpu/landscape``).

Li et al. (NIPS'18) adapted to FWI: filter-normalized random
directions, 2D loss surfaces over the *physics* misfit, Hessian
eigenvalue estimates from exact Hessian-vector products, trajectory PCA
and ParaView export; ``loss_surface_2d_sharded`` sweeps a surface over the
ranks of a mesh (``parallel/``).
"""

from physicsbasedfwi2_tpu_torch.landscape.surface import (
    filter_normalized_direction, loss_surface_2d, loss_surface_2d_sharded,
    normalize_direction, output_axes, perturb_params,
)
from physicsbasedfwi2_tpu_torch.landscape.hessian import (
    composite_hvp, hvp, lanczos_extreme_eigs,
)
from physicsbasedfwi2_tpu_torch.landscape.projection import trajectory_pca
from physicsbasedfwi2_tpu_torch.landscape.vtp import surface_to_vtp

__all__ = [
    "filter_normalized_direction",
    "normalize_direction",
    "output_axes",
    "perturb_params",
    "loss_surface_2d",
    "loss_surface_2d_sharded",
    "hvp",
    "composite_hvp",
    "lanczos_extreme_eigs",
    "trajectory_pca",
    "surface_to_vtp",
]
