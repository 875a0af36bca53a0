"""Optimization-trajectory PCA (port of
``physicsbasedfwi2_tpu/landscape/projection.py``).

Project checkpointed weight trajectories onto their top principal
directions for plotting over the loss surface (the reference's
``projection.py`` and ``plot_trajectory.py``).  A parameter set is a dict
of tensors (or arrays) by the port's parameter names; it flattens in the
dict's order, which need not be the JAX package's (its leaves sort by
Flax path): PCA coordinates and explained ratios do not depend on the
order.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np
import torch

from physicsbasedfwi2_tpu_torch.models.convert import state_dict_from_npz


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _flatten(params) -> np.ndarray:
    return np.concatenate([_np(leaf).ravel() for leaf in params.values()])


def trajectory_pca(param_history, *, n_components: int = 2):
    """PCA of a list of parameter dicts (training checkpoints).

    Returns (coords [n_ckpt, n_components], explained_ratio,
    components [n_components, dim])."""
    X = np.stack([_flatten(p) for p in param_history])
    X = X - X[-1]  # center on the final point (reference convention)
    U, S, Vt = np.linalg.svd(X, full_matrices=False)
    coords = U[:, :n_components] * S[:n_components]
    var = S ** 2
    explained = var[:n_components] / (var.sum() + 1e-30)
    return coords, explained, Vt[:n_components]


def unflatten_like(vec: np.ndarray, params) -> dict[str, torch.Tensor]:
    """Inverse of :func:`_flatten`: a flat vector as a dict of float32
    tensors with ``params``' names, shapes and devices (the reference's
    ``npvec_to_tensorlist`` role)."""
    out, k = {}, 0
    for name, leaf in params.items():
        shape = tuple(leaf.shape)
        size = int(np.prod(shape))
        dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
        out[name] = torch.as_tensor(
            np.asarray(vec[k:k + size], np.float32).reshape(shape),
            device=dev)
        k += size
    if k != vec.size:
        raise ValueError(f"vector has {vec.size} entries, params "
                         f"need {k}")
    return out


def load_checkpoint_series(ckpt_dir: str, params_template):
    """Load an epoch-tagged ``<epoch>_net_G.npz`` checkpoint series (the
    engines' ``save_networks`` layout, written by either package) sorted
    by epoch: the reference's ``model_files`` list.  Returns (epoch_tags,
    [dicts of float32 numpy arrays with ``params_template``'s names, in
    its order])."""
    files = []
    for p in glob.glob(os.path.join(ckpt_dir, "*_net_G.npz")):
        m = re.match(r"(\d+)_net_G\.npz$", os.path.basename(p))
        if m:
            files.append((int(m.group(1)), p))
    files.sort()
    if len(files) < 3:
        raise FileNotFoundError(
            f"{ckpt_dir}: need >=3 epoch-tagged *_net_G.npz "
            f"checkpoints for a trajectory, found {len(files)}")
    series = []
    for _, path in files:
        with np.load(path) as z:
            sd = state_dict_from_npz({k: z[k] for k in z.files})
        entry = {}
        for name, leaf in params_template.items():
            a = sd[name].numpy().astype(np.float32)
            if a.shape != tuple(leaf.shape):
                raise ValueError(f"{path}: {name} has shape {a.shape}, "
                                 f"the net {tuple(leaf.shape)}")
            entry[name] = a
        series.append(entry)
    return [e for e, _ in files], series


def project_trajectory(series, components):
    """Project each checkpoint (relative to the final one) onto the PCA
    ``components`` [n_comp, dim]: the reference's ``project_trajectory``
    by exact least squares onto orthonormal PCA directions (its
    ``proj_method='lstsq'``; the cosine-similarity variant is omitted)."""
    X = np.stack([_flatten(p) for p in series]) - _flatten(series[-1])
    return X @ np.asarray(components).T
