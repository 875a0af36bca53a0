"""Filter-normalized loss surfaces (port of
``physicsbasedfwi2_tpu/landscape/surface.py``).

The reference's ``net_plotter.py`` (filter-wise normalized random
directions) and ``plot_surface2.py``'s ``crunch2`` (a grid of (x, y)
points, each evaluating the full physics data misfit).  Here the grid is
swept point by point on one device without autograd, the losses copied
to the host every ``batch`` points, or (:func:`loss_surface_2d_sharded`)
split over the ranks of a mesh.

Parameters, directions and perturbed parameters are dicts of tensors by
the port's parameter names (``dict(net.named_parameters())``); a loss
function applies them with ``torch.func.functional_call``.
"""

from __future__ import annotations

import numpy as np
import torch


def output_axes(net: torch.nn.Module) -> dict[str, int]:
    """Each parameter's output axis by module type: 0 for the weights
    of ``Conv*d`` and ``Linear``, 1 for ``ConvTranspose*d``, the last
    axis for any other parameter (the layout ``models/convert.py`` keeps
    for the leaves it does not transpose)."""
    nn = torch.nn
    transposed = (nn.ConvTranspose1d, nn.ConvTranspose2d, nn.ConvTranspose3d)
    forward = (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear)
    out = {}
    for mname, mod in net.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if pname == "weight" and isinstance(mod, transposed):
                out[name] = 1
            elif pname == "weight" and isinstance(mod, forward):
                out[name] = 0
            else:
                out[name] = p.ndim - 1
    return out


def _out_axis(name: str, w: torch.Tensor, out_axes) -> int:
    if out_axes is not None:
        return out_axes[name]
    # models/convert.py turns every Flax kernel (output axis last) into a
    # "weight" with the output axis first; other leaves keep their layout
    return 0 if name.rsplit(".", 1)[-1] == "weight" else w.ndim - 1


def normalize_direction(direction, params, *, norm: str = "filter",
                        out_axes=None):
    """Rescale ``direction`` to ``params``' norms: with "filter" each
    output filter of a weight of >= 2 dims to the norm of the weight's
    filter (the norm over every axis but the output one), with "layer",
    and for 1-D leaves, each tensor to the weight's norm.  A weight's
    output axis comes from ``out_axes`` (:func:`output_axes`) or, without
    it, from its name as ``models/convert.py`` lays the weights out: a
    direction carried across from the JAX package by the converter comes
    back unchanged."""
    out = {}
    for name, w in params.items():
        d = direction[name].to(torch.float32)
        w32 = w.detach().to(torch.float32)
        if norm == "filter" and w.ndim >= 2:
            ax = _out_axis(name, w, out_axes) % w.ndim
            axes = tuple(i for i in range(w.ndim) if i != ax)
            wn = torch.sqrt(torch.sum(w32 ** 2, dim=axes, keepdim=True))
            dn = torch.sqrt(torch.sum(d ** 2, dim=axes, keepdim=True))
            d = d * wn / (dn + 1e-10)
        elif norm == "layer" or w.ndim < 2:
            d = d * torch.linalg.vector_norm(w32) / (
                torch.linalg.vector_norm(d) + 1e-10)
        out[name] = d.to(w.dtype)
    return out


def filter_normalized_direction(params, generator=None, *,
                                norm: str = "filter", out_axes=None):
    """A random direction with per-filter norm matched to the weights
    (``net_plotter``'s 'filter' normalization, see
    :func:`normalize_direction`).  The normal draws come from
    ``generator`` (a ``torch.Generator``; default seed 0), one leaf after
    another in ``params``' order, on the generator's device."""
    gen = generator if generator is not None else (
        torch.Generator().manual_seed(0))
    raw = {name: torch.randn(tuple(w.shape), generator=gen,
                             device=gen.device).to(w.device)
           for name, w in params.items()}
    return normalize_direction(raw, params, norm=norm, out_axes=out_axes)


def perturb_params(params, d1, d2, x: float, y: float):
    """w + x*d1 + y*d2 (``net_plotter``'s ``set_weights`` role)."""
    return {k: w + x * d1[k] + y * d2[k] for k, w in params.items()}


def loss_surface_2d(loss_fn, params, *, generator=None, d1=None, d2=None,
                    xs=None, ys=None, norm: str = "filter", batch: int = 8,
                    data=None, out_axes=None):
    """Evaluate loss_fn(params + x d1 + y d2) over a grid.

    Args:
        loss_fn: params -> scalar tensor (typically the physics data
            misfit).  When ``data`` is given, called as
            ``loss_fn(params, data)``.
        params: dict of tensors by name.
        generator: draws ``d1`` then ``d2`` where they are not given.
        xs, ys: 1D coordinate arrays (default 21 points in [-1, 1]); the
            points are taken in float32, as the JAX package takes them.
        batch: points between two copies of the losses to the host.
        data: optional large inputs (observed gathers, net inputs),
            passed to ``loss_fn`` as its second argument.
        out_axes: the weights' output axes for the "filter" norm
            (:func:`output_axes`).

    Returns:
        (losses [len(ys), len(xs)] as numpy, d1, d2)
    """
    if xs is None:
        xs = np.linspace(-1, 1, 21)
    if ys is None:
        ys = np.linspace(-1, 1, 21)
    if d1 is None or d2 is None:
        gen = generator if generator is not None else (
            torch.Generator().manual_seed(0))
        d1 = filter_normalized_direction(params, gen, norm=norm,
                                         out_axes=out_axes)
        d2 = filter_normalized_direction(params, gen, norm=norm,
                                         out_axes=out_axes)
    gx, gy = np.meshgrid(xs, ys)
    coords = np.stack([gx.ravel(), gy.ravel()], 1).astype(np.float32)
    params = {k: w.detach() for k, w in params.items()}
    losses, pending = [], []
    with torch.no_grad():
        for i, (x, y) in enumerate(coords):
            p = perturb_params(params, d1, d2, float(x), float(y))
            pending.append(loss_fn(p) if data is None else loss_fn(p, data))
            if len(pending) == batch or i == len(coords) - 1:
                losses.append(torch.stack(pending).cpu().numpy())
                pending = []
    flat = np.concatenate(losses)
    return flat.reshape(len(ys), len(xs)), d1, d2


def loss_surface_2d_sharded(loss_fn, params, mesh, *, generator=None,
                            d1=None, d2=None, xs=None, ys=None,
                            norm: str = "filter", axis: str = "shot",
                            data=None, out_axes=None):
    """:func:`loss_surface_2d` with the grid points sharded over ``axis``
    of a rank mesh (``parallel.make_mesh``): the reference's mpi4py
    rank-partitioned ``crunch2`` (plot_surface2.py:156-229).  The points,
    padded with (0, 0) to a multiple of the axis, are split into
    contiguous blocks; each rank evaluates its block without autograd,
    and one all-gather gives every rank the whole surface.  Every rank
    must hold the same ``params``, directions and data (the directions
    drawn from ``generator``, default seed 0, are).  Returns (losses
    [len(ys), len(xs)] as numpy, d1, d2)."""
    from physicsbasedfwi2_tpu_torch.parallel import all_gather
    from physicsbasedfwi2_tpu_torch.parallel.shard import shot_block
    if xs is None:
        xs = np.linspace(-1, 1, 21)
    if ys is None:
        ys = np.linspace(-1, 1, 21)
    if d1 is None or d2 is None:
        gen = generator if generator is not None else (
            torch.Generator().manual_seed(0))
        d1 = filter_normalized_direction(params, gen, norm=norm,
                                         out_axes=out_axes)
        d2 = filter_normalized_direction(params, gen, norm=norm,
                                         out_axes=out_axes)
    gx, gy = np.meshgrid(xs, ys)
    coords = np.stack([gx.ravel(), gy.ravel()], 1).astype(np.float32)
    n = coords.shape[0]
    coords = np.pad(coords, ((0, (-n) % mesh.shape[axis]), (0, 0)))
    params = {k: w.detach() for k, w in params.items()}
    local = []
    with torch.no_grad():
        for x, y in coords[shot_block(mesh, axis, len(coords))]:
            p = perturb_params(params, d1, d2, float(x), float(y))
            local.append(loss_fn(p) if data is None else loss_fn(p, data))
    flat = all_gather(torch.stack(local).to(torch.float32), mesh, axis)
    flat = flat.cpu().numpy()[:n]
    return flat.reshape(len(ys), len(xs)), d1, d2
