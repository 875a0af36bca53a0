"""Data-misfit functions (port of ``physicsbasedfwi2_tpu/ops/misfit.py``).

Direct-wave removal by subtracting a constant-model simulation,
per-trace max normalization, the L1/L2/Huber misfits and the
frequency-continuation low-pass.  ``torch.amax`` splits its gradient
evenly among tied maxima, as ``jnp.max`` does.
"""

from __future__ import annotations

import torch

from physicsbasedfwi2_tpu_torch.geo.filters import lowpass_filter_time


def trace_normalize(d: torch.Tensor, *, time_axis: int = 1,
                    eps: float = 1e-10) -> torch.Tensor:
    """Divide each trace by its max |amplitude| over time.

    Layout [shots, nt, receivers], so the reduction runs over
    ``time_axis``.
    """
    m = torch.amax(torch.abs(d), dim=time_axis, keepdim=True)
    return d / (m + eps)


def l1_misfit(pred: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """mean |pred - obs|, with the derivative 1 at a zero residual, as
    ``jnp.abs`` differentiates (``torch.abs`` gives 0 there)."""
    r = pred - obs
    return torch.mean(torch.where(r >= 0, r, -r))


def l2_misfit(pred: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - obs) ** 2)


def huber_misfit(pred: torch.Tensor, obs: torch.Tensor,
                 delta: float = 1.0) -> torch.Tensor:
    r = pred - obs
    a = torch.abs(r)
    return torch.mean(torch.where(a <= delta, 0.5 * r * r,
                                  delta * (a - 0.5 * delta)))


def normalized_trace_misfit(pred, obs_norm, direct=None, *, kind: str = "l1",
                            fc: float | None = None, dt: float | None = None):
    """The reference's full data-loss pipeline, pred/obs layout
    [shots, nt, receivers]: subtract ``direct`` (the constant-model
    direct arrival) from pred, trace-normalize, optionally low-pass
    both sides at ``fc`` Hz, then L1/L2/Huber against the
    already-normalized observations ``obs_norm``."""
    if direct is not None:
        pred = pred - direct
    pred = trace_normalize(pred)
    if fc is not None and fc > 0:
        if dt is None:
            raise ValueError("normalized_trace_misfit: fc needs dt")
        pred = lowpass_filter_time(pred, fc, dt, axis=1)
        obs_norm = lowpass_filter_time(obs_norm, fc, dt, axis=1)
    if kind == "l1":
        return l1_misfit(pred, obs_norm)
    if kind == "l2":
        return l2_misfit(pred, obs_norm)
    if kind == "huber":
        return huber_misfit(pred, obs_norm)
    raise ValueError(f"unknown misfit kind {kind!r}")
