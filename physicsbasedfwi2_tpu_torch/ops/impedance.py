"""Impedance-domain convolutional modeling (port of
``physicsbasedfwi2_tpu/ops/impedance.py``).

Acoustic impedance Zp = vp * rho -> normal-incidence reflectivity
r = (Zp2 - Zp1) / (Zp2 + Zp1) -> a synthetic section by convolving each
trace with a Ricker wavelet.  Plain PyTorch under autograd (a conv1d and
elementwise ops).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from physicsbasedfwi2_tpu_torch.geo.wavelets import ricker
from physicsbasedfwi2_tpu_torch.ops.misfit import l1_misfit, l2_misfit


def impedance(vp: torch.Tensor, rho: torch.Tensor | None = None
              ) -> torch.Tensor:
    """Acoustic impedance; Gardner density if ``rho`` is not given."""
    if rho is None:
        rho = 310.0 * vp ** 0.25
    return vp * rho


def reflectivity(zp: torch.Tensor, *, axis: int = -2) -> torch.Tensor:
    """Normal-incidence reflectivity along depth ``axis``, the same
    length as ``zp``: a zero appended at the bottom."""
    zp = torch.movedim(zp, axis, 0)
    z1, z2 = zp[:-1], zp[1:]
    r = (z2 - z1) / (z2 + z1 + 1e-12)
    r = torch.cat([r, torch.zeros_like(r[:1])], dim=0)
    return torch.movedim(r, 0, axis)


def convolve_wavelet(refl: torch.Tensor, wavelet: torch.Tensor, *,
                     axis: int = -2) -> torch.Tensor:
    """Each trace along ``axis`` convolved with ``wavelet`` [n], the output
    as long as the trace: a true convolution (the wavelet flipped for
    ``conv1d``'s correlation), padded n // 2 before and n - 1 - n // 2
    after, as the JAX package pads."""
    r = torch.movedim(refl, axis, -1)
    shape = r.shape
    n = wavelet.shape[0]
    flat = F.pad(r.reshape(-1, 1, shape[-1]), (n // 2, n - 1 - n // 2))
    out = F.conv1d(flat, torch.flip(wavelet, (0,))[None, None, :])
    return torch.movedim(out[:, 0, :].reshape(shape), -1, axis)


def impedance_synthetic(vp: torch.Tensor, *, freq: float = 30.0,
                        n_wavelet: int = 64, dt: float = 0.002,
                        rho: torch.Tensor | None = None,
                        axis: int = -2) -> torch.Tensor:
    """vp (and rho) -> impedance -> reflectivity -> wavelet synthetic:
    the Auto2 impedance forward model.  The Ricker wavelet (``n_wavelet``
    samples at ``dt``, peak at its middle) is made on ``vp``'s device."""
    wav = ricker(freq, n_wavelet, dt, peak_time=n_wavelet * dt / 2,
                 device=vp.device)
    return convolve_wavelet(reflectivity(impedance(vp, rho), axis=axis),
                            wav, axis=axis)


def impedance_misfit(vp_pred, vp_true, *, kind: str = "l1", **kw):
    """L1 (or, for ``kind="l2"``, L2) misfit between the impedance
    synthetics of two models."""
    s_pred = impedance_synthetic(vp_pred, **kw)
    s_true = impedance_synthetic(vp_true, **kw)
    return (l1_misfit if kind == "l1" else l2_misfit)(s_pred, s_true)
