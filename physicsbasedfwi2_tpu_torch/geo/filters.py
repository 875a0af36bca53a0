"""Frequency-domain low-pass for frequency-continuation FWI (port of
``physicsbasedfwi2_tpu/geo/filters.py``).

A zero-phase Butterworth low-pass applied along the time axis with
``torch.fft.rfft``/``irfft``: DENISE's per-stage corner frequency
(``fc_high``) applied to the source wavelet and the observed data.
"""

from __future__ import annotations

import torch


def butter_lowpass_coeffs(freqs: torch.Tensor, fc: float, order: int = 6
                          ) -> torch.Tensor:
    """|H(f)| of an order-n Butterworth low-pass (zero-phase => use
    the magnitude response directly)."""
    return 1.0 / torch.sqrt(1.0 + (freqs / fc) ** (2 * order))


def lowpass_filter_time(x: torch.Tensor, fc: float, dt: float, *,
                        axis: int = -1, order: int = 6) -> torch.Tensor:
    """Zero-phase Butterworth low-pass along ``axis``.

    Args:
        x: data with a time axis of length nt.
        fc: corner frequency in Hz. fc <= 0 disables filtering.
        dt: sample interval in seconds.
    """
    if fc is None or fc <= 0:
        return x
    nt = x.shape[axis]
    # the frequencies in float32, as jnp.fft.rfftfreq gives them
    freqs = torch.fft.rfftfreq(nt, dt, dtype=torch.float32,
                               device=x.device)
    h = butter_lowpass_coeffs(freqs, fc, order).to(x.dtype)
    spec = torch.fft.rfft(x, dim=axis)
    shape = [1] * x.ndim
    shape[axis] = h.shape[0]
    spec = spec * h.reshape(shape)
    return torch.fft.irfft(spec, n=nt, dim=axis).to(x.dtype)
