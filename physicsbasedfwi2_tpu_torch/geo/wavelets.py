"""Source wavelets (port of ``physicsbasedfwi2_tpu/geo/wavelets.py``).

Replaces ``deepwave.wavelets.ricker`` (peak frequency f, length nt,
sample dt, peak time shift 1/f).
"""

from __future__ import annotations

import math

import torch


def ricker(freq: float, nt: int, dt: float, peak_time: float | None = None,
           *, device: torch.device | str = "cpu") -> torch.Tensor:
    """Ricker (Mexican-hat) wavelet, [nt] float32.

    Computed in float32 throughout, as the JAX package computes it (its
    float64 ``arange`` is truncated to float32 with x64 off), so the two
    agree to the last bit or so.
    """
    if peak_time is None:
        peak_time = 1.0 / freq
    t = torch.arange(nt, dtype=torch.float32, device=device) * dt - peak_time
    a = (math.pi * freq * t) ** 2
    return (1.0 - 2.0 * a) * torch.exp(-a)


def spike_band(fc_low: float, fc_high: float, nt: int, dt: float, *,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """Band-limited spike source, [nt] float32.

    The role of DENISE's ``FC_SPIKE_1/FC_SPIKE_2`` bandpass spike
    wavelet: a delta filtered to [fc_low, fc_high] with a zero-phase
    cosine-tapered band in the frequency domain (half-octave rolloff),
    delayed by 1.2 / fc_low and scaled to a peak of 1.  The spectrum is
    complex64 and the frequencies float32, as in the JAX package.
    """
    freqs = torch.fft.rfftfreq(nt, dt, dtype=torch.float32, device=device)
    lo_edge = torch.clamp((freqs - 0.5 * fc_low) / (0.5 * fc_low + 1e-20),
                          0, 1)
    hi_edge = torch.clamp((fc_high * 1.25 - freqs) / (0.25 * fc_high + 1e-20),
                          0, 1)
    taper = (0.5 * (1 - torch.cos(math.pi * lo_edge)) * 0.5
             * (1 - torch.cos(math.pi * hi_edge)))
    spec = taper.to(torch.complex64)
    # time shift so the wavelet onset is causal-ish
    delay = 1.2 / max(fc_low, 1e-6)
    spec = spec * torch.exp(-2j * math.pi * freqs * delay)
    w = torch.fft.irfft(spec, n=nt)
    return w / (torch.max(torch.abs(w)) + 1e-20)
