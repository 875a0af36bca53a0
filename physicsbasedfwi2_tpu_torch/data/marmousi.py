"""Canonical-grid Marmousi velocity model + SEG-Y writer (a numpy copy of
``physicsbasedfwi2_tpu/data/marmousi.py``: the same grids, bit for bit,
from the same seeds).

The reference trains its flagship elastic workload on the Marmousi
model (AutoElMar22, the reference's models/networks.py:7314 hard-codes
the 100x300 crop of it; the acoustic scripts use the same grid at
151x200).  The published Marmousi vp grid is distributed as a
751 x 2301 @ 4 m SEG-Y; this module downloads nothing, so
`canonical_marmousi_vp` reconstructs a Marmousi-STRUCTURED model at that
canonical resolution — deterministic, built from the model's
documented architecture (a thick water layer over a strongly dipping,
faulted sedimentary stack with growth faults in the center, velocity
inversions, a low-velocity reservoir wedge under an anticline and
high-velocity deep units) — and `write_segy_grid` emits it as a
standards-conforming SEG-Y rev1 file (IBM or IEEE samples).

This is NOT the published grid (its exact horizons are data this module
does not fetch); it is the stand-in that exercises the identical
published-grid pipeline.  The real file drops in unchanged:

    python -m physicsbasedfwi2_tpu_torch.data.prep --grid marmousi_vp.segy \
        --physics elastic --out ...

Usage (what `dataroots/` is built from):

    python -m physicsbasedfwi2_tpu_torch.data.marmousi --out marm751x2301.segy
    python -m physicsbasedfwi2_tpu_torch.data.prep --grid marm751x2301.segy \
        --physics acoustic --out ...
"""

from __future__ import annotations

import struct

import numpy as np


# ---------------------------------------------------------------------------
# model builder
# ---------------------------------------------------------------------------

def canonical_marmousi_vp(nz: int = 751, nx: int = 2301, *,
                          dx: float = 4.0, seed: int = 1988,
                          water_frac: float = 0.26) -> np.ndarray:
    """Deterministic Marmousi-structured vp grid [nz, nx] in m/s.

    Structure (matching the model's published architecture, not its
    exact horizons): `water_frac` of the depth axis is 1500 m/s water
    (0.26 so that the elastic workload's water_rows=26 on the 100-row
    training grid lands exactly on the seabed after resampling); below
    it ~40 sedimentary layers with a compaction velocity trend,
    alternating inversions, strong lateral dips steepening toward the
    center, a growth-fault complex (listric offsets increasing with
    depth), an anticline with a low-velocity reservoir wedge beneath
    its crest, and high-velocity deep wedges.  Clipped to the workload
    bounds [1500, 4700] (engine clip_max, engines.py)."""
    rng = np.random.default_rng(seed)
    z = np.arange(nz, dtype=np.float64)[:, None]
    x = np.arange(nx, dtype=np.float64)[None, :]
    zw = water_frac * nz                      # seabed row
    sed = nz - zw                             # sediment thickness (rows)

    # --- structural depth field: fold + faults remap each column's
    # stratigraphic coordinate s(z, x) in [0, 1] below the seabed.
    s = (z - zw) / sed
    # regional dip: horizons rise ~18% of the section across the model
    s = s + 0.18 * (x / nx - 0.5)
    # central anticline (the Marmousi target structure)
    s = s + 0.10 * np.exp(-(((x / nx) - 0.55) / 0.16) ** 2) \
        * np.clip((z - zw) / sed, 0.0, 1.0)
    # secondary syncline on the left flank
    s = s - 0.05 * np.exp(-(((x / nx) - 0.22) / 0.12) ** 2) \
        * np.clip((z - zw) / sed, 0.0, 1.0)
    # growth-fault complex: listric normal faults in the center third,
    # throw increasing with depth (growth geometry)
    fault_xs = (0.38, 0.46, 0.53, 0.61, 0.69)
    throws = (0.030, 0.045, 0.060, 0.045, 0.035)
    for fx, th in zip(fault_xs, throws):
        # fault plane dips basinward: trace position shifts with depth
        plane = fx * nx + 0.22 * (z - zw)
        hang = (x > plane).astype(np.float64)
        s = s + hang * th * np.clip((z - zw) / sed, 0.0, 1.3)
    # gentle long-wavelength roughness so horizons are not analytic
    for k, amp in ((2, 0.012), (5, 0.008), (9, 0.005), (17, 0.003)):
        ph = rng.uniform(0, 2 * np.pi)
        s = s + amp * np.sin(2 * np.pi * k * x / nx + ph)

    # --- stratigraphic velocity column: ~40 layers on a compaction
    # trend with alternating inversions (the Marmousi signature)
    n_layers = 40
    tops = np.sort(rng.uniform(0.0, 1.0, n_layers - 1))
    tops = np.concatenate([[0.0], tops])
    trend0, trend1 = 1650.0, 4350.0
    base = trend0 + (trend1 - trend0) * tops ** 1.15
    # alternating layer-to-layer fluctuation: shales/sands/carbonates
    fluct = rng.uniform(80.0, 320.0, n_layers) * \
        np.where(np.arange(n_layers) % 2 == 0, 1.0, -1.0)
    layer_v = np.clip(base + fluct, 1550.0, 4700.0)
    # two high-velocity deep units (the fast wedges at depth)
    layer_v[-3:] = np.clip(layer_v[-3:] + 350.0, None, 4700.0)
    # low-velocity reservoir layer ~2/3 down (gas sand under the
    # anticline crest once folding lifts it)
    res_i = int(0.66 * n_layers)
    layer_v[res_i] = 2100.0

    idx = np.clip(np.searchsorted(tops, np.clip(s, 0.0, 1.0),
                                  side="right") - 1, 0, n_layers - 1)
    vp = layer_v[idx]
    # reservoir wedge: the low-velocity layer only retains gas under
    # the anticline (pinchout away from the crest)
    crest = np.exp(-(((x / nx) - 0.55) / 0.10) ** 2)
    in_res = idx == res_i
    vp = np.where(in_res & (crest < 0.35), layer_v[res_i] + 600.0, vp)
    # water column + thin transition at the seabed
    vp = np.where(z < zw, 1500.0, vp)
    seabed = (z >= zw) & (z < zw + 0.01 * nz)
    vp = np.where(seabed, 1600.0, vp)
    return np.clip(vp, 1500.0, 4700.0).astype(np.float32)


def canonical_seam_vp(nz: int = 600, nx: int = 1620, *,
                      seed: int = 2011,
                      water_frac: float = 0.167) -> np.ndarray:
    """Deterministic SEAM-Phase-I-structured vp slice [nz, nx] in m/s.

    The reference's SEAM workload crops a 120 x 324 @ 30 m slice
    (networks.py:9637-9700: 5 Hz, sources at 180 m, receivers at
    690 m).  SEAM's defining architecture: a deep-water marine
    setting over gently-dipping Tertiary sediments pierced by a large
    salt body (vp ~4480 m/s) with steep flanks and a salt overhang,
    plus sub-salt sediment inversions.  water_frac 0.167 puts the
    seabed at row 20 of the 120-row training grid (the workload's
    water_rows=20)."""
    rng = np.random.default_rng(seed)
    z = np.arange(nz, dtype=np.float64)[:, None]
    x = np.arange(nx, dtype=np.float64)[None, :]
    zw = water_frac * nz
    sed = nz - zw
    # gently dipping background sediments with compaction trend
    s = (z - zw) / sed + 0.06 * (x / nx - 0.5)
    for k, amp in ((1, 0.02), (3, 0.012), (7, 0.006)):
        s = s + amp * np.sin(2 * np.pi * k * x / nx
                             + rng.uniform(0, 2 * np.pi))
    n_layers = 24
    tops = np.concatenate([[0.0],
                           np.sort(rng.uniform(0.0, 1.0, n_layers - 1))])
    base = 1700.0 + 2100.0 * tops ** 1.2
    fluct = rng.uniform(60.0, 220.0, n_layers) * \
        np.where(np.arange(n_layers) % 2 == 0, 1.0, -1.0)
    layer_v = np.clip(base + fluct, 1600.0, 4300.0)
    idx = np.clip(np.searchsorted(tops, np.clip(s, 0.0, 1.0),
                                  side="right") - 1, 0, n_layers - 1)
    vp = layer_v[idx]
    # salt body: stem + overhang (vp 4480, SEAM's constant salt)
    xc, top = 0.58, zw + 0.18 * sed
    half_w = (0.06 + 0.22 * np.clip((z - top) / (0.5 * sed), 0, 1)
              # overhang bulge near the top third
              + 0.10 * np.exp(-(((z - (top + 0.22 * sed))
                                 / (0.08 * sed)) ** 2)))
    in_salt = (np.abs(x / nx - xc) < half_w) & (z > top)
    vp = np.where(in_salt, 4480.0, vp)
    # water + seabed transition
    vp = np.where(z < zw, 1490.0, vp)
    vp = np.where((z >= zw) & (z < zw + 0.008 * nz), 1560.0, vp)
    return np.clip(vp, 1490.0, 4480.0).astype(np.float32)


# ---------------------------------------------------------------------------
# SEG-Y writer (the counterpart of data/prep.py::read_segy_grid)
# ---------------------------------------------------------------------------

def _float_to_ibm32(f: np.ndarray) -> np.ndarray:
    """IEEE float -> IBM System/360 hexadecimal float (format 1)."""
    f = np.asarray(f, np.float64)
    sign = (f < 0).astype(np.uint32) << 31
    a = np.abs(f)
    with np.errstate(divide="ignore"):
        # choose exponent e (base 16) so mantissa in [1/16, 1)
        e = np.where(a > 0, np.floor(np.log2(a) / 4.0) + 1, 0.0)
    mant = np.where(a > 0, a / np.power(16.0, e), 0.0)
    # rounding can push the 24-bit mantissa to 1.0 -> renormalize
    m24 = np.round(mant * (1 << 24))
    carry = m24 >= (1 << 24)
    m24 = np.where(carry, m24 / 16.0, m24).astype(np.uint32)
    e = (e + carry).astype(np.int64)
    exp = ((e + 64).astype(np.uint32) & 0x7F) << 24
    return np.where(a > 0, sign | exp | m24, 0).astype(np.uint32)


def write_segy_grid(path: str, m: np.ndarray, *, dx: float = 4.0,
                    fmt: int = 5) -> None:
    """Write a [nz, nx] velocity grid as SEG-Y rev1: one trace per
    lateral position (depth down the trace), big-endian headers,
    fmt=5 IEEE or fmt=1 IBM samples — the two encodings
    prep.read_segy_grid accepts."""
    if fmt not in (1, 5):
        raise ValueError(f"fmt must be 1 (IBM) or 5 (IEEE), got {fmt}")
    nz, nx = m.shape
    text = (f"C 1 Marmousi-structured velocity grid {nz}x{nx} @ "
            f"{dx} m, column traces").ljust(3200)[:3200]
    # the uint16 "sample interval" slot holds dx in mm (= us for time
    # data); clamp at the format ceiling (65.535 m) rather than raise
    # struct.error — readers here ignore the slot, the textual header
    # above carries the authoritative dx
    dx_slot = min(int(round(dx * 1000)), 0xFFFF)
    bin_hdr = bytearray(400)
    bin_hdr[16:18] = struct.pack(">H", dx_slot)  # dt (us slot)
    bin_hdr[20:22] = struct.pack(">H", nz)                     # ns
    bin_hdr[24:26] = struct.pack(">H", fmt)                    # format
    with open(path, "wb") as f:
        f.write(text.encode("ascii"))
        f.write(bytes(bin_hdr))
        cols = np.ascontiguousarray(m.T, dtype=np.float32)  # [nx, nz]
        if fmt == 1:
            samples = _float_to_ibm32(cols).astype(">u4")
        else:
            samples = cols.astype(">f4")
        for j in range(nx):
            tr_hdr = bytearray(240)
            tr_hdr[0:4] = struct.pack(">i", j + 1)      # trace seq
            tr_hdr[114:116] = struct.pack(">H", nz)     # ns
            tr_hdr[116:118] = struct.pack(">H", dx_slot)
            f.write(bytes(tr_hdr))
            f.write(samples[j].tobytes())


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        description="Build a canonical-grid Marmousi- or SEAM-"
                    "structured velocity model and write it as SEG-Y")
    p.add_argument("--out", required=True, help="output .segy path")
    p.add_argument("--model", default="marmousi",
                   choices=("marmousi", "seam"))
    p.add_argument("--nz", type=int, default=None)
    p.add_argument("--nx", type=int, default=None)
    p.add_argument("--fmt", type=int, default=5, choices=(1, 5),
                   help="sample format: 5=IEEE (default), 1=IBM")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--dx", type=float, default=None,
                   help="cell size written to the SEG-Y headers "
                        "(default: 4 m Marmousi, 30 m SEAM)")
    args = p.parse_args(argv)
    if args.model == "seam":
        vp = canonical_seam_vp(args.nz or 600, args.nx or 1620,
                               seed=args.seed or 2011)
        dx = args.dx if args.dx is not None else 30.0
    else:
        vp = canonical_marmousi_vp(args.nz or 751, args.nx or 2301,
                                   seed=args.seed or 1988)
        dx = args.dx if args.dx is not None else 4.0
    write_segy_grid(args.out, vp, dx=dx, fmt=args.fmt)
    print(f"wrote {args.out}: {vp.shape[0]}x{vp.shape[1]} vp in "
          f"[{vp.min():.0f}, {vp.max():.0f}] m/s (fmt={args.fmt})")


if __name__ == "__main__":
    main()
