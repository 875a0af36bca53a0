"""Dataset preparation (port of ``physicsbasedfwi2_tpu/data/prep.py``):
ingest REAL velocity grids (Marmousi / Marmousi2 / SEAM slices) and
materialize the training data tree.

Read the published grid (SEG-Y, flat float32 .bin, or .npy), resample
it to the workload grid, synthesize the observed data with the port's
propagators, and write the unalignedVelABCD2 / unalignedVelABCDEl
contract that the engines consume (``--dataroot``).

The observed data come from the operators the port's engines invert
with, on every device: kernel B1 (:func:`ops.scalar2.forward2`) for the
acoustic tree, the ring forward (:func:`ops.elastic_fused.
simulate_elastic_ring`, B3's forward sweep) for the elastic one; on the
CPU their plain versions.  (The JAX prep uses its fused kernels on a TPU
only, and ``simulate_acoustic``/``simulate_elastic`` elsewhere.)  So the
misfit at the true model is zero on the card and on the CPU alike.

CLI (the JAX package's ``fwi-prep`` flags, plus ``--device``; the
default device is the first CUDA card)::

    python -m physicsbasedfwi2_tpu_torch.data.prep --grid marmousi_vp.segy \
        --out /data/marm --physics acoustic
    python -m physicsbasedfwi2_tpu_torch.data.prep --grid vp.bin \
        --bin-nz 751 --bin-nx 2301 --physics elastic --out ...
    python -m physicsbasedfwi2_tpu_torch.data.prep --su-obs su/ --out ...

Standard grids this understands out of the box:
  - Marmousi (classic): 751 x 2301 cells @ 4 m, vp in m/s
  - Marmousi2 vp:       2801 x 13601 @ 1.25 m (SEG-Y, IBM floats)
  - any .npy [nz, nx] float array in m/s (row 0 = surface)
"""

from __future__ import annotations

import argparse
import os
import struct

import numpy as np
import torch

from physicsbasedfwi2_tpu_torch.data.synthetic import (
    make_elastic_model, smooth_model,
)
from physicsbasedfwi2_tpu_torch.device import default_device
from physicsbasedfwi2_tpu_torch.geo import (
    Grid2D, check_cfl, elastic_line, ricker, seabed_rows, surface_line,
)
from physicsbasedfwi2_tpu_torch.ops import AcousticConfig
from physicsbasedfwi2_tpu_torch.ops.elastic import (
    ElasticConfig, simulate_elastic,
)
from physicsbasedfwi2_tpu_torch.ops.elastic_fused import simulate_elastic_ring
from physicsbasedfwi2_tpu_torch.ops.scalar2 import forward2


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def _ibm32_to_float(u32: np.ndarray) -> np.ndarray:
    """IBM System/360 hexadecimal float -> IEEE (SEG-Y format code 1)."""
    u32 = u32.astype(np.uint32)
    sign = np.where(u32 >> 31, -1.0, 1.0)
    exponent = ((u32 >> 24) & 0x7F).astype(np.int32) - 64
    mantissa = (u32 & 0x00FFFFFF).astype(np.float64) / float(1 << 24)
    return (sign * mantissa * np.power(16.0, exponent)).astype(np.float32)


def read_segy_grid(path: str) -> np.ndarray:
    """Minimal SEG-Y reader for regular velocity-grid files: one trace
    per lateral position, constant samples/trace.  Handles IBM
    (format 1) and IEEE (format 5) sample encodings, big-endian
    headers per the SEG-Y rev1 standard.  Returns [nz, nx]."""
    with open(path, "rb") as f:
        f.seek(3200)  # skip EBCDIC textual header
        bin_hdr = f.read(400)
        ns = struct.unpack(">H", bin_hdr[20:22])[0]        # byte 3221
        fmt = struct.unpack(">H", bin_hdr[24:26])[0]       # byte 3225
        if fmt not in (1, 5):
            raise ValueError(f"unsupported SEG-Y sample format {fmt} "
                             "(need 1=IBM or 5=IEEE)")
        data = f.read()
    trace_bytes = 240 + 4 * ns
    ntr = len(data) // trace_bytes
    if ntr == 0 or ns == 0:
        raise ValueError(f"no traces parsed from {path}")
    raw = np.frombuffer(data[: ntr * trace_bytes], dtype=np.uint8)
    raw = np.ascontiguousarray(raw.reshape(ntr, trace_bytes)[:, 240:])
    if fmt == 1:
        u32 = raw.view(">u4").reshape(ntr, ns).astype(np.uint32)
        cols = _ibm32_to_float(u32)
    else:
        cols = raw.view(">f4").reshape(ntr, ns).astype(np.float32)
    # traces are depth columns; transpose to [nz, nx]
    return np.ascontiguousarray(cols.T)


def read_velocity_grid(path: str, *, bin_nz: int | None = None,
                       bin_nx: int | None = None) -> np.ndarray:
    """Dispatch on extension: .npy | .segy/.sgy | .bin/.dat (flat
    little-endian float32, needs bin_nz x bin_nx)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        m = np.load(path)
        if m.ndim != 2:
            raise ValueError(f"expected 2D grid, got shape {m.shape}")
        return m.astype(np.float32)
    if ext in (".segy", ".sgy"):
        return read_segy_grid(path)
    if ext in (".bin", ".dat", ".rsf@", ""):
        if not bin_nz or not bin_nx:
            raise ValueError(".bin grids need --bin-nz/--bin-nx")
        m = np.fromfile(path, dtype=np.float32)
        if m.size != bin_nz * bin_nx:
            raise ValueError(
                f"{path}: {m.size} floats != {bin_nz}x{bin_nx}")
        return m.reshape(bin_nz, bin_nx)
    raise ValueError(f"unknown grid format {ext!r}")


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """The [n_in, n_out] weight matrix of ``jax.image.resize(...,
    "bilinear")`` along one axis (JAX's ``scale_and_translate`` with the
    triangle kernel, antialiased): sample j at (j + 0.5) n_in / n_out -
    0.5, the kernel widened by n_in / n_out when that shrinks the axis,
    each sample's weights normalised to sum 1 and zeroed where the
    sample lies outside the input.  float32 arithmetic, as JAX's."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))  # in float64, as JAX's Python
    kernel_scale = max(inv_scale, f32(1.0))
    sample = ((np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale
              - f32(0.5)).astype(f32)
    x = (np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
         / kernel_scale).astype(f32)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resample_grid(m: np.ndarray, nz: int, nx: int) -> np.ndarray:
    """Bilinear resample to the workload grid, as ``jax.image.resize(m,
    (nz, nx), "bilinear")`` does it: separable triangle-kernel weights
    (:func:`resize_weights`), so an axis that shrinks is low-pass
    filtered first (antialiased), and an axis that keeps its size is
    left as it is."""
    m = np.asarray(m, np.float32)
    out = m.astype(np.float64)
    if nz != m.shape[0]:
        out = resize_weights(m.shape[0], nz).T.astype(np.float64) @ out
    if nx != m.shape[1]:
        out = out @ resize_weights(m.shape[1], nx).astype(np.float64)
    return out.astype(np.float32)


def normalize_velocity(m: np.ndarray, *, unit: str = "auto",
                       vmin: float = 1400.0,
                       vmax: float = 5000.0) -> np.ndarray:
    """Unit fixups: km/s grids x1000 (auto: km/s values are O(1..6));
    clip to physical range."""
    m = m.astype(np.float32)
    if unit == "km/s" or (unit == "auto" and m.max() < 20.0):
        m = m * 1000.0
    return np.clip(m, vmin, vmax)


# ---------------------------------------------------------------------------
# workload materialization
# ---------------------------------------------------------------------------

def prepare_acoustic_tree(vp: np.ndarray, out_root: str, *,
                          dx: float = 10.0, nt: int = 4001,
                          dt: float = 0.001, freq: float = 8.0,
                          num_shots: int = 18, num_receivers: int = 200,
                          pml_width: int = 20, water_rows: int = 26,
                          chunk: int = 64, smooth_iters: int = 40,
                          phases=("train", "test"), test_seed: int = 17,
                          water_vel: float = 1500.0, device=None):
    """vp [nz, nx] -> unalignedVelABCD2 npy tree with observed data
    simulated by kernel B1 (trainA), the true model (trainB) and the
    smoothed start (trainC); a perturbed 'test' twin provides the
    held-out validation sample (create_dataset2 role).

    Storage convention (must match the engine's from-disk handling,
    engines.py AcousticDIPEngine): trainA gathers are stored with the
    constant-water-model direct arrival already SUBTRACTED — the
    reference normalizes observed data raw while removing the direct
    from predictions only (networks.py:5418 vs 5467), which is
    consistent only because its trainA files lack the direct.  The
    gathers and the direct wave come from :func:`forward2` on
    ``device`` (the first CUDA card by default: kernel B1; on the CPU
    its plain version), the operator the engine's fused path inverts
    with, so the misfit is zero at the true model."""
    if device is None:
        device = default_device()
    nz, nx = vp.shape
    grid = Grid2D(nz=nz, nx=nx, dx=dx, nt=nt, dt=dt, pml_width=pml_width)
    cfg = AcousticConfig(grid=grid, chunk=chunk, vmax_pml=5000.0)
    check_cfl(float(vp.max()), grid)
    wav = ricker(freq, nt, dt, device=device)
    acq = surface_line(num_shots, num_receivers, nx, src_depth=0,
                       rcv_depth=0)
    geom = tuple(torch.as_tensor(a, dtype=torch.int32, device=device)
                 for a in (acq.src_z, acq.src_x, acq.rcv_z, acq.rcv_x))

    def sim(m):
        return forward2(torch.as_tensor(m, device=device), wav, *geom, cfg)

    direct = sim(np.full_like(vp, water_vel))

    rng = np.random.default_rng(test_seed)
    for phase in phases:
        m = vp.copy()
        if phase != "train":
            # held-out twin: smooth bump perturbation of the grid
            z, x = np.mgrid[0:nz, 0:nx].astype(np.float32)
            zc, xc = rng.uniform(0.4, 0.7) * nz, rng.uniform(0.3, 0.7) * nx
            bump = 150.0 * np.exp(-(((z - zc) / (0.1 * nz)) ** 2
                                    + ((x - xc) / (0.1 * nx)) ** 2))
            m = np.clip(m + bump, m.min(), m.max())
            m[:water_rows] = vp[:water_rows]
        obs = (sim(m) - direct).cpu().numpy()
        start = smooth_model(m, iters=smooth_iters,
                             preserve_rows=water_rows)
        for letter, arr in (("A", obs), ("B", m), ("C", start)):
            d = os.path.join(out_root, phase + letter)
            os.makedirs(d, exist_ok=True)
            np.save(os.path.join(d, "0.npy"), np.asarray(arr, np.float32))
    return out_root


def prepare_elastic_tree(vp: np.ndarray, out_root: str, *,
                         dx: float = 20.0, nt: int = 3334,
                         dt: float = 0.0015, freq: float = 10.0,
                         num_shots: int = 35, num_receivers: int = 298,
                         pml_width: int = 20, water_rows: int = 26,
                         chunk: int = 64, vpvs: float = 1.8,
                         free_surface: bool = True,
                         smooth_iters: int = 40,
                         src_depth_row: int | None = None,
                         rcv_depth_row: int | None = None,
                         rcv_follow_seabed: bool = False,
                         rho_start: str = "smooth",
                         obs_scheme: str = "auto", device=None):
    """vp [nz, nx] -> unalignedVelABCDEl npy tree (A/D = vx/vz
    gathers, B = [Vp;Vs;Rho]/100, C = low-freq triple /100 — the
    reference's hectometer storage units,
    unalignedVelABCDEl_dataset.py:84-87).

    src_depth_row / rcv_depth_row / rcv_follow_seabed mirror the
    engine's acquisition extras (SEAM: sources at row 6, receivers at
    row 23, networks.py:9688-9712) so a prepped SEAM tree carries
    gathers recorded at the geometry the workload will invert with —
    prep-time and train-time geometries must agree because the
    from-disk loader rebuilds geometry from the config, not the
    data (synthetic.elastic_workload_from_disk).

    rho_start picks the density in the starting tree (trainC):
    "smooth" (default) smooths the Gardner rho like vp/vs — the
    engine then simulates with a rho that can never match the rho
    that generated the gathers, which leaves a modeling-error floor
    under every misfit (measured on marm751x2301 at 20 Hz: tnl1
    0.199 at the true vp/vs vs 0.310 at the start — the floor eats
    2/3 of the landscape's dynamic range and data-consistent drifted
    models sit inside it, docs/RESULTS.md).  "true" stores the exact
    Gardner rho in trainC — the standard known-density elastic
    benchmark (invert vp/vs, density fixed at truth): the true model
    becomes an exact global minimum of the data misfit.

    ``obs_scheme`` "auto" simulates the gathers with the ring forward,
    "reference" with the split-PML :func:`simulate_elastic`, on
    ``device`` (the first CUDA card by default)."""
    if rho_start not in ("smooth", "true"):
        raise ValueError(f"rho_start must be 'smooth' or 'true', "
                         f"got {rho_start!r}")
    if obs_scheme not in ("auto", "reference"):
        raise ValueError(f"obs_scheme must be 'auto' or 'reference', "
                         f"got {obs_scheme!r}")
    if device is None:
        device = default_device()
    nz, nx = vp.shape
    grid = Grid2D(nz=nz, nx=nx, dx=dx, nt=nt, dt=dt,
                  pml_width=pml_width, free_surface=free_surface)
    cfg = ElasticConfig(grid=grid, chunk=chunk, vmax_pml=5000.0)
    check_cfl(float(vp.max()), grid)
    wav = ricker(freq, nt, dt, device=device)
    vp_t, vs_t, rho_t = make_elastic_model(vp, vpvs=vpvs,
                                           water_rows=water_rows)
    # same builder the engine's from-disk loader uses
    # (elastic_workload_from_disk -> elastic_line), so prep-time and
    # train-time geometries can never drift apart
    acq = elastic_line(
        num_shots, num_receivers, nx, nz,
        src_row=(src_depth_row if src_depth_row is not None
                 else water_rows + 1),
        rcv_row=(rcv_depth_row if rcv_depth_row is not None
                 else water_rows + 1),
        rcv_rows_per_col=(seabed_rows(vp_t) if rcv_follow_seabed
                          else None))
    geom = tuple(torch.as_tensor(a, dtype=torch.int32, device=device)
                 for a in (acq.src_z, acq.src_x, acq.rcv_z, acq.rcv_x))
    # obs_scheme="auto": the ring forward, the operator the engine's
    # fused path inverts with (on a card the resident route where a plan
    # holds the grid, the per-step route elsewhere; on the CPU its plain
    # version), so the stored gathers are operator-consistent with the
    # inversion.  "reference" forces the split-PML scheme
    # (ops/elastic.py), a DIFFERENT discretization from the sponge
    # scheme the engine inverts with, which kills the inverse crime: the
    # stored gathers carry scheme/boundary discretization error the
    # inversion cannot fit, like the reference's DENISE-generated obs
    # inverted by a separate run (networks.py:7733).
    sim_el = (simulate_elastic if obs_scheme == "reference"
              else simulate_elastic_ring)
    b = np.stack([vp_t, vs_t, rho_t]) / 100.0
    # the gathers come from the model as the loader reads it back
    # (trainB x 100 in float32, a rounding away from vp_t in places), so
    # the misfit at the stored true model is zero
    with torch.no_grad():
        ovx, ovz = sim_el(*torch.as_tensor(b * 100.0, device=device), wav,
                          *geom, cfg)
    ovx, ovz = ovx.cpu().numpy(), ovz.cpu().numpy()
    c_rho = (rho_t if rho_start == "true"
             else smooth_model(rho_t, iters=smooth_iters,
                               preserve_rows=water_rows))
    c = np.stack([smooth_model(vp_t, iters=smooth_iters,
                               preserve_rows=water_rows),
                  smooth_model(vs_t, iters=smooth_iters,
                               preserve_rows=water_rows),
                  c_rho]) / 100.0
    for letter, arr in (("A", np.asarray(ovx)), ("B", b), ("C", c),
                        ("D", np.asarray(ovz))):
        d = os.path.join(out_root, "train" + letter)
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, "0.npy"), np.asarray(arr, np.float32))
    return out_root


def read_su_gather(path: str):
    """Read one Seismic-Unix shot file -> ([ntraces, ns] float32, dt_s).

    SU = SEG-Y trace format without the 3600-byte file header: per
    trace a 240-byte header (ns = uint16 at byte 114, dt in
    microseconds = uint16 at byte 116) followed by ns float32
    samples.  DENISE writes native-endian files (the reference's
    observed data lives in su/seis_{x,y}.su.shot<k>,
    networks.py:7669-7692); big-endian files are detected by trying
    both byte orders and keeping the one under which every trace
    header agrees on ns and traces tile the file.

    Parsing goes through the native C++ reader
    (native/su_reader.cpp) when a compiler is available; the numpy
    path below is the byte-for-byte-equivalent fallback."""
    from physicsbasedfwi2_tpu_torch.data.native_su import read_su_native
    native = read_su_native(path)
    if native is not None:
        return native
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size < 244:
        raise ValueError(f"{path}: too short for an SU trace")

    def try_order(order):
        u16 = np.dtype(np.uint16).newbyteorder(order)
        ns = int(raw[114:116].view(u16)[0])
        if ns == 0:
            return None
        tr_bytes = 240 + 4 * ns
        if raw.size % tr_bytes:
            return None
        # every trace header must agree on ns — a coincidental
        # divisor under the wrong byte order won't (the swapped ns
        # lands mid-sample in later headers)
        ntr = raw.size // tr_bytes
        all_ns = raw.reshape(ntr, tr_bytes)[:, 114:116].copy().view(u16)
        if not (all_ns == ns).all():
            return None
        return ns, tr_bytes

    for order in ("<", ">"):
        hit = try_order(order)
        if hit:
            ns, tr_bytes = hit
            break
    else:
        raise ValueError(f"{path}: no byte order yields a whole "
                         "number of consistent SU traces")
    ntr = raw.size // tr_bytes
    mat = raw.reshape(ntr, tr_bytes)
    dt_us = int(mat[0, 116:118].view(
        np.dtype(np.uint16).newbyteorder(order))[0])
    if dt_us <= 0:
        raise ValueError(f"{path}: SU header dt={dt_us} us is not "
                         "positive — corrupt header?")
    data = mat[:, 240:].reshape(ntr, ns, 4).copy().view(
        np.dtype(np.float32).newbyteorder(order)).reshape(ntr, ns)
    return np.ascontiguousarray(data.astype(np.float32)), dt_us * 1e-6


def prepare_su_observed(su_dir: str, out_root: str, *,
                        prefix: str = "seis",
                        components: tuple = ("x", "y"),
                        phase: str = "train") -> tuple:
    """Ingest a DENISE observed-data directory (the reference's
    ``su/`` with ``seis_x.su.shot1..N`` / ``seis_y.su.shot1..N``)
    into the unalignedVelABCDEl npy contract: component x -> letter A
    (vx gathers [nsrc, nt, nrec]), component y -> letter D (vy).

    Returns ((nsrc, nt, nrec), dt_seconds)."""
    letters = {"x": "A", "y": "D"}
    shape = None
    dt_s = None
    first_file = None
    for comp in components:
        shots = []
        k = 1
        while True:
            path = os.path.join(su_dir, f"{prefix}_{comp}.su.shot{k}")
            if not os.path.exists(path):
                break
            tr, dt = read_su_gather(path)  # raises on dt <= 0
            if dt_s is None:
                dt_s, first_file = dt, path
            elif abs(dt - dt_s) > 1e-12:
                raise ValueError(
                    f"{path}: dt={dt}s disagrees with {first_file} "
                    f"(dt={dt_s}s) — mixed acquisition in su_dir")
            if shots and tr.T.shape != shots[0].shape:
                raise ValueError(
                    f"{path}: gather shape {tr.shape} disagrees with "
                    f"shot1's {shots[0].T.shape} for component "
                    f"'{comp}'")
            shots.append(tr.T)  # [nt, nrec]
            k += 1
        if not shots:
            raise FileNotFoundError(
                f"no {prefix}_{comp}.su.shot* files in {su_dir}")
        arr = np.stack(shots).astype(np.float32)  # [nsrc, nt, nrec]
        if shape is not None and arr.shape != shape:
            # catch inconsistent component dirs HERE, not later when
            # the elastic loader silently mis-pairs A[k] with D[k]
            raise ValueError(
                f"component '{comp}' has shape {arr.shape} but an "
                f"earlier component had {shape} — su_dir is "
                "inconsistent (partial copy?)")
        d = os.path.join(out_root, phase + letters[comp])
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, "0.npy"), arr)
        shape = arr.shape
    return shape, dt_s


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Prepare FWI training data from a published "
                    "velocity grid (Marmousi/SEAM) (PyTorch port)")
    p.add_argument("--grid", default=None,
                   help=".segy/.sgy, .npy, or flat float32 .bin")
    p.add_argument("--su-obs", default=None,
                   help="DENISE observed-data dir (seis_x.su.shot* / "
                        "seis_y.su.shot*): ingested as the A/D "
                        "letters instead of simulated gathers")
    p.add_argument("--su-prefix", default="seis")
    p.add_argument("--out", required=True, help="output dataroot")
    p.add_argument("--physics", choices=("acoustic", "elastic"),
                   default="acoustic")
    p.add_argument("--nz", type=int, default=151)
    p.add_argument("--nx", type=int, default=200)
    p.add_argument("--bin-nz", type=int, default=None)
    p.add_argument("--bin-nx", type=int, default=None)
    p.add_argument("--dx", type=float, default=None)
    p.add_argument("--nt", type=int, default=None)
    p.add_argument("--dt", type=float, default=None)
    p.add_argument("--freq", type=float, default=None)
    p.add_argument("--num-shots", type=int, default=None)
    p.add_argument("--num-receivers", type=int, default=None)
    p.add_argument("--water-rows", type=int, default=26)
    p.add_argument("--src-depth-row", type=int, default=None,
                   help="elastic source row (default water_rows+1; "
                        "SEAM uses 6)")
    p.add_argument("--rcv-depth-row", type=int, default=None,
                   help="elastic receiver row (default water_rows+1; "
                        "SEAM uses 23)")
    p.add_argument("--rcv-follow-seabed", action="store_true",
                   help="per-column receiver depths at the seabed "
                        "(the reference's nnz mode)")
    p.add_argument("--rho-start", choices=("smooth", "true"),
                   default="smooth",
                   help="density in the starting tree: 'true' = the "
                        "known-density benchmark (trainC carries the "
                        "exact Gardner rho, so the true vp/vs is an "
                        "exact misfit minimum)")
    p.add_argument("--obs-scheme", choices=("auto", "reference"),
                   default="auto",
                   help="elastic observed-data propagator: 'auto' = "
                        "the scheme the engine inverts with (the ring "
                        "forward); 'reference' = the "
                        "split-PML scheme (ops/elastic.py) — a "
                        "different discretization, so the inversion "
                        "faces real modeling error instead of an "
                        "inverse crime")
    p.add_argument("--unit", choices=("m/s", "km/s", "auto"),
                   default="auto")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda:0; fails when no "
                        "CUDA card is visible -- pass cpu to run the "
                        "kernels' plain versions on the CPU)")
    args = p.parse_args(argv)
    if args.grid is None and args.su_obs is None:
        p.error("need --grid and/or --su-obs")

    if args.grid is not None:
        m = read_velocity_grid(args.grid, bin_nz=args.bin_nz,
                               bin_nx=args.bin_nx)
        m = normalize_velocity(m, unit=args.unit)
        m = resample_grid(m, args.nz, args.nx)
        kw = {}
        for k in ("dx", "nt", "dt", "freq"):
            v = getattr(args, k)
            if v is not None:
                kw[k] = v
        if args.num_shots is not None:
            kw["num_shots"] = args.num_shots
        if args.num_receivers is not None:
            kw["num_receivers"] = args.num_receivers
        kw["water_rows"] = args.water_rows
        kw["device"] = args.device
        if args.physics == "acoustic":
            prepare_acoustic_tree(m, args.out, **kw)
        else:
            prepare_elastic_tree(
                m, args.out, src_depth_row=args.src_depth_row,
                rcv_depth_row=args.rcv_depth_row,
                rcv_follow_seabed=args.rcv_follow_seabed,
                rho_start=args.rho_start,
                obs_scheme=args.obs_scheme, **kw)
        print(f"wrote {args.physics} tree to {args.out} "
              f"(grid {args.nz}x{args.nx})")
    if args.su_obs is not None:
        shape, dt_s = prepare_su_observed(args.su_obs, args.out,
                                          prefix=args.su_prefix)
        print(f"ingested SU observed data {shape} (dt={dt_s}s) "
              f"into {args.out} letters A/D")


if __name__ == "__main__":
    main()
