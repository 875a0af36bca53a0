"""Build a field-marine SU dataset for the ``real_data`` workload (port of
``benchmarks/make_realdata_su.py``).

The reference's AutoRealData workload (networks.py:9937-10580) ingests
field marine shot gathers as DENISE SU files (su/seis_x.su.shot1..N)
with vs and rho pinned by the DENISE bounds (VSUPPERLIM = VSLOWERLIM =
881, RHOUPPERLIM = RHOLOWERLIM = 1010, networks.py:10448-10460).  No
field data ships with the repository, so this tool manufactures the
same artifact: a canonical SEAM-structured marine vp slice, gathers
simulated with the split-PML scheme (``ops/elastic.py``, plain PyTorch;
not the fused sponge kernel the inversion runs, so the ingest-and-invert
path faces a real scheme mismatch), written as little-endian SU shot
files and ingested through ``prep --su-obs``, the path a user feeds
field tapes through.

The truth's vp is clipped below at 1500 m/s, as the JAX tool clips it:
below ``real_data``'s ``clip_min`` of 3000 m/s (ROADMAP Queue C).

Usage:
    python -m physicsbasedfwi2_tpu_torch.experiments.make_realdata_su \\
        --out dataroots/real_marine [--device cpu]
Then:
    python -m physicsbasedfwi2_tpu_torch.engine.train --workload \\
        real_data --dataroot dataroots/real_marine
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

# the clip of the truth's vp from below (the JAX tool's water velocity)
VP_FLOOR = 1500.0
# the marine workload's pinned elastic parameters (networks.py:10448-10460)
VS_PINNED, RHO_PINNED = 881.0, 1010.0


def write_su_gather(path, traces_tr_ns, dt_us):
    """[ntr, ns] float32 -> minimal little-endian SU file (240-byte
    headers carrying ns at bytes 114-115 and dt in microseconds at
    116-117, the fields ``native/su_reader.cpp`` probes)."""
    traces = np.ascontiguousarray(traces_tr_ns, "<f4")
    ntr, ns = traces.shape
    hdr = np.zeros((ntr, 240), np.uint8)
    hdr[:, 114:116] = np.frombuffer(np.array([ns], "<u2").tobytes(), np.uint8)
    hdr[:, 116:118] = np.frombuffer(np.array([dt_us], "<u2").tobytes(),
                                    np.uint8)
    with open(path, "wb") as f:
        f.write(np.concatenate([hdr, traces.view(np.uint8)], axis=1)
                .tobytes())


def make_realdata_su(cfg, out: str, su_dir: str | None = None, *,
                     device=None) -> dict:
    """Simulate ``cfg``'s (``real_data``'s) shots on the truth, write them
    as SU files under ``su_dir`` (default ``<out>_su``), ingest them into
    the dataroot ``out`` and write its starting model ``trainC/0.npy``
    and the truth ``trainB_oracle.npy`` (both /100).  ``device`` defaults
    to the card (raises without one).  Returns the record: the ingested
    gathers' shape and dt, and the paths written."""
    from physicsbasedfwi2_tpu_torch.data.marmousi import canonical_seam_vp
    from physicsbasedfwi2_tpu_torch.data.prep import (
        prepare_su_observed, resample_grid)
    from physicsbasedfwi2_tpu_torch.data.synthetic import smooth_model
    from physicsbasedfwi2_tpu_torch.device import default_device
    from physicsbasedfwi2_tpu_torch.geo import (
        Grid2D, check_cfl, elastic_line, ricker)
    from physicsbasedfwi2_tpu_torch.ops import ElasticConfig, simulate_elastic

    device = torch.device(device if device is not None else default_device())
    nz, nx = cfg.nz, cfg.nx
    vp = resample_grid(canonical_seam_vp(), nz, nx).astype(np.float32)
    vp = np.clip(vp, VP_FLOOR, float(cfg.clip_max[0]))
    vs = np.full((nz, nx), VS_PINNED, np.float32)
    rho = np.full((nz, nx), RHO_PINNED, np.float32)

    grid = Grid2D(nz=nz, nx=nx, dx=cfg.dx, nt=cfg.nt, dt=cfg.dt,
                  pml_width=cfg.pml_width, free_surface=cfg.free_surface)
    check_cfl(float(vp.max()), grid)
    ecfg = ElasticConfig(grid=grid, chunk=cfg.chunk, vmax_pml=6000.0)
    wav = ricker(cfg.freq, cfg.nt, cfg.dt, device=device)
    acq = elastic_line(cfg.num_shots, cfg.num_receivers, nx, nz,
                       src_row=cfg.extras["src_depth_row"],
                       rcv_row=cfg.extras["rcv_depth_row"])
    geom = tuple(torch.as_tensor(a, dtype=torch.int32, device=device)
                 for a in (acq.src_z, acq.src_x, acq.rcv_z, acq.rcv_x))
    print(f"simulating {cfg.num_shots} marine shots ({nz}x{nx} @ "
          f"dx={cfg.dx}, nt={cfg.nt}) with the split-PML scheme on "
          f"{device} ...", flush=True)
    with torch.no_grad():
        ovx, ovz = simulate_elastic(
            *(torch.as_tensor(a, device=device) for a in (vp, vs, rho)), wav,
            *geom, ecfg)
    ovx, ovz = ovx.cpu().numpy(), ovz.cpu().numpy()  # [ns, nt, nr]

    su_dir = su_dir or (out.rstrip("/") + "_su")
    os.makedirs(su_dir, exist_ok=True)
    dt_us = int(round(cfg.dt * 1e6))
    for k in range(cfg.num_shots):
        write_su_gather(os.path.join(su_dir, f"seis_x.su.shot{k + 1}"),
                        ovx[k].T, dt_us)
        write_su_gather(os.path.join(su_dir, f"seis_y.su.shot{k + 1}"),
                        ovz[k].T, dt_us)
    shape, dt_read = prepare_su_observed(su_dir, out)

    # the starting model (trainC, /100 hectometer units): smoothed vp and
    # the pinned vs/rho; field practice has no trainB, so the loader falls
    # back to C for the (unused) oracle metric
    c = np.stack([smooth_model(vp, iters=40, preserve_rows=0), vs,
                  rho]) / 100.0
    d = os.path.join(out, "trainC")
    os.makedirs(d, exist_ok=True)
    np.save(os.path.join(d, "0.npy"), c.astype(np.float32))
    # the truth on the side for reporting; the engine never reads it
    oracle = os.path.join(out, "trainB_oracle.npy")
    np.save(oracle, np.stack([vp, vs, rho]) / 100.0)
    return {"shape": list(shape), "dt": dt_read, "su_dir": su_dir,
            "trainC": os.path.join(d, "0.npy"), "oracle": oracle}


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Build a field-marine SU dataset for real_data "
                    "(PyTorch port)")
    p.add_argument("--out", required=True)
    p.add_argument("--su-dir", default=None,
                   help="where to write the SU shot files "
                        "(default <out>_su)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; fails when "
                        "none is visible -- pass cpu to run on the CPU)")
    args = p.parse_args(argv)

    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    rec = make_realdata_su(get_workload("real_data"), args.out, args.su_dir,
                           device=args.device)
    print(f"ingested SU {tuple(rec['shape'])} dt={rec['dt']}s from "
          f"{rec['su_dir']}")
    print(f"wrote start triple to {os.path.dirname(rec['trainC'])}; oracle "
          f"vp kept at {rec['oracle']}")


if __name__ == "__main__":
    main()
