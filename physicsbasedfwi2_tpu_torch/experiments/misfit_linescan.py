"""Misfit-informativeness line scan for an elastic dataroot (port of
``benchmarks/misfit_linescan.py``).

The diagnostic behind the elastic recipe (docs/RESULTS.md): evaluate
each candidate misfit with all shots along two 1-D model paths

    T: m(a) = lowf + a (truth - lowf)        a in [0, 1]
    D: m(a) = lowf + a (drift - lowf)        drift = a trained
                                             checkpoint's decoded model

and report whether the misfit (1) decreases monotonically along T, (2)
ranks J(truth) well below the drift direction, (3) is ~0 at the truth
(it cannot be when the inversion simulates with another rho than the one
that made the gathers: the fixed-rho floor this tool measured at 2/3 of
the landscape's dynamic range, which motivated ``prep --rho-start
true``).

Each point is one forward simulation of every shot through the engine's
``_sim``: on the fused path the ring forward (B3's forward sweep, on the
card its resident route where a plan holds the grid).

Usage:
    python -m physicsbasedfwi2_tpu_torch.experiments.misfit_linescan \\
        --dataroot dataroots/marm_elastic_kd [--drift-run runs/probe] \\
        [--fc 20] [--workload marmousi_elastic] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from physicsbasedfwi2_tpu_torch.engine import create_engine, get_workload
from physicsbasedfwi2_tpu_torch.geo.filters import lowpass_filter_time
from physicsbasedfwi2_tpu_torch.ops import trace_normalize

ALPHAS = (0.0, 0.25, 0.5, 0.75, 1.0)


def _mean(x: torch.Tensor) -> float:
    return float(torch.mean(x))


@torch.no_grad()
def linescan(cfg, *, drift_run: str | None = None, drift_tag="latest",
             fc: float = 20.0, alphas=ALPHAS, device=None) -> list[dict]:
    """The scan's records for the elastic workload ``cfg`` on ``device``
    (default the card): with ``drift_run`` (a run directory holding
    ``<drift_tag>_net_G.npz``) first ``{"drift_mse", "lowf_mse"}``, then
    for each path and ``a`` in ``alphas`` the model MSE and the ``l2``,
    ``snl2``, ``tnl1`` and ``tnl2`` misfits, rounded as the JAX tool
    prints them."""
    if drift_run:
        cfg = cfg.replace(name=os.path.basename(drift_run),
                          save_dir=os.path.dirname(drift_run) or ".")
    eng = create_engine(cfg, device=device)
    wl = eng.wl
    names = eng.field_names
    lowf = torch.stack([wl.start[k] for k in names], -1)
    truth = torch.stack([wl.true[k] for k in names], -1)

    records = []
    paths = [("T(truth)", truth)]
    if drift_run:
        eng.load_networks(drift_tag)
        drift = eng._decode()[0]
        records.append({"drift_mse": _mean((drift - truth) ** 2),
                        "lowf_mse": _mean((lowf - truth) ** 2)})
        paths.append(("D(drift)", drift))

    # Band-limit the raw gathers here rather than through
    # eng._stage_data: for snl2-configured workloads _stage_data returns
    # gathers already divided by the per-shot RMS, so a scaling
    # recomputed from them is ~1 and the reported snl2 would silently
    # equal l2.  The scan must stay independent of cfg.misfit: it is the
    # tool that ranks the candidates.
    if fc > 0:
        wav = lowpass_filter_time(wl.wavelet, fc, cfg.dt, axis=-1)
        ovx = lowpass_filter_time(wl.obs_vx, fc, cfg.dt, axis=1)
        ovz = lowpass_filter_time(wl.obs_vz, fc, cfg.dt, axis=1)
    else:
        wav, ovx, ovz = wl.wavelet, wl.obs_vx, wl.obs_vz
    s = torch.clamp(torch.sqrt(torch.mean(ovx ** 2 + ovz ** 2, dim=(1, 2),
                                          keepdim=True)), min=1e-30)
    tox, toz = trace_normalize(ovx), trace_normalize(ovz)

    def misfits(m):
        vp, vs = m[..., 0], m[..., 1]
        rho = m[..., 2] if len(names) == 3 else wl.start["rho"]
        pvx, pvz = eng._sim(vp, vs, rho, wav, *wl.geom, wl.cfg)
        tpx, tpz = trace_normalize(pvx), trace_normalize(pvz)
        return {"l2": _mean((pvx - ovx) ** 2) + _mean((pvz - ovz) ** 2),
                "snl2": (_mean((pvx / s - ovx / s) ** 2)
                         + _mean((pvz / s - ovz / s) ** 2)),
                "tnl1": _mean(torch.abs(tpx - tox))
                + _mean(torch.abs(tpz - toz)),
                "tnl2": _mean((tpx - tox) ** 2) + _mean((tpz - toz) ** 2)}

    for tag, target in paths:
        for a in alphas:
            m = lowf + a * (target - lowf)
            m[: cfg.water_rows] = lowf[: cfg.water_rows]
            records.append(
                {"path": tag, "a": a,
                 "mse": round(_mean((m - truth) ** 2), 1),
                 **{k: round(v, 8) for k, v in misfits(m).items()}})
    return records


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Misfit line scan for an elastic dataroot (PyTorch "
                    "port)")
    p.add_argument("--dataroot", required=True)
    p.add_argument("--workload", default="marmousi_elastic")
    p.add_argument("--drift-run", default=None,
                   help="run dir with <tag>_net_G.npz checkpoints; "
                        "its decoded model defines path D")
    p.add_argument("--drift-tag", default="latest")
    p.add_argument("--fc", type=float, default=20.0)
    p.add_argument("--alphas", default="0,0.25,0.5,0.75,1.0")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; fails when "
                        "none is visible -- pass cpu to run the kernels' "
                        "plain versions on the CPU)")
    args = p.parse_args(argv)

    cfg = get_workload(args.workload, dataroot=args.dataroot)
    for rec in linescan(cfg, drift_run=args.drift_run,
                        drift_tag=args.drift_tag, fc=float(args.fc or 0.0),
                        alphas=[float(a) for a in args.alphas.split(",")],
                        device=args.device):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
