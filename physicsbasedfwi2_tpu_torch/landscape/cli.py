"""Loss-surface CLI (port of ``physicsbasedfwi2_tpu/landscape/cli.py``,
``fwi-landscape``; the reference's ``plot_surface2.py`` role).

    python -m physicsbasedfwi2_tpu_torch.landscape.cli \\
        --workload marmousi_acoustic --small --x=-1:1:11 --y=-1:1:11

Loads (or initializes) the workload's engine, sweeps the physics data
misfit over two filter-normalized directions, writes the surface as
.npz (and on request .vtp and .h5) and a contour PNG where matplotlib is
installed, overlays a checkpoint trajectory, and reports extreme Hessian
eigenvalues.  It runs on the first CUDA card unless given ``--device``
(``--device cpu``: the kernels' plain versions).

The acoustic misfit simulates with ``simulate_acoustic`` (plain PyTorch)
against the engine's normalized observed gathers; the elastic one is the
engine's (``ElasticDIPEngine._physics_loss_raw``, on the fused path the
ring forward, a CUDA kernel on a card) on the first ``shots_per_iter``
shots at the first continuation stage.  The ring forward's kernel has
no gradient, so the elastic Hessian runs through its plain version,
``ops/elastic_fused.py::simulate_elastic_ring_plain``, which has one.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def _parse_range(s: str):
    lo, hi, n = s.split(":")
    return np.linspace(float(lo), float(hi), int(n))


def small_overrides(is_elastic: bool) -> dict:
    """The config fields that ``--small`` sets (the JAX CLI's)."""
    small = dict(nz=48, nx=64, nt=300, num_shots=4, num_receivers=32,
                 filters=(4, 8, 16), chunk=25, water_rows=6)
    if is_elastic:
        small.update(nt=160, dt=0.0015, num_receivers=20,
                     shots_per_iter=2, water_rows=4, pml_width=12)
    return small


def physics_loss(eng, *, differentiable: bool = False):
    """The engine's physics loss as (decode, misfit, data): the loss of
    parameters ``p`` (a dict by name) is ``misfit(decode(p, data),
    data)``; ``data`` holds the large inputs (net inputs, observed
    gathers).  ``differentiable`` puts the elastic misfit on a propagator
    with a gradient (the ring forward's plain version on the fused
    path)."""
    from physicsbasedfwi2_tpu_torch.engine.engines import _call
    from physicsbasedfwi2_tpu_torch.models import (
        apply_elastic_output, apply_velocity_output, pack_output)
    from physicsbasedfwi2_tpu_torch.ops import (
        simulate_acoustic, trace_normalize)
    from physicsbasedfwi2_tpu_torch.ops.elastic_fused import (
        simulate_elastic_ring_plain)
    cfg, wl = eng.cfg, eng.wl
    if cfg.engine == "elastic_dip":
        idx = torch.arange(cfg.shots_per_iter or cfg.num_shots,
                           device=eng.device)
        pd = eng._stage_pack(cfg.freq_stages[0] if cfg.freq_stages else 0.0)
        data = {"in_vx": eng.in_vx, "in_vz": eng.in_vz, "lowf": eng.lowf,
                "true_m": eng.true_m, "phys": pd}
        sim = (simulate_elastic_ring_plain
               if differentiable and eng._use_fused else None)

        def decode(params, data):
            deltas, _ = _call(eng.net, params, data["in_vx"], data["in_vz"])
            return apply_elastic_output(
                deltas, data["lowf"], data["true_m"],
                delta_scale=eng.delta_scale, clip_min=eng.clip_min,
                clip_max=eng.clip_max, pin_rows=cfg.water_rows)[0]

        def misfit(m, data):
            return eng._physics_loss_raw(m, idx, data["phys"], sim=sim)
    else:
        data = {"shots_in": eng.shots_in, "true_b": eng.true_b,
                "obs_norm": wl.obs_norm}

        def decode(params, data):
            out = pack_output(_call(eng.net, params, data["shots_in"]))
            return apply_velocity_output(out.field, data["true_b"],
                                         water_vel=cfg.water_vel)[0, :, :, 0]

        def misfit(vp, data):
            pred = simulate_acoustic(vp, wl.wavelet, *wl.geom, wl.cfg)
            return torch.mean((trace_normalize(pred) - data["obs_norm"]) ** 2)
    return decode, misfit, data


def _plot(path, xs, ys, surf, traj_coords, epoch_tags):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(5, 4))
    cs = ax.contourf(xs, ys, np.log10(surf + 1e-20), levels=20)
    fig.colorbar(cs, ax=ax, label="log10 loss")
    if traj_coords is not None:
        ax.plot(traj_coords[:, 0], traj_coords[:, 1], "w.-", lw=1.2, ms=4)
        ax.annotate(str(epoch_tags[0]), traj_coords[0], color="w",
                    fontsize=8)
        ax.annotate(str(epoch_tags[-1]), traj_coords[-1], color="w",
                    fontsize=8)
        ax.set_xlabel("PCA 1")
        ax.set_ylabel("PCA 2")
    else:
        ax.set_xlabel("d1")
        ax.set_ylabel("d2")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def main(argv=None, *, engine=None):
    """The CLI; returns the printed result.  ``engine``: a pre-built
    engine of the workload (its config stands in for the one the
    arguments name; ``--epoch`` still loads into it)."""
    p = argparse.ArgumentParser(description="loss surfaces (PyTorch port)")
    p.add_argument("--workload", default="marmousi_acoustic")
    p.add_argument("--name", default="landscape")
    p.add_argument("--epoch", default=None,
                   help="checkpoint tag to load (default: fresh init)")
    p.add_argument("--x", default="-1:1:11")
    p.add_argument("--y", default="-1:1:11")
    p.add_argument("--norm", default="filter", choices=["filter", "layer"])
    p.add_argument("--hessian", action="store_true",
                   help="also estimate extreme Hessian eigenvalues")
    p.add_argument("--vtp", action="store_true",
                   help="also export a ParaView .vtp surface")
    p.add_argument("--h5", action="store_true",
                   help="also export the reference's .h5 surface layout "
                        "(xcoordinates/ycoordinates/train_loss; needs "
                        "h5py)")
    p.add_argument("--vtp-log", action="store_true",
                   help="log-transform the .vtp z values")
    p.add_argument("--vtp-zmax", type=float, default=-1.0,
                   help="clip .vtp z values above this")
    p.add_argument("--out", default="./results/landscape")
    p.add_argument("--save-dir", default="./checkpoints")
    p.add_argument("--small", action="store_true")
    p.add_argument("--trajectory", default=None, metavar="CKPT_DIR",
                   help="directory of epoch-tagged *_net_G.npz "
                        "checkpoints: compute the surface in the "
                        "trajectory's top-2 PCA plane centered on the "
                        "final checkpoint and overlay the projected path")
    p.add_argument("--dataroot", default=None,
                   help="on-disk npy tree for the workload")
    p.add_argument("--set", action="append", default=[],
                   metavar="FIELD=VALUE", dest="overrides",
                   help="override any config field (fwi-train syntax)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda:0; fails when no "
                        "CUDA card is visible -- pass cpu to run the "
                        "kernels' plain versions on the CPU)")
    args = p.parse_args(argv)

    from physicsbasedfwi2_tpu_torch.device import default_device
    from physicsbasedfwi2_tpu_torch.engine import create_engine, get_workload
    from physicsbasedfwi2_tpu_torch.engine.config import parse_set_overrides
    from physicsbasedfwi2_tpu_torch.landscape import (
        composite_hvp, lanczos_extreme_eigs, loss_surface_2d, output_axes)

    cfg = get_workload(args.workload).replace(save_dir=args.save_dir)
    if args.dataroot:
        cfg = cfg.replace(dataroot=args.dataroot)
    if args.overrides:
        cfg = cfg.replace(**parse_set_overrides(args.overrides))
    if args.small:
        cfg = cfg.replace(**small_overrides(cfg.engine == "elastic_dip"))
    if engine is not None:
        eng, device = engine, engine.device
    else:
        device = (torch.device(args.device) if args.device
                  else default_device())
        eng = create_engine(cfg, device=device)
    if args.epoch:
        eng.load_networks(args.epoch)

    decode, misfit, data = physics_loss(eng)

    def loss_fn(params, data):
        return misfit(decode(params, data), data)

    params = {k: w.detach() for k, w in eng.net.named_parameters()}
    xs, ys = _parse_range(args.x), _parse_range(args.y)
    traj_coords = epoch_tags = None
    d1 = d2 = None
    if args.trajectory:
        from physicsbasedfwi2_tpu_torch.landscape.projection import (
            load_checkpoint_series, trajectory_pca, unflatten_like)
        epoch_tags, series = load_checkpoint_series(args.trajectory, params)
        coords, explained, comps = trajectory_pca(series)
        print(f"[trajectory] {len(series)} checkpoints "
              f"(epochs {epoch_tags[0]}..{epoch_tags[-1]}), PCA "
              f"explained ratio {explained[0]:.2f}/{explained[1]:.2f}")
        # surface in the PCA plane, centered on the FINAL checkpoint
        # (the reference's plot_surface --dir_file=PCA convention)
        params = {k: torch.as_tensor(a, device=device)
                  for k, a in series[-1].items()}
        d1 = unflatten_like(comps[0], params)
        d2 = unflatten_like(comps[1], params)
        traj_coords = coords
        # default ranges hug the trajectory extent (20% margin)
        if args.x == "-1:1:11" and args.y == "-1:1:11":
            pad = 0.2
            sx = max(1e-8, coords[:, 0].max() - coords[:, 0].min())
            sy = max(1e-8, coords[:, 1].max() - coords[:, 1].min())
            xs = np.linspace(coords[:, 0].min() - pad * sx,
                             coords[:, 0].max() + pad * sx, len(xs))
            ys = np.linspace(coords[:, 1].min() - pad * sy,
                             coords[:, 1].max() + pad * sy, len(ys))
    surf, d1, d2 = loss_surface_2d(loss_fn, params, xs=xs, ys=ys,
                                   norm=args.norm, d1=d1, d2=d2, data=data,
                                   out_axes=output_axes(eng.net))
    os.makedirs(args.out, exist_ok=True)
    stem = os.path.join(args.out, f"{args.name}_surface")
    extra = ({"traj_coords": traj_coords,
              "traj_epochs": np.asarray(epoch_tags)}
             if traj_coords is not None else {})
    np.savez(stem + ".npz", losses=surf, xs=xs, ys=ys, **extra)
    if args.h5:
        # the reference's surface-file layout (plot_surface2.py writes it,
        # h52vtp.py reads it back)
        import h5py
        with h5py.File(stem + ".h5", "w") as f:
            f["xcoordinates"] = xs
            f["ycoordinates"] = ys
            f["train_loss"] = surf
    if args.vtp:
        from physicsbasedfwi2_tpu_torch.landscape.vtp import surface_to_vtp
        surface_to_vtp(stem + ".vtp", surf, xs, ys, log=args.vtp_log,
                       zmax=args.vtp_zmax)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        pass
    else:
        _plot(stem + ".png", xs, ys, surf, traj_coords, epoch_tags)

    result = {"min": float(surf.min()), "max": float(surf.max()),
              "center": float(surf[len(ys) // 2, len(xs) // 2])}
    if args.hessian:
        hdecode, hmisfit, _ = physics_loss(eng, differentiable=True)

        def hvp_fn(p, v):
            return composite_hvp(lambda q: hdecode(q, data),
                                 lambda m: hmisfit(m, data), p, v)

        lo, hi, _ = lanczos_extreme_eigs(None, params, steps=10,
                                         hvp_fn=hvp_fn)
        result["eig_min"] = lo
        result["eig_max"] = hi
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
