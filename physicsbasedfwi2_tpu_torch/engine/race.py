"""Seed racing with unsupervised selection (port of
``physicsbasedfwi2_tpu/engine/race.py``, ``fwi-race``).

Train each of K generator seeds for a probe budget, rank them by their
best held-out misfit (``loss_H``) in the last continuation stage each
reached, and spend the rest of the budget on the winner alone, resumed
from its ``selected`` checkpoint.  Run it as

    python -m physicsbasedfwi2_tpu_torch.engine.race \\
        --workload marmousi_elastic_robust --seeds 0,1,2 \\
        --probe-epochs 1500 --epochs 4500

on the first CUDA card, or with ``--device cpu``.

Two behaviours of the reference are kept, so that the two packages rank
seeds alike (ROADMAP Queue C): each seed is ranked at the highest stage
that seed reached, so seeds may be compared on different bands; and the
continuation restarts the stage ladder at its first stage, where it can
overwrite the probe's ``selected`` checkpoint.
"""

from __future__ import annotations

import json
import os


def race(cfg, seeds=(0, 1, 2), probe_epochs: int = 1500,
         epochs: int | None = None, quiet: bool = False, device=None):
    """Race ``seeds`` for ``probe_epochs`` each, then continue the
    branch with the best final-stage ``loss_H`` to ``epochs``.

    Returns ``(winner_seed, per_seed_summaries, engine, history)``;
    ``history`` is the winner's probe and continuation, ``engine`` the
    continuation's (None without one).  Needs ``cfg.holdout_shots > 0``.
    """
    from physicsbasedfwi2_tpu_torch.engine.train import train

    if cfg.holdout_shots <= 0:
        raise ValueError("race() ranks by held-out misfit; the "
                         "workload needs holdout_shots > 0")
    summaries = []
    histories = {}
    for s in seeds:
        c = cfg.replace(seed=int(s), name=f"{cfg.name}_s{s}")
        if not quiet:
            print(f"[race] probing seed {s} for {probe_epochs} epochs")
        _, hist = train(c, epochs=probe_epochs, quiet=quiet, device=device)
        # the highest stage this seed reached (the reference's ranking)
        fstage = max(r["freq_stage"] for r in hist
                     if r.get("freq_stage") is not None)
        hs = [(r["loss_H"], r["epoch"]) for r in hist
              if "loss_H" in r and r.get("freq_stage") == fstage]
        if not hs:
            raise RuntimeError(
                f"seed {s}: no final-stage loss_H was logged "
                f"(probe_epochs too small for the ladder?)")
        best_h, best_e = min(hs)
        summaries.append({"seed": int(s), "best_loss_H": best_h,
                          "best_epoch": best_e,
                          "final_loss_H": hs[-1][0]})
        histories[int(s)] = hist
        if not quiet:
            print(f"[race] seed {s}: best final-stage loss_H "
                  f"{best_h:.4f} @ epoch {best_e}")
    win = min(summaries, key=lambda r: r["best_loss_H"])
    wseed = win["seed"]
    if not quiet:
        print(f"[race] winner: seed {wseed} "
              f"(loss_H {win['best_loss_H']:.4f})")
    hist = histories[wseed]
    cw = cfg.replace(seed=wseed, name=f"{cfg.name}_s{wseed}")
    eng = None
    if epochs is not None and epochs > probe_epochs:
        # resume the winner from its 'selected' checkpoint; the ladder
        # restarts at stage 0, as in the reference
        eng, hist2 = train(cw, epochs=epochs, quiet=quiet,
                           continue_from="selected",
                           start_epoch=probe_epochs + 1, device=device)
        hist = hist + hist2
    return wseed, summaries, eng, hist


def main(argv=None):
    import argparse

    from physicsbasedfwi2_tpu_torch.engine.config import (
        get_workload, parse_set_overrides)

    p = argparse.ArgumentParser(
        description="seed race with unsupervised selection (PyTorch port)")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--probe-epochs", type=int, default=1500)
    p.add_argument("--epochs", type=int, default=None,
                   help="total budget for the winning branch")
    p.add_argument("--name", default=None)
    p.add_argument("--save-dir", default="./checkpoints")
    p.add_argument("--dataroot", default=None,
                   help="npy tree in the reference's contract "
                        "(data/prep.py); default: synthetic workload")
    p.add_argument("--small", action="store_true",
                   help="shrink the workload for smoke testing")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda:0; pass cpu to run "
                        "the kernels' plain versions on the CPU)")
    p.add_argument("--set", action="append", default=[],
                   metavar="FIELD=VALUE", dest="overrides")
    args = p.parse_args(argv)
    try:
        cfg = get_workload(args.workload,
                           **parse_set_overrides(args.overrides))
    except ValueError as e:
        p.error(str(e))
    cfg = cfg.replace(name=args.name or f"race_{args.workload}",
                      save_dir=args.save_dir)
    if args.dataroot:
        cfg = cfg.replace(dataroot=args.dataroot)
    if args.small:
        cfg = cfg.replace(nz=48, nx=64, nt=300, num_shots=4,
                          num_receivers=32, filters=(4, 8, 16),
                          chunk=25, water_rows=6)
    seeds = [int(s) for s in args.seeds.split(",") if s != ""]
    wseed, summaries, _, _ = race(
        cfg, seeds=seeds, probe_epochs=args.probe_epochs,
        epochs=args.epochs, device=args.device)
    out = {"winner_seed": wseed, "seeds": summaries,
           "probe_epochs": args.probe_epochs, "epochs": args.epochs}
    path = os.path.join(cfg.save_dir, f"{cfg.name}_race.json")
    os.makedirs(cfg.save_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
