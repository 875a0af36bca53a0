"""Evaluation (port of ``physicsbasedfwi2_tpu/engine/test.py``,
``fwi-test``).

Load a checkpoint into a new engine, decode its model and write
``model.npy`` and ``metrics.json`` (the validation losses) under
``results/<name>/epoch_<tag>/``; with ``--realization N > 1`` on an
elastic engine, the MC-dropout ensemble's ``mc_mean.npy`` and
``mc_std.npy`` instead of ``model.npy``.  Run it as

    python -m physicsbasedfwi2_tpu_torch.engine.test \\
        --workload marmousi_elastic_robust --epoch selected

on the first CUDA card, or with ``--device cpu``; ``--dataroot`` builds
the engine on a prepped npy tree (``data/prep.py``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from physicsbasedfwi2_tpu_torch.engine.config import (
    get_workload, list_workloads, parse_set_overrides,
)
from physicsbasedfwi2_tpu_torch.engine.engines import (
    create_engine, default_device,
)


def evaluate(cfg, *, epoch="latest", realizations: int = 1,
             results_dir: str = "./results", workload=None, device=None,
             engine=None):
    """Decode the checkpoint ``epoch`` (a fresh engine where there is
    none) and write its model and validation metrics; returns the
    metrics.  With ``realizations > 1`` on an engine with
    ``mc_realizations``, write the ensemble's mean and standard
    deviation (numpy's, ddof 0) instead of the model, and add
    ``realizations`` and ``mc_std_mean`` to the metrics.  ``device``:
    where the engine runs (default: the first CUDA card; raises when
    there is none).  ``engine``: load the checkpoint into a pre-built
    engine instead of ``create_engine(cfg)`` (a latent engine with its
    pretrained decoder, which the checkpoint does not hold)."""
    if engine is None:
        kw = {"device": device if device is not None else default_device()}
        if workload is not None:
            kw["workload"] = workload
        engine = create_engine(cfg, **kw)
    try:
        engine.load_networks(epoch)
    except FileNotFoundError:
        pass  # a fresh engine (e.g. smoke tests)
    outdir = os.path.join(results_dir, cfg.name, f"epoch_{epoch}")
    os.makedirs(outdir, exist_ok=True)
    if realizations > 1 and hasattr(engine, "mc_realizations"):
        samples = engine.mc_realizations(realizations)
        std = samples.std(0)
        np.save(os.path.join(outdir, "mc_mean.npy"), samples.mean(0))
        np.save(os.path.join(outdir, "mc_std.npy"), std)
        losses, _ = engine.test()
        result = {"realizations": realizations,
                  "mc_std_mean": float(std.mean()), **losses}
    else:
        losses, img = engine.test()
        np.save(os.path.join(outdir, "model.npy"), img)
        result = dict(losses)
    with open(os.path.join(outdir, "metrics.json"), "w") as f:
        json.dump(result, f)
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description="FWI evaluation (PyTorch port)")
    p.add_argument("--workload", default="marmousi_acoustic",
                   choices=list_workloads())
    p.add_argument("--name", default=None)
    p.add_argument("--epoch", default="latest")
    p.add_argument("--realization", type=int, default=1)
    p.add_argument("--results-dir", default="./results")
    p.add_argument("--save-dir", default=None)
    p.add_argument("--dataroot", default=None,
                   help="npy tree in the reference's contract "
                        "(data/prep.py); default: synthetic workload")
    p.add_argument("--small", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda:0; fails when no "
                        "CUDA card is visible -- pass cpu to run the "
                        "kernels' plain versions on the CPU)")
    p.add_argument("--set", action="append", default=[],
                   metavar="FIELD=VALUE", dest="set_fields",
                   help="override any ExperimentConfig field (see the "
                        "train CLI's --set)")
    args = p.parse_args(argv)
    # the train CLI's precedence: dedicated flags, then --set, then --name
    overrides = {}
    if args.save_dir:
        overrides["save_dir"] = args.save_dir
    if args.dataroot:
        overrides["dataroot"] = args.dataroot
    try:
        overrides.update(parse_set_overrides(args.set_fields))
    except ValueError as e:
        p.error(str(e))
    cfg = get_workload(args.workload, **overrides)
    if args.name:
        cfg = cfg.replace(name=args.name)
    if args.small:
        cfg = cfg.replace(nz=48, nx=64, nt=300, num_shots=4,
                          num_receivers=32, filters=(4, 8, 16),
                          chunk=25, water_rows=6)
    result = evaluate(cfg, epoch=args.epoch,
                      realizations=args.realization,
                      results_dir=args.results_dir, device=args.device)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
