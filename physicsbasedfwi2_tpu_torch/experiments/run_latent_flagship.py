"""The latent-inversion trajectory of BASELINE config 4 (port of
``benchmarks/run_latent_flagship.py``).

The reference's two-stage pipeline (VaeNoPhy/Vaevel pretraining, then
VaeLatent2NoPhy latent inversion, VaeLatent2NoPhy_model.py:395-560) as
one program: pretrain a model-domain VAE on a synthetic model bank,
freeze its decoder, and invert the latent through the acoustic
propagator at the registered ``latent_inversion`` geometry, logging the
standard metrics.jsonl/PNG artifacts through ``engine.train``.  The
checkpoints hold the latent alone (``{"z": z}``), not the decoder.

Usage:
    python -m physicsbasedfwi2_tpu_torch.experiments.run_latent_flagship \\
        --epochs 400 --name latent_r5 --save-dir runs_r5 [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from physicsbasedfwi2_tpu_torch.device import default_device
from physicsbasedfwi2_tpu_torch.engine import create_engine, get_workload
from physicsbasedfwi2_tpu_torch.engine.pretrain import (
    make_model_bank, pretrain_model_vae)
from physicsbasedfwi2_tpu_torch.engine.train import train


def run_latent_flagship(cfg, *, epochs: int, pretrain_epochs: int = 300,
                        bank: int = 48, seed: int = 0, device=None):
    """Pretrain a :class:`ModelVae` for ``pretrain_epochs`` on a bank of
    ``bank`` models of ``cfg``'s grid (seeds from ``seed + 3``), then
    train ``cfg``'s latent inversion through its frozen decoder for
    ``epochs`` epochs on ``device`` (default the card).  Returns (the
    pretraining's recon losses, the inversion's engine, its history);
    the engine holds the frozen VAE (``net``) and its ``decoder_norm``."""
    device = torch.device(device if device is not None else default_device())
    print(f"pretraining VAE on a {bank}-model bank ({cfg.nz}x{cfg.nx}) "
          f"...", flush=True)
    models = make_model_bank(bank, cfg.nz, cfg.nx, water_rows=6,
                             seed=seed + 3)
    net, norm, hist = pretrain_model_vae(
        models, latent_dim=cfg.latent_dim, filters=cfg.filters,
        epochs=pretrain_epochs, batch_size=8, lr=2e-3, device=device)
    print(f"pretrain recon loss {hist[0]:.4f} -> {hist[-1]:.4f}", flush=True)
    eng = create_engine(cfg, decoder_net=net, decoder_norm=norm,
                        device=device)
    eng, history = train(cfg, epochs=epochs, engine=eng)
    return hist, eng, history


def main(argv=None):
    p = argparse.ArgumentParser(
        description="BASELINE config 4: VAE pretraining, then latent "
                    "inversion (PyTorch port)")
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--pretrain-epochs", type=int, default=300)
    p.add_argument("--bank", type=int, default=48)
    p.add_argument("--name", default="latent_r5")
    p.add_argument("--save-dir", default="runs_r5")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; fails when "
                        "none is visible -- pass cpu to run on the CPU)")
    args = p.parse_args(argv)

    cfg = get_workload("latent_inversion").replace(
        name=args.name, save_dir=args.save_dir, seed=args.seed)
    run_latent_flagship(cfg, epochs=args.epochs,
                        pretrain_epochs=args.pretrain_epochs, bank=args.bank,
                        seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
