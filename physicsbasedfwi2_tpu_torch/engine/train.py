"""Training loop (port of ``physicsbasedfwi2_tpu/engine/train.py``).

Epoch loop with validation at the top of each epoch, per-epoch
aggregated losses, frequency continuation (a plateau detector advances
the stage), periodic checkpointing and wall-clock metrics; the
supervised/GAN baselines' batch loop over a dataroot
(:func:`train_supervised`).  Run it as ``python -m
physicsbasedfwi2_tpu_torch.engine.train --workload marmousi_elastic``
(``--workload pix2pix_baseline --dataroot DIR`` for a supervised one);
it runs on the first CUDA card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time

import numpy as np
import torch

from physicsbasedfwi2_tpu_torch.data.npy_datasets import create_dataset
from physicsbasedfwi2_tpu_torch.engine.config import (
    ExperimentConfig, get_workload, list_workloads,
)
from physicsbasedfwi2_tpu_torch.engine.engines import (
    create_engine, default_device,
)
from physicsbasedfwi2_tpu_torch.engine.visualizer import Visualizer


class PlateauDetector:
    """Frequency-continuation plateau detector.

    mode="range": advance when the relative spread of the last N
    losses drops below eps.  mode="improve": advance when the median of
    the current window improves on the previous window's by less than
    eps (relative).  stage_max_epochs > 0 force-advances after that
    many epochs in the stage."""

    def __init__(self, history: int = 5, eps: float = 5e-10,
                 mode: str = "range", stage_max_epochs: int = 0):
        self.hist = collections.deque(maxlen=2 * history
                                      if mode == "improve" else history)
        self.window = history
        self.eps = eps
        self.mode = mode
        self.stage_max_epochs = stage_max_epochs
        self.epochs_in_stage = 0

    def _advance(self) -> bool:
        self.hist.clear()
        self.epochs_in_stage = 0
        return True

    def update(self, loss: float) -> bool:
        self.hist.append(loss)
        self.epochs_in_stage += 1
        if (self.stage_max_epochs
                and self.epochs_in_stage >= self.stage_max_epochs):
            return self._advance()
        if len(self.hist) < self.hist.maxlen:
            return False
        h = list(self.hist)
        if self.mode == "improve":
            def median(xs):
                xs = sorted(xs)
                n = len(xs)
                return (xs[n // 2] if n % 2 else
                        0.5 * (xs[n // 2 - 1] + xs[n // 2]))
            prev, cur = median(h[: self.window]), median(h[self.window:])
            rel = (prev - cur) / (abs(prev) + 1e-30)
            if rel <= self.eps:
                return self._advance()
            return False
        lo, hi = min(h), max(h)
        rel = (hi - lo) / (abs(hi) + 1e-30)
        if rel <= self.eps:
            return self._advance()
        return False


def _prep_img(x) -> np.ndarray:
    """A [B?, H, W(, C)] float array as float32 NHWC: a channel axis is
    added to 2-D and 3-D arrays."""
    x = np.asarray(x, np.float32)
    return x[..., None] if x.ndim in (2, 3) else x


def train_supervised(cfg: ExperimentConfig, *, epochs: int | None = None,
                     quiet: bool = False, device=None):
    """The supervised and GAN baselines' batch loop: each epoch iterates
    the dataroot's training batches (``cfg.batch_size``, shuffled from
    ``cfg.seed + epoch``, lateral flips with ``extras["flip"]``; numpy's
    order, the JAX loop's) through :class:`SupervisedEngine` on
    ``device`` (default: the first CUDA card; raises when there is none),
    then validates on the test twin's first sample where the twin holds
    every letter.  The dataset's first letter is the input and its second
    the target; further letters join the input's channels.  Checkpoints
    every ``cfg.save_epoch_freq`` epochs and at the last.

    Returns (engine, history)."""
    if not cfg.dataroot:
        raise ValueError(
            "supervised workloads need --dataroot (an npy tree with "
            f"{cfg.dataset_mode}'s letter directories)")
    ds = create_dataset(cfg.dataroot, cfg.dataset_mode)
    item0 = ds[0]
    letters = [L for L in "ABCDE" if L in item0]
    if len(letters) < 2:
        raise ValueError(f"need input+target dirs, found {letters}")
    la, lb = letters[0], letters[1]
    extra = letters[2:]

    def prep_in(item):
        parts = [_prep_img(item[L]) for L in (la, *extra)]
        return parts[0] if not extra else np.concatenate(parts, -1)

    a0, b0 = prep_in(item0), _prep_img(item0[lb])
    engine = create_engine(
        cfg, in_shape=a0.shape[:2], in_channels=a0.shape[-1],
        out_channels=b0.shape[-1],
        device=device if device is not None else default_device())
    dev = engine.device
    need = {la, lb, *extra}
    try:
        ds_val = create_dataset(cfg.dataroot, cfg.dataset_mode,
                                phase="test")
        if len(ds_val) == 0 or not need <= set(ds_val[0]):
            ds_val = None  # twin missing (or missing a needed letter)
    except (FileNotFoundError, OSError):
        ds_val = None
    viz = Visualizer(cfg)
    viz.dump_config(cfg)
    epochs = epochs if epochs is not None else cfg.n_epochs
    history = []
    flip = bool(cfg.extras.get("flip", False))
    for epoch in range(1, epochs + 1):
        t0 = time.time()
        agg = collections.defaultdict(float)
        nb = 0
        for batch in ds.batches(cfg.batch_size, seed=cfg.seed + epoch,
                                flip=flip):
            a = torch.from_numpy(prep_in(batch)).to(dev)
            b = torch.from_numpy(_prep_img(batch[lb])).to(dev)
            for k, v in engine.optimize_parameters(a, b,
                                                   epoch=epoch).items():
                agg[k] += v
            nb += 1
        rec = {"epoch": epoch,
               **{k: v / max(nb, 1) for k, v in agg.items()},
               "epoch_time": time.time() - t0}
        if ds_val is not None:
            it = ds_val[0]
            val, _ = engine.test(torch.from_numpy(prep_in(it)[None]),
                                 torch.from_numpy(_prep_img(it[lb])[None]))
            rec.update(val)
        history.append(rec)
        viz.log_epoch(rec)
        if epoch % cfg.save_epoch_freq == 0 or epoch == epochs:
            engine.save_networks(epoch)
            engine.save_networks("latest")
    return engine, history


def train(cfg: ExperimentConfig, *, epochs: int | None = None,
          iters_per_epoch: int = 1, workload=None, quiet: bool = False,
          continue_from: str | int | None = None, start_epoch: int = 1,
          profile_dir: str | None = None, profile_epochs: int = 0,
          engine=None, device=None):
    """Run the training loop; returns (engine, history).

    continue_from: checkpoint tag to resume weights from.
    engine: drive a pre-built engine instead of create_engine(cfg).
    device: where a new engine runs (default: the first CUDA card;
        raises when there is none).

    With ``cfg.freq_stages`` each epoch trains at the current stage's
    corner frequency; the stage advances when the plateau detector
    fires on the epoch's ``loss_D_MSE``, never during the ``lstart``
    warmup.

    With held-out shots (``cfg.holdout_shots``) the best final-stage
    ``loss_H`` epoch is saved as the ``selected`` checkpoint.  The drift
    guard (``cfg.guard_patience``, engines with ``guard_revert``) keeps
    the best ``loss_H`` of each stage with a snapshot of the generator's
    parameters (clones: the parameters change in place) and, after
    ``guard_patience`` evaluations above ``guard_tol`` x that best,
    reverts to the snapshot with a fresh optimizer.

    An engine with a mesh (``mesh=``, every rank of ``torchrun`` running
    this loop) writes its logs and checkpoints from the mesh's first
    rank only.

    With ``profile_dir`` and ``profile_epochs > 0`` a ``torch.profiler``
    trace of the first ``profile_epochs`` epochs is written to
    ``profile_dir/<name>.pt.trace.json`` (Chrome trace format): device
    activity only on a CUDA engine (a trace that also records the host
    did not finish a kernel-heavy epoch loop in 900 s), host activity on
    the CPU.

    Supervised/GAN workloads (``engine == "supervised"``) go to the batch
    loop over ``cfg.dataroot`` (:func:`train_supervised`).
    """
    if cfg.engine == "supervised":
        return train_supervised(cfg, epochs=epochs, quiet=quiet,
                                device=device)
    if engine is None:
        kw = {"device": device if device is not None else default_device()}
        if workload is not None:
            kw["workload"] = workload
        engine = create_engine(cfg, **kw)
    if continue_from is not None:
        engine.load_networks(continue_from)
        if not quiet:
            print(f"resumed weights from checkpoint {continue_from!r}")
    # under a mesh every rank runs this loop on the same weights: the
    # mesh's first rank alone writes the logs and checkpoints
    lead = getattr(engine, "mesh", None) is None or engine.mesh.rank == 0
    viz = Visualizer(cfg) if lead else None
    if lead:
        viz.dump_config(cfg)
    epochs = epochs if epochs is not None else cfg.n_epochs
    stages = list(cfg.freq_stages) or [None]
    stage_i = 0
    anneal_i = 0  # extra tether-decay steps fired past the final stage
    plateau = PlateauDetector(cfg.plateau_history, cfg.plateau_eps,
                              mode=cfg.plateau_mode,
                              stage_max_epochs=cfg.stage_max_epochs)
    history = []
    # unsupervised model selection: the best held-out misfit of the
    # final stage (loss_H scales jump at stage advances)
    best_h = float("inf")
    selected_epoch = None
    guard_on = (cfg.guard_patience > 0 and cfg.holdout_shots > 0
                and hasattr(engine, "guard_revert"))
    guard_best_h = float("inf")
    guard_snap = None
    guard_worse = 0
    guard_stage_i = 0
    guard_reverts = 0
    prof = None
    if profile_dir and profile_epochs > 0 and lead:
        prof = _start_profile(engine)
    for epoch in range(start_epoch, epochs + 1):
        t0 = time.time()
        # ---- validation first (the reference validates at epoch top) ----
        val_losses, model_img = engine.test()
        # ---- training iterations ----
        agg = collections.defaultdict(float)
        for _ in range(iters_per_epoch):
            if stages[stage_i] is not None:
                kw = ({"tether_stage": stage_i + anneal_i}
                      if cfg.tether_anneal_plateaus > 0 else {})
                losses = engine.optimize_parameters(
                    epoch, freq=stages[stage_i], **kw)
            else:
                losses = engine.optimize_parameters(epoch)
            for k, v in losses.items():
                agg[k] += v / iters_per_epoch
        # ---- drift guard (before the stage advance: this epoch's
        # loss_H was taken at the current stage's band) ----
        guard_fired = None
        if guard_on and epoch == cfg.lstart:
            # anchor snapshot at the warmup->physics boundary
            guard_best_h = engine.holdout_misfit(stages[stage_i])
            guard_snap = _snapshot(engine)
            guard_stage_i = stage_i
        elif guard_on and "loss_H" in agg and epoch > cfg.lstart:
            h = agg["loss_H"]
            if stage_i != guard_stage_i:
                guard_stage_i, guard_worse = stage_i, 0
                guard_best_h, guard_snap = h, _snapshot(engine)
            elif h < guard_best_h:
                guard_best_h, guard_snap = h, _snapshot(engine)
                guard_worse = 0
            elif h > cfg.guard_tol * guard_best_h:
                guard_worse += 1
                if (guard_worse >= cfg.guard_patience
                        and guard_snap is not None):
                    engine.guard_revert(guard_snap, epoch)
                    guard_worse = 0
                    guard_reverts += 1
                    guard_fired = epoch
                    if not quiet:
                        print(f"[drift-guard] loss_H {h:.4f} > "
                              f"{cfg.guard_tol:g} x stage best "
                              f"{guard_best_h:.4f}: reverted to the "
                              f"best-loss_H snapshot at epoch {epoch}")
            else:
                guard_worse = 0
        # ---- frequency continuation ----
        # (suspended during the lstart warmup: its physics loss is a
        # constant 0, a perfect "plateau" that would race the stage
        # index to the final frequency before inversion starts)
        key = "loss_D_MSE" if "loss_D_MSE" in agg else next(iter(agg))
        if (epoch > cfg.lstart and stages[stage_i] is not None
                and plateau.update(agg[key])):
            if stage_i + 1 < len(stages):
                stage_i += 1
                if not quiet:
                    print(f"[freq-continuation] advancing to stage "
                          f"{stages[stage_i]} Hz at epoch {epoch}")
            elif anneal_i < cfg.tether_anneal_plateaus:
                # final stage reached: each further plateau relaxes the
                # lowf tether one more tether_decay notch
                anneal_i += 1
                if not quiet:
                    tw = (cfg.tether_weight
                          * cfg.tether_decay ** (stage_i + anneal_i))
                    print(f"[tether-anneal] plateau at final stage: "
                          f"tether -> {tw:.4f} at epoch {epoch}")
        rec = {"epoch": epoch, **agg, **val_losses,
               "freq_stage": stages[stage_i],
               "epoch_time": time.time() - t0}
        if guard_fired is not None:
            rec["guard_revert"] = guard_fired
        if ("loss_H" in agg and stage_i == len(stages) - 1
                and agg["loss_H"] < best_h):
            best_h = agg["loss_H"]
            selected_epoch = epoch
            rec["selected_epoch"] = epoch
            if lead:
                engine.save_networks("selected")
        history.append(rec)
        if lead:
            viz.log_epoch(rec, model_img=model_img)
        if prof is not None and epoch - start_epoch + 1 == profile_epochs:
            path = _stop_profile(prof, profile_dir, cfg.name)
            prof = None
            if not quiet:
                print(f"profiler trace written to {path}")
        if lead and (epoch % cfg.save_epoch_freq == 0 or epoch == epochs):
            engine.save_networks(epoch)
            engine.save_networks("latest")
    if prof is not None:
        # fewer epochs than profile_epochs
        _stop_profile(prof, profile_dir, cfg.name)
    if selected_epoch is not None and not quiet:
        print(f"[early-stop] selected checkpoint: epoch {selected_epoch} "
              f"(held-out misfit {best_h:.6f}) -> tag 'selected'")
    if guard_on and not quiet:
        print(f"[drift-guard] {guard_reverts} revert(s) over "
              f"{epochs - start_epoch + 1} epochs")
    return engine, history


def _start_profile(engine):
    """A started ``torch.profiler`` over the engine's device: CUDA
    activity only on a card, CPU activity on the CPU."""
    from torch.profiler import ProfilerActivity, profile
    on_card = engine.device.type == "cuda"
    prof = profile(activities=[ProfilerActivity.CUDA if on_card
                               else ProfilerActivity.CPU])
    prof.start()
    return prof


def _stop_profile(prof, profile_dir: str, name: str) -> str:
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"{name}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


def _snapshot(engine) -> dict:
    """The generator's parameters as clones (a reference to the live
    tensors would follow every later step)."""
    return {k: v.detach().clone() for k, v in engine.net.state_dict().items()}


def main(argv=None):
    p = argparse.ArgumentParser(description="FWI training (PyTorch port)")
    p.add_argument("--workload", default="marmousi_acoustic",
                   choices=list_workloads())
    p.add_argument("--name", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--iters-per-epoch", type=int, default=1)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--optimizer", default=None)
    p.add_argument("--netG", default=None)
    p.add_argument("--lstart", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--save-dir", default=None)
    p.add_argument("--dataroot", default=None,
                   help="npy tree in the reference's contract "
                        "(data/prep.py); default: synthetic workload")
    p.add_argument("--small", action="store_true",
                   help="shrink the workload for smoke testing")
    p.add_argument("--continue-train", action="store_true",
                   help="resume from --epoch-tag (default latest)")
    p.add_argument("--epoch-tag", default="latest")
    p.add_argument("--start-epoch", type=int, default=1)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the first "
                        "--profile-epochs epochs here")
    p.add_argument("--profile-epochs", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda:0; fails when no "
                        "CUDA card is visible -- pass cpu to run the "
                        "kernels' plain versions on the CPU)")
    p.add_argument("--set", action="append", default=[],
                   metavar="FIELD=VALUE", dest="set_fields",
                   help="override any ExperimentConfig field; values "
                        "parse as python literals")
    args = p.parse_args(argv)

    overrides = {}
    for k in ("lr", "optimizer", "netG", "lstart", "seed"):
        v = getattr(args, k)
        if v is not None:
            overrides[k] = v
    if args.save_dir:
        overrides["save_dir"] = args.save_dir
    if args.dataroot:
        overrides["dataroot"] = args.dataroot
    from physicsbasedfwi2_tpu_torch.engine.config import parse_set_overrides
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
    _, history = train(
        cfg, epochs=args.epochs, iters_per_epoch=args.iters_per_epoch,
        continue_from=args.epoch_tag if args.continue_train else None,
        start_epoch=args.start_epoch, profile_dir=args.profile_dir,
        profile_epochs=args.profile_epochs if args.profile_dir else 0,
        device=args.device)
    print(json.dumps(history[-1]))


if __name__ == "__main__":
    main()
