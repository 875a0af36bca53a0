"""Metrics logging and image dumps.

Replaces the reference's visdom-based ``Visualizer``
(util/visualizer.py:75-258) with dependency-light logging: an
append-only ``loss_log.txt`` (same role as visualizer.py:111-115), a
JSONL metrics stream, periodic PNG snapshots of the current model,
and a static HTML gallery (util/html.py role).
"""

from __future__ import annotations

import json
import os

import numpy as np


class Visualizer:
    def __init__(self, cfg, *, image_every: int = 25):
        self.dir = os.path.join(cfg.save_dir, cfg.name)
        os.makedirs(self.dir, exist_ok=True)
        self.log_path = os.path.join(self.dir, "loss_log.txt")
        self.jsonl_path = os.path.join(self.dir, "metrics.jsonl")
        self.image_every = image_every
        self.images: list[str] = []
        with open(self.log_path, "a") as f:
            f.write(f"================ Training Loss ({cfg.name}) "
                    f"================\n")

    def dump_config(self, cfg):
        """Options dump (the reference's train_opt.txt,
        base_options.py:95-118)."""
        import dataclasses
        with open(os.path.join(self.dir, "train_opt.txt"), "w") as f:
            f.write("----------------- Options ---------------\n")
            for k, v in sorted(dataclasses.asdict(cfg).items()):
                f.write(f"{k}: {v}\n")
            f.write("----------------- End -------------------\n")

    def log_epoch(self, record: dict, *, model_img: np.ndarray | None = None):
        msg = " ".join(
            f"{k}: {v:.6g}" if isinstance(v, (int, float)) and v is not None
            else f"{k}: {v}" for k, v in record.items())
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        ep = record.get("epoch", 0)
        if model_img is not None and ep % self.image_every == 0:
            self._save_image(model_img, f"model_epoch{ep}.png")

    def _save_image(self, img: np.ndarray, fname: str):
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            img = np.asarray(img)
            if img.ndim == 3:
                img = img[..., 0]
            fig, ax = plt.subplots(figsize=(6, 3.5))
            im = ax.imshow(img, cmap="viridis", aspect="auto")
            fig.colorbar(im, ax=ax, shrink=0.8)
            fig.tight_layout()
            path = os.path.join(self.dir, fname)
            fig.savefig(path, dpi=90)
            plt.close(fig)
            self.images.append(fname)
            self._write_gallery()
        except Exception:
            np.save(os.path.join(self.dir, fname.replace(".png", ".npy")),
                    img)

    def _write_gallery(self):
        """Minimal static HTML gallery (util/html.py role)."""
        rows = "\n".join(
            f'<div style="display:inline-block;margin:4px">'
            f'<img src="{f}" width="360"><br><small>{f}</small></div>'
            for f in self.images)
        with open(os.path.join(self.dir, "index.html"), "w") as f:
            f.write(f"<html><body><h3>Results</h3>{rows}</body></html>")
