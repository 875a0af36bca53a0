""".npy directory datasets with the reference's on-disk contract (port
of ``physicsbasedfwi2_tpu/data/npy_datasets.py``, plain numpy as there).

The reference's data factory (data/__init__.py:71-97) maps a
``dataset_mode`` name to a Dataset class reading
``<dataroot>/<phase><Letter>/*.npy`` directories:

- unalignedVelABCD2 (acoustic FWI): A = shot gathers
  [nsrc, nt, nrec], B = velocity model, C = low-frequency model,
  D.. extras (unalignedVelABCD2_dataset.py:29-99).
- unalignedVelABCDEl (elastic FWI): A = vx shots, B = [Vp;Vs;Rho]/100,
  C = low-freq triple /100, D = vz shots
  (unalignedVelABCDEl_dataset.py:73-146).

Here one generic dataset covers all modes via a letters spec; a
registry maps the reference mode names to letter layouts.  No torch:
plain numpy with a shuffling batch iterator (the workload builders move
the arrays to the device once).
"""

from __future__ import annotations

import os
from collections.abc import Iterator

import numpy as np

_MODES: dict[str, dict] = {}


def register_dataset(name: str, *, letters: str, scale: dict | None = None):
    _MODES[name.lower()] = {"letters": letters, "scale": scale or {}}


# reference mode names -> directory letters
register_dataset("unalignedVelABCD2", letters="ABCD")
register_dataset("unalignedVelABCDEl", letters="ABCD",
                 scale={"B": 100.0, "C": 100.0})  # stored /100 (SI = x100)
# Latent2 (unalignedVelLatent2_dataset.py:29-32, 63-67): dirs A
# (gathers, runtime x10 amplitude conditioning preserved) and B
# (velocity, stored in m/s — the reference's /1000 rescale was input
# conditioning for its km/s-range decoder, undone here so physics
# stays SI)
register_dataset("unalignedVelLatent2", letters="AB",
                 scale={"A": 10.0})
register_dataset("unaligned2", letters="AB")
register_dataset("unalignedAC2", letters="AC")
register_dataset("unalignedBD2", letters="BD")
register_dataset("unalignedBDE2", letters="BDE")


class NpyDictDataset:
    """Iterates dicts {letter: np.ndarray, f"{letter}_paths": str}."""

    def __init__(self, dataroot: str, mode: str = "unalignedVelABCD2",
                 phase: str = "train", max_size: int | None = None):
        spec = _MODES[mode.lower()]
        self.letters = spec["letters"]
        self.scale = spec["scale"]
        self.paths = {}
        n = None
        for L in self.letters:
            d = os.path.join(dataroot, phase + L)
            files = sorted(
                os.path.join(d, f) for f in os.listdir(d)
                if f.endswith(".npy")) if os.path.isdir(d) else []
            if max_size:
                files = files[:max_size]
            self.paths[L] = files
            if files:
                n = len(files) if n is None else min(n, len(files))
        self.n = n or 0

    def __len__(self):
        return self.n

    def __getitem__(self, i: int) -> dict:
        out = {}
        for L in self.letters:
            if not self.paths[L]:
                continue
            p = self.paths[L][i % len(self.paths[L])]
            a = np.load(p).astype(np.float32)
            if L in self.scale:
                a = a * self.scale[L]
            out[L] = a
            out[f"{L}_paths"] = p
        return out

    def batches(self, batch_size: int, *, shuffle: bool = True,
                seed: int = 0, drop_last: bool = False,
                flip: bool = False) -> Iterator[dict]:
        """Yield stacked batches {letter: [B, ...]}.

        ``flip=True`` randomly mirrors the lateral axis of every
        letter jointly (the *Flip dataset twins' augmentation,
        e.g. unaligned2Flip_dataset.py)."""
        idx = np.arange(self.n)
        rng = np.random.default_rng(seed)
        if shuffle:
            rng.shuffle(idx)
        for s in range(0, self.n, batch_size):
            sel = idx[s : s + batch_size]
            if drop_last and len(sel) < batch_size:
                return
            items = [self[int(i)] for i in sel]
            if flip:
                for it in items:
                    if rng.random() < 0.5:
                        for L in self.letters:
                            if L in it:
                                it[L] = np.ascontiguousarray(
                                    it[L][..., ::-1])
            batch = {}
            for L in self.letters:
                if L in items[0]:
                    batch[L] = np.stack([it[L] for it in items])
                    batch[f"{L}_paths"] = [it[f"{L}_paths"] for it in items]
            yield batch


def create_dataset(dataroot: str, mode: str, *, phase: str = "train",
                   max_size: int | None = None) -> NpyDictDataset:
    """Factory (reference data/__init__.py:71 ``create_dataset``);
    use phase='test' for the validation twin (``create_dataset2``
    role, data/__init__.py:85-97)."""
    return NpyDictDataset(dataroot, mode, phase=phase, max_size=max_size)
