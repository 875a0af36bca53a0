#!/usr/bin/env python3
"""Time kernels B5 and B6 of several source trees in turns on one card.

Run from the root of a checkout on a machine with one CUDA card:
``python3 variant_turns.py DIR [DIR ...]``, each DIR the root of another
tree of this repository (an unpacked ``git archive`` of another commit,
or a copy with one change), the checkout itself being ``.``.  Each tree
builds its kernels into its own ``build/torch_kernels/`` and is timed in
a process of its own, the trees in order and then in reverse order (A,
B, B, A), so that the card's drift shows in each tree's two turns.  A
turn prints the tree's registers and spills of the resident kernels
(nvcc -Xptxas -v), and at the flagship shape (18 shots, 192 x 256
padded, nt 4001) resident B5 and B6 in ms (a warm-up call, then the
mean of 3, CUDA events) and whether B6 equals its per-step route.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path


def turn(tag: str) -> None:
    """One turn, in the tree that is the working directory."""
    sys.path.insert(0, str(Path.cwd()))
    import torch

    import chip_smoke as cs
    from physicsbasedfwi2_tpu_torch.ops import cuda_build
    from physicsbasedfwi2_tpu_torch.ops.adjoint import (
        K_CKPT, acoustic_pallas_backward)
    from physicsbasedfwi2_tpu_torch.ops.kernels import acoustic_forward_pallas
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import scatter_rows
    _, _, log = cuda_build.build()
    for line in cs.ptxas_summary(log, ("ac_fwd_resident", "ac_rev_resident")):
        print(f"{tag} ptxas {line}")
    dev = torch.device("cuda:0")
    cfg, wav, geom, vp, vp0 = cs.flagship_case(dev)
    g = cfg.grid
    recs = acoustic_forward_pallas(vp0, wav, *geom, cfg)
    obs = acoustic_forward_pallas(vp, wav, *geom, cfg)
    rows = scatter_rows(2.0 * (recs - obs) / recs.numel(), geom[3], nt=g.nt,
                        nx=g.nx, pml_width=g.pml_width, KC=K_CKPT)
    _, ms5 = cs.timed_ms(lambda: acoustic_forward_pallas(
        vp0, wav, *geom, cfg), repeats=3)
    gk, ms6 = cs.timed_ms(lambda: acoustic_pallas_backward(
        vp0, wav, *geom, cfg, rows), repeats=3)
    per = acoustic_pallas_backward(vp0, wav, *geom, cfg, rows,
                                   route="per_step")
    print(f"{tag}: B5 resident {ms5:.2f} ms ({ms5 / g.nt * 1e3:.3f} us a "
          f"step), B6 resident {ms6:.2f} ms; B6 equal to its per-step route: "
          f"{torch.equal(gk, per)}", flush=True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--turn"] and len(argv) == 2:
        turn(argv[1])
        return 0
    if not argv or argv[0].startswith("-"):
        print("usage: variant_turns.py DIR [DIR ...]", file=sys.stderr)
        return 2
    dirs = [Path(d).resolve() for d in argv]
    for d in dirs + dirs[::-1]:
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--turn", d.name or str(d)], cwd=d, check=True,
                       timeout=600)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
