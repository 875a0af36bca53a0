"""Attribute the resident forward sweep's time to its mechanisms (port of
the harness half of ``benchmarks/bench_kernel_breakdown.py``: ``time_fn``,
``measure_once``, ``main``).

Kernel B9 (``ops/kernel_breakdown.py::build_variant``) runs cumulative
variants of B2's forward sweep, each adding one suspect, at the
flagship shape (padded 192x256 grid, nt=4001, 18 shots):

  stencil   4th-order Laplacian + leapfrog + sponge only
  +src      dynamic-row source injection
  +rcv      receiver-row extraction into the history
  +ckpt     KC-strided checkpoint writes
  full      the production fused forward+misfit+adjoint kernel (B2,
            ``fwi_l1_loss_grad``)

The deltas between consecutive rows are the measured cost of each
mechanism; ``full`` minus the 3-sweep stencil projection is what loop
structure + misfit sweeps cost.  Each call is timed by ``time_fn``:
``--reps`` calls chained through a data dependency (the next call's
wavelet scale is ``1 + 0 * chk``), one host read at the end, after a
first call that builds or loads the kernel library.  Times are rounded
to the microsecond (the JAX harness rounded to 0.1 ms, calls ten times
longer).

``--compiles K`` runs K passes, pass k at nt + k (a 0.025 % work
change).  On the TPU that forced a fresh compile of every kernel; on the
card ``nvcc`` builds the library once, so a later pass is a repeat on
the same build: the summary's median/min/max per variant measure the
run-to-run spread, not a compile's.

Usage:
    python -m physicsbasedfwi2_tpu_torch.experiments.bench_kernel_breakdown \\
        [--nt 4001] [--reps 8] [--kc 32] [--compiles 1] [--device cpu]

Prints one JSON line per variant with s/call and per-cell-step ops
throughput, then an attribution line, and with more than one pass a
summary line; every line names the device.  Runs on the card unless
``--device`` names another device (on the CPU the plain versions; a
tiny ``--nt`` there).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from physicsbasedfwi2_tpu_torch.experiments.timing import (
    card, resolve_device, wait,
)
from physicsbasedfwi2_tpu_torch.geo import Grid2D, ricker
from physicsbasedfwi2_tpu_torch.ops import (
    AcousticConfig, simulate_acoustic, trace_normalize,
)
from physicsbasedfwi2_tpu_torch.ops.fwi_fused import (
    fwi_l1_loss_grad, scatter_rows,
)
from physicsbasedfwi2_tpu_torch.ops.kernel_breakdown import (
    VARIANTS, build_variant,
)
from physicsbasedfwi2_tpu_torch.ops.scalar2 import _prepare2


def time_fn(fn, reps: int) -> float:
    """Seconds per call of ``fn(scale)`` (a device scalar out): a first
    call, then ``reps`` calls chained through their outputs, one host
    read at the end.  Raises where that read is not finite."""
    first = fn(1.0)
    wait(first.device)
    t0 = time.perf_counter()
    s = torch.ones((), device=first.device)
    for _ in range(reps):
        s = fn(1.0 + 0.0 * s)
    last = float(s)
    dt = (time.perf_counter() - t0) / reps
    if not math.isfinite(last):
        raise FloatingPointError(f"time_fn: the last call gave {last}")
    return dt


def case(nt: int, device):
    """measure_once's case: 151 x 200 (dx 10, PML 20), dt 0.001, vp =
    1500 + 2000 U(0, 1) from numpy seed 0, an 8 Hz Ricker, 18 shots on
    row 1 at linspace(5, 194, 18), 200 receivers on row 1."""
    grid = Grid2D(nz=151, nx=200, dx=10.0, nt=nt, dt=0.001, pml_width=20)
    cfg = AcousticConfig(grid=grid, chunk=64, vmax_pml=5000.0)
    rng = np.random.default_rng(0)
    vp = torch.as_tensor((1500.0 + 2000.0 * rng.random((151, 200))).astype(
        np.float32), device=device)
    wav = ricker(8.0, grid.nt, grid.dt, device=device)
    ns, nr = 18, 200
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    geom = (i32(np.ones(ns)), i32(np.linspace(5, 194, ns)),
            i32(np.ones((ns, nr))), i32(np.tile(np.arange(nr), (ns, 1))))
    return cfg, wav, vp, geom


def measure_once(args, nt: int) -> dict:
    """One full measurement pass at record length ``nt`` on
    ``args.device`` (``args.kc``, ``args.reps``; ``args.card`` names the
    device in each line); returns {variant: s_per_call}."""
    cfg, wav, vp, geom = case(nt, args.device)
    src_z, src_x, rcv_z, rcv_x = geom
    grid = cfg.grid
    ns = len(src_z)
    K = _prepare2(vp, cfg)[0]
    nzp, nxp = K.shape
    cells = nzp * nxp
    results = {}
    prev = None
    for name, kw in VARIANTS:
        def fn(scale, kw=kw):
            return build_variant(vp, wav * scale, src_z, src_x, rcv_z, cfg,
                                 KC=args.kc, **kw).chk[0, 0]
        dt = time_fn(fn, args.reps)
        per_step = dt / (ns * nt)
        # stencil arithmetic: 17 arith + 8 shift ops / cell / step
        ops = 25 * cells / per_step / 1e12
        row = {"variant": name, "s_per_call": round(dt, 6),
               "ns_per_cell_step": round(per_step / cells * 1e9, 4),
               "stencil_Tops": round(ops, 3), "nt": nt}
        if prev is not None:
            row["delta_s"] = round(dt - prev, 6)
        prev = dt
        results[name] = row
        print(json.dumps({**row, "device": args.card}), flush=True)

    # the production kernel for reference (3 sweeps + misfit)
    with torch.no_grad():
        obs = simulate_acoustic(vp, wav, src_z, src_x, rcv_z, rcv_x, cfg)
    obs_rows = scatter_rows(trace_normalize(obs), rcv_x, nt=grid.nt,
                            nx=grid.nx, pml_width=grid.pml_width,
                            KC=args.kc)
    dir_rows = torch.zeros_like(obs_rows)

    def full(scale):
        loss, g = fwi_l1_loss_grad(vp, wav * scale, src_z, src_x, rcv_z,
                                   rcv_x, cfg, obs_rows, dir_rows,
                                   KC=args.kc)
        # 0 * g.sum(): a non-finite value anywhere in the gradient
        # reaches the scalar that time_fn checks
        return loss + 0.0 * g.sum()

    dt_full = time_fn(full, args.reps)
    fwd_dt = results["stencil"]["s_per_call"]
    # projection: reverse recompute + adjoint ~= 2 more stencil-class
    # sweeps (adjoint does ~29/25 the stencil work)
    proj = fwd_dt * (1.0 + 1.0 + 29.0 / 25.0)
    print(json.dumps({
        "variant": "full_fused", "s_per_call": round(dt_full, 6),
        "three_sweep_stencil_projection_s": round(proj, 6),
        "structural_overhead_s": round(dt_full - proj, 6),
        "src_cost_s": results["+src"].get("delta_s"),
        "rcv_cost_s": results["+rcv"].get("delta_s"),
        "ckpt_cost_s": results["+ckpt"].get("delta_s"),
        "nt": nt, "device": args.card,
    }), flush=True)
    out = {k: v["s_per_call"] for k, v in results.items()}
    out["full_fused"] = round(dt_full, 6)
    return out


def summarize(passes: list[dict]) -> dict:
    """The summary line of several passes (:func:`measure_once`'s
    returns): per variant the median, min, max and spread (max - min
    over the median, in percent)."""
    summary = {}
    for key in passes[0]:
        vals = sorted(p_[key] for p_ in passes)
        med = vals[len(vals) // 2] if len(vals) % 2 else (
            vals[len(vals) // 2 - 1] + vals[len(vals) // 2]) / 2
        summary[key] = {"median_s": round(med, 6),
                        "min_s": vals[0], "max_s": vals[-1],
                        "spread_pct": round(
                            100 * (vals[-1] - vals[0]) / max(med, 1e-12), 1)}
    med_sten = summary["stencil"]["median_s"]
    proj = med_sten * (1.0 + 1.0 + 29.0 / 25.0)
    return {
        "summary": summary, "compiles": len(passes),
        "median_structural_overhead_s": round(
            summary["full_fused"]["median_s"] - proj, 6),
        "median_src_cost_s": round(
            summary["+src"]["median_s"] - med_sten, 6),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Kernel B9's forward-sweep breakdown (PyTorch port)")
    p.add_argument("--nt", type=int, default=4001)
    p.add_argument("--reps", type=int, default=8)
    p.add_argument("--kc", type=int, default=32)
    p.add_argument("--compiles", type=int, default=1,
                   help="passes: pass k runs at nt+k (on the card a "
                        "repeat on the same build, not a fresh compile); "
                        "the summary reports median/min/max per variant")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; fails when "
                        "none is visible -- pass cpu to run the kernels' "
                        "plain versions on the CPU)")
    args = p.parse_args(argv)
    args.device = resolve_device(args.device)
    args.card = card(args.device)

    passes = []
    for k in range(max(args.compiles, 1)):
        print(json.dumps({"pass": k, "nt": args.nt + k,
                          "device": args.card}), flush=True)
        passes.append(measure_once(args, args.nt + k))
    if len(passes) > 1:
        print(json.dumps({**summarize(passes), "device": args.card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
