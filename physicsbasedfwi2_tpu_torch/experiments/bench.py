"""FWI iteration wall-clock on the reference's workloads (port of the
root ``bench.py``).

The acoustic lines: 18 shots x nt=4001 (dt=1 ms) x grid 151x200, per
iteration forward + adjoint, the direct-wave simulation hoisted out of
the loop (it is model-independent; the reference recomputed it every
iteration, networks.py:5396-5411).  On ``pallas`` the observed data and
the direct wave come from ``acoustic_pallas2`` (kernel B1) and each
iteration is one ``fwi_l1_loss_grad`` (kernel B2); on ``xla`` the
trace-normalized L1 misfit of ``simulate_acoustic`` under autograd.
Reference: deepwave CUDA, it_lap ~= 0.35 s/iteration
(marmsm_Mod8_log.txt col 5), the ``vs_baseline`` of these lines.

The elastic lines: the DENISE-replacement workload (5 shots x 5.0 s x
100x300 P-SV fwd+adjoint, free surface, the reference's
networks.py:7554-7878 geometry) on ``fused`` (the ring forward for the
observed data, then kernel B3's loss and gradient), ``fast`` (the
5-field sponge scheme under autograd) or ``pml`` (the split-PML scheme
under autograd).  They carry no baseline: the reference preserved no
DENISE wall-clocks.

Then two end-to-end engine lines (``bench_configs.bench_one``):
``marmousi_acoustic`` and ``marmousi_elastic``'s physics-phase
iteration (generator forward and backward, the physics gradient, the
conditioning chain, Adam, the logged scalars).

Each iteration line times ``--iters`` chained iterations (each update
``vp - lr * grad`` feeds the next, so the card runs them back to back;
the losses are summed on the card and read once, at the end) after a
warm chain.  Every line: {"metric": ..., "value": N, "unit": "s",
"path": ..., "launches": ..., "device": ...}: ``path`` names the route
that ran, ``fused-resident`` or ``fused-per-step`` (``fused-plain``: the
plain versions on the CPU), from the kernels' launch counters, which
``launches`` lists by kernel as [launches, resident, per-step];
``device`` is the card's name and power limit.  A failure raises: no
line falls back to another path or is skipped.

Usage:
    python -m physicsbasedfwi2_tpu_torch.experiments.bench \\
        [--backend pallas,xla] [--el-scheme fused,fast,pml] \\
        [--iters 10] [--engine-iters 5] [--small] [--device cpu]

Runs on the card unless ``--device`` names another device; ``--small``
shrinks every case for runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from physicsbasedfwi2_tpu_torch.engine import get_workload
from physicsbasedfwi2_tpu_torch.experiments.bench_configs import bench_one
from physicsbasedfwi2_tpu_torch.experiments.timing import (
    card, launch_counts, launches_since, resolve_device, route, wait,
)
from physicsbasedfwi2_tpu_torch.geo import Grid2D, ricker
from physicsbasedfwi2_tpu_torch.geo.acquisition import (
    Acquisition, surface_line,
)
from physicsbasedfwi2_tpu_torch.landscape.cli import small_overrides
from physicsbasedfwi2_tpu_torch.ops import (
    AcousticConfig, ElasticConfig, l1_misfit, select_acoustic,
    simulate_elastic, trace_normalize,
)
from physicsbasedfwi2_tpu_torch.ops.elastic_fast import simulate_elastic_fast
from physicsbasedfwi2_tpu_torch.ops.elastic_fused import (
    fused_elastic_loss_grad, scatter_rows_el, simulate_elastic_ring,
)
from physicsbasedfwi2_tpu_torch.ops.fwi_fused import fwi_l1_loss_grad
from physicsbasedfwi2_tpu_torch.ops.scalar2 import (
    acoustic_pallas2, scatter_rows,
)

BASELINE_IT_LAP = 0.35  # s, reference GPU (marmsm_Mod8_log.txt)
BACKENDS = ("pallas", "xla")
EL_SCHEMES = ("fused", "fast", "pml")
# the shrunk cases of --small (and the CPU tests)
SMALL = dict(nz=30, nx=40, nt=300, num_shots=3)
SMALL_EL = dict(nz=20, nx=32, nt=200, num_shots=3, num_receivers=30)


def build(*, nz: int = 151, nx: int = 200, nt: int = 4001,
          num_shots: int = 18, device=None):
    """bench.py's acoustic case (cfg, wavelet, geometry, vp_true, vp0) on
    ``device`` (default the card).  The water rows and the anomaly scale
    with the grid (26 rows and [60:90, 80:140] at 151 x 200)."""
    dev = resolve_device(device)
    grid = Grid2D(nz=nz, nx=nx, dx=10.0, nt=nt, dt=0.001, pml_width=20)
    cfg = AcousticConfig(grid=grid, order=4, chunk=64, vmax_pml=5000.0)
    wav = ricker(8.0, grid.nt, grid.dt, device=dev)
    # at the defaults marmousi_acoustic_acquisition(nx=200)
    acq = surface_line(num_shots, nx, nx)
    geom = tuple(torch.as_tensor(a, device=dev) for a in
                 (acq.src_z, acq.src_x, acq.rcv_z, acq.rcv_x))
    z = torch.arange(nz, dtype=torch.float32, device=dev)[:, None]
    water = nz * 26 // 151
    vp_true = 1500.0 + torch.where(z < water, 0.0, (z - water) * 14.0)
    vp_true = vp_true.expand(nz, nx).clone()
    vp_true[nz * 60 // 151: nz * 90 // 151,
            nx * 80 // 200: nx * 140 // 200] += 300.0
    vp0 = (1500.0 + torch.where(z < water, 0.0, (z - water) * 12.0)).expand(
        nz, nx).contiguous()
    return cfg, wav, geom, vp_true, vp0


def build_elastic(*, nz: int = 100, nx: int = 300, nt: int = 3334,
                  num_shots: int = 5, num_receivers: int = 298,
                  device=None):
    """bench.py's elastic case (cfg, wavelet, geometry, vp, vs, rho,
    vp_t) on ``device`` (default the card): dx 20 m, free surface, dt
    1.5 ms, sources and receivers on row 2; vp_t adds 200 m/s to vp in
    a block ([40:60, 100:200] at 100 x 300, scaling with the grid)."""
    dev = resolve_device(device)
    grid = Grid2D(nz=nz, nx=nx, dx=20.0, nt=nt, dt=0.0015, pml_width=20,
                  free_surface=True)
    ecfg = ElasticConfig(grid=grid, chunk=64, vmax_pml=5000.0)
    wav = ricker(10.0, nt, grid.dt, device=dev)
    ns, nr = num_shots, num_receivers
    src_x = np.round(np.linspace(5, nx - 6, ns)).astype(np.int32)
    acq = Acquisition(np.full(ns, 2, np.int32), src_x,
                      np.full((ns, nr), 2, np.int32),
                      np.tile(np.round(np.linspace(1, nx - 2, nr))
                              .astype(np.int32), (ns, 1)))
    geom = tuple(torch.as_tensor(a, device=dev) for a in
                 (acq.src_z, acq.src_x, acq.rcv_z, acq.rcv_x))
    z = torch.arange(nz, dtype=torch.float32, device=dev)[:, None]
    water = nz * 10 // 100
    vp = (1500.0 + torch.where(z < water, 0.0, (z - water) * 25.0)).expand(
        nz, nx).contiguous()
    vs = torch.where(vp > 1500.0, vp / 1.8, 0.0)
    rho = 310.0 * vp ** 0.25
    vp_t = vp.clone()
    vp_t[nz * 40 // 100: nz * 60 // 100,
         nx * 100 // 300: nx * 200 // 300] += 200.0
    return ecfg, wav, geom, vp, vs, rho, vp_t


def autograd_value_and_grad(loss_fn):
    """``loss_fn``'s value and its gradient w.r.t. each argument, by
    ``torch.autograd``: a function of the arguments returning (loss,
    *grads)."""
    def value_and_grad(*params):
        params = [p.detach().requires_grad_() for p in params]
        with torch.enable_grad():
            loss = loss_fn(*params)
        return (loss.detach(), *torch.autograd.grad(loss, params))
    return value_and_grad


def acoustic_value_and_grad(backend: str, case):
    """The acoustic iteration's value and gradient, a function of vp,
    on ``backend`` (``pallas``: kernel B2 on rows from kernel B1;
    ``xla``: ``simulate_acoustic`` under autograd), as bench.py:59-99
    composes it."""
    cfg, wav, geom, vp_true, _ = case
    g = cfg.grid
    if backend == "pallas":
        obs_norm = trace_normalize(acoustic_pallas2(vp_true, wav, *geom, cfg))
        direct = acoustic_pallas2(torch.full_like(vp_true, 1500.0), wav,
                                  *geom, cfg)
        obs_rows, dir_rows = (
            scatter_rows(d, geom[3], nt=g.nt, nx=g.nx, pml_width=g.pml_width)
            for d in (obs_norm, direct))

        def value_and_grad(v):
            return fwi_l1_loss_grad(v, wav, *geom, cfg, obs_rows, dir_rows)
        return value_and_grad
    sim = select_acoustic(backend)
    with torch.no_grad():
        obs_norm = trace_normalize(sim(vp_true, wav, *geom, cfg))
        direct = sim(torch.full_like(vp_true, 1500.0), wav, *geom, cfg)

    def loss_fn(v):
        pred = sim(v, wav, *geom, cfg) - direct
        m = torch.amax(torch.abs(pred), dim=1, keepdim=True)
        return l1_misfit(pred / (m + 1e-10), obs_norm)
    return autograd_value_and_grad(loss_fn)


def elastic_value_and_grad(scheme: str, case):
    """The elastic iteration's value and gradients, a function of (vp,
    vs) returning (loss, dJ/dvp, dJ/dvs), on ``scheme`` (``fused``:
    kernel B3 on rows from the ring forward; ``fast``, ``pml``: the
    sponge or split-PML scheme under autograd, the l2 misfit of both
    components), as bench.py:118-181 composes it."""
    ecfg, wav, geom, _, vs, rho, vp_t = case
    if scheme == "fused":
        ovx, ovz = simulate_elastic_ring(vp_t, vs, rho, wav, *geom, ecfg)
        orx, orz = (scatter_rows_el(o, geom[3], ecfg, KC=8)
                    for o in (ovx, ovz))

        def value_and_grad(vp_, vs_):
            loss, g = fused_elastic_loss_grad(
                vp_, vs_, rho, wav, *geom, ecfg, orx, orz, KC=8,
                wrt=("vp", "vs"))
            return loss, g["vp"], g["vs"]
        return value_and_grad
    sim = {"fast": simulate_elastic_fast, "pml": simulate_elastic}[scheme]
    with torch.no_grad():
        ovx, ovz = sim(vp_t, vs, rho, wav, *geom, ecfg)

    def loss_fn(vp_, vs_):
        pvx, pvz = sim(vp_, vs_, rho, wav, *geom, ecfg)
        return torch.mean((pvx - ovx) ** 2) + torch.mean((pvz - ovz) ** 2)
    return autograd_value_and_grad(loss_fn)


def chain(value_and_grad, params, n: int, lr: float):
    """``n`` chained FWI iterations from ``params`` (each ``p - lr *
    grad`` feeds the next, so the card runs them back to back); returns
    (the losses summed on the device, the last params)."""
    acc = torch.zeros((), dtype=torch.float32, device=params[0].device)
    for _ in range(n):
        loss, *grads = value_and_grad(*params)
        params = tuple(p - lr * g for p, g in zip(params, grads))
        acc = acc + loss
    return acc, params


def time_chain(value_and_grad, params, lr: float, warm: int,
               n: int) -> float:
    """Seconds per iteration of ``n`` chained iterations after a warm
    chain of ``warm``; one host read of the summed loss at the end of
    each chain.  Raises on a loss that is not finite."""
    dev = params[0].device
    acc, _ = chain(value_and_grad, params, warm, lr)
    if not math.isfinite(float(acc)):
        raise FloatingPointError(f"warm chain: summed loss {float(acc)}")
    wait(dev)
    t0 = time.perf_counter()
    acc, _ = chain(value_and_grad, params, n, lr)
    total = float(acc)
    dt = (time.perf_counter() - t0) / n
    if not math.isfinite(total):
        raise FloatingPointError(f"timed chain: summed loss {total}")
    return dt


def run(backend: str, case=None, n_iter: int = 10) -> float:
    """Seconds per acoustic FWI iteration on ``backend`` (a warm chain
    of 2, then ``n_iter`` timed) of ``case`` (default :func:`build`'s on
    the card)."""
    case = case or build()
    vg = acoustic_value_and_grad(backend, case)
    return time_chain(vg, (case[4],), 1e-6, 2, n_iter)


def run_elastic(scheme: str = "fused", case=None, n_iter: int = 10) -> float:
    """Seconds per elastic gradient iteration on ``scheme`` (a warm chain
    of 1, then ``n_iter`` timed) of ``case`` (default
    :func:`build_elastic`'s on the card)."""
    case = case or build_elastic()
    vg = elastic_value_and_grad(scheme, case)
    return time_chain(vg, (case[3], case[4]), 1e-3, 1, n_iter)


def _path(name: str, launches: dict) -> str:
    """``fused-<route>`` on the kernels' paths, else the path's name."""
    return f"fused-{route(launches)}" if name.startswith("fused") else name


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="FWI iteration wall-clock (PyTorch port of bench.py)")
    p.add_argument("--backend", default="pallas",
                   help="acoustic lines, a comma list of pallas (kernels "
                        "B1, B2) and xla (simulate_acoustic, autograd)")
    p.add_argument("--el-scheme", default="fused",
                   help="elastic lines, a comma list of fused (ring "
                        "forward, kernel B3), fast and pml (autograd)")
    p.add_argument("--iters", type=int, default=10,
                   help="timed chained iterations a line")
    p.add_argument("--engine-iters", type=int, default=5,
                   help="timed engine iterations an end-to-end line")
    p.add_argument("--small", action="store_true",
                   help="shrunk cases and workloads (runs on the CPU)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; fails when "
                        "none is visible -- pass cpu to run the kernels' "
                        "plain versions on the CPU)")
    args = p.parse_args(argv)
    backends, schemes = args.backend.split(","), args.el_scheme.split(",")
    for names, allowed in ((backends, BACKENDS), (schemes, EL_SCHEMES)):
        if not set(names) <= set(allowed):
            p.error(f"{','.join(names)}: choose from {', '.join(allowed)}")
    dev = resolve_device(args.device)
    device_line = card(dev)
    size, size_el = (SMALL, SMALL_EL) if args.small else ({}, {})

    def line(**fields):
        print(json.dumps({**fields, "device": device_line}), flush=True)

    for backend in backends:
        before = launch_counts()
        dt_iter = run(backend, build(device=dev, **size), args.iters)
        launches = launches_since(before)
        line(metric=f"marmousi_acoustic_fwi_iteration_wallclock_{backend}",
             value=round(dt_iter, 5), unit="s",
             vs_baseline=round(BASELINE_IT_LAP / dt_iter, 2),
             path=_path("fused" if backend == "pallas" else backend,
                        launches),
             launches=launches)

    for scheme in schemes:
        case = build_elastic(device=dev, **size_el)
        g = case[0].grid
        before = launch_counts()
        dt_el = run_elastic(scheme, case, args.iters)
        launches = launches_since(before)
        line(metric=f"marmousi_elastic_fwi_iteration_wallclock_{scheme}",
             value=round(dt_el, 5), unit="s", path=_path(scheme, launches),
             launches=launches,
             workload=f"{len(case[2][0])} shots x {g.nt * g.dt:.1f}s x "
                      f"{g.nz}x{g.nx} P-SV fwd+adjoint")

    # end-to-end engine iterations at BASELINE config 1 (net fwd/bwd +
    # physics gradient + optimizer + logged scalars: the scope of the
    # reference's it_lap column, marmsm_Mod8_log.txt col 5) and at the
    # elastic default iteration
    for workload in ("marmousi_acoustic", "marmousi_elastic"):
        overrides = (small_overrides(workload == "marmousi_elastic")
                     if args.small else {})
        before = launch_counts()
        r = bench_one(workload, args.engine_iters, device=dev, **overrides)
        launches = launches_since(before)
        dt_e2e = r["seconds_per_iteration"]
        fields = dict(metric=f"{workload}_engine_iteration_end_to_end",
                      value=dt_e2e, path=_path(r["path"], launches),
                      launches=launches, unit="s")
        if workload == "marmousi_acoustic":
            fields.update(
                vs_baseline=round(BASELINE_IT_LAP / dt_e2e, 2),
                baseline="reference it_lap 0.35 s (same end-to-end scope: "
                         "generator + deepwave gradient + Adam + "
                         "per-iteration loss logging)")
        else:
            cfg = get_workload(workload, **overrides)
            fields.update(
                workload=f"{workload} default iteration: "
                         f"{cfg.shots_per_iter}-shot fused gradient + "
                         "taper/depth/tether conditioning + decoder "
                         "fwd/bwd + Adam")
        line(**fields)
    return 0


if __name__ == "__main__":
    sys.exit(main())
