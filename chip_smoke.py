#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py`` (no
arguments; needs one CUDA card, ``nvcc`` and ``nvidia-smi``).

Phases, each of which fails the run (non-zero exit, no result line):

1. the card (``nvidia-smi`` name and power limit), versions, TF32
   settings, and the build of ``physicsbasedfwi2_tpu_torch/csrc`` with
   ``nvcc`` into ``build/torch_kernels/``;
2. kernel B1 (``forward2``) against its plain PyTorch version at the
   main path's shapes (151 x 200, PML 20, 18 shots x 200 receivers,
   nt 4001);
3. kernel B2 (``fwi_l1_loss_grad``) against its plain version at the
   same shape (on a misfit whose residuals keep their signs, and on
   the real one), and the loss at the true model;
4. the main path: ``train(get_workload("marmousi_acoustic"), epochs=3)``
   at full width on ``cuda:0``, with each kernel's launch count over
   that run.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is the result object.  The script never
falls back to the CPU or to the plain versions.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "physicsbasedfwi2_tpu_torch/csrc/scalar2.cu"
NT = 4001  # marmousi_acoustic's time steps


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def timed_ms(fn, repeats: int = 3) -> tuple[object, float]:
    """(result of a warm-up call, mean milliseconds of ``repeats`` more
    calls), timed with CUDA events."""
    import torch
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop) / repeats


def phase_card():
    import torch

    import physicsbasedfwi2_tpu_torch  # noqa: F401  (turns TF32 off)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    print(smi[0])
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)} "
          f"(sm_{''.join(map(str, torch.cuda.get_device_capability(0)))})")
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 must be off")
    from physicsbasedfwi2_tpu_torch.ops import cuda_build
    path, secs, log = cuda_build.build()
    print(f"kernel build: {secs:.1f} s -> {path.relative_to(ROOT)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  ptxas: {line.strip()}")
    cuda_build.load_library()


def flagship_case(dev):
    """marmousi_acoustic's grid, geometry, true and starting models."""
    import torch
    from physicsbasedfwi2_tpu_torch.data.synthetic import (
        make_marmousi_like, smooth_model)
    from physicsbasedfwi2_tpu_torch.geo import Grid2D, ricker, surface_line
    from physicsbasedfwi2_tpu_torch.ops import AcousticConfig
    grid = Grid2D(nz=151, nx=200, dx=10.0, nt=NT, dt=0.001, pml_width=20)
    cfg = AcousticConfig(grid=grid, chunk=64, vmax_pml=5000.0)
    acq = surface_line(18, 200, 200)
    geom = tuple(torch.as_tensor(a, dtype=torch.int32, device=dev)
                 for a in (acq.src_z, acq.src_x, acq.rcv_z, acq.rcv_x))
    vp_np = make_marmousi_like(151, 200, seed=0, water_rows=26)
    vp = torch.as_tensor(vp_np, device=dev)
    vp0 = torch.as_tensor(smooth_model(vp_np, preserve_rows=26), device=dev)
    return cfg, ricker(8.0, NT, 0.001, device=dev), geom, vp, vp0


def phase_b1(dev):
    import torch
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import forward2, forward2_plain
    cfg, wav, geom, vp, _ = flagship_case(dev)
    rows_k, ms_k = timed_ms(lambda: forward2(vp, wav, *geom, cfg,
                                             return_rows=True))
    rows_p, ms_p = timed_ms(lambda: forward2_plain(vp, wav, *geom, cfg,
                                                   return_rows=True))
    scale = float(rows_p.abs().max())
    err = float((rows_k - rows_p).abs().max())
    print(f"B1 forward2 [18 shots, nt {NT}, rows "
          f"{tuple(rows_k.shape)}]: max|err| {err:.3e} of max {scale:.3e} "
          f"(tol 1e-4 of max: FMA contraction and sum order differ); "
          f"kernel {ms_k:.2f} ms, plain {ms_p:.2f} ms")
    check(bool(torch.isfinite(rows_k).all()), "B1 rows not finite")
    check(err <= 1e-4 * scale, "B1 disagrees with its plain version")
    return {"max_abs_err": err, "ms": ms_k, "plain_ms": ms_p}


def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm())


def phase_b2(dev):
    """B2 against its plain version (1) on a misfit whose residuals
    never change sign (observed rows offset by 3), where the kernel must
    be as accurate as the plain version against a float64 run of the
    same algorithm (the gradient's zero-lag correlation cancels strongly,
    so float32 rounding alone moves it ~1e-4), (2) on the real misfit, whose L1 kinks make the
    gradient follow rounding wherever a residual is near zero, held to
    the plain version's own sensitivity, and (3) the loss at the true
    model."""
    import torch
    from physicsbasedfwi2_tpu_torch.ops import trace_normalize
    from physicsbasedfwi2_tpu_torch.ops.fwi_fused import (
        fwi_l1_loss_grad, fwi_l1_loss_grad_plain, scatter_rows)
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import (
        forward2, forward2_plain)
    cfg, wav, geom, vp, vp0 = flagship_case(dev)
    g = cfg.grid
    const = torch.full_like(vp, 1500.0)
    dir_rows = forward2(const, wav, *geom, cfg, return_rows=True)
    cols = geom[3].long() + g.pml_width
    idx = cols[:, None, :].expand(-1, g.nt, -1)
    obs = forward2(vp, wav, *geom, cfg) - torch.gather(dir_rows, 2, idx)
    obs_rows = scatter_rows(trace_normalize(obs), geom[3], nt=g.nt,
                            nx=g.nx, pml_width=g.pml_width)
    pad = obs_rows.shape[1] - g.nt
    dir_pad = torch.nn.functional.pad(dir_rows, (0, 0, 0, pad)).contiguous()

    def kernel(o, d=dir_pad, v=vp0):
        return fwi_l1_loss_grad(v, wav, *geom, cfg, o, d)

    def plain(o, d=dir_pad, v=vp0):
        return fwi_l1_loss_grad_plain(v, wav, *geom, cfg, o, d)

    # (1) |yn| <= 1 and |obs| <= 1, so yn - (obs + 3) < 0 everywhere
    off = (obs_rows + 3.0).contiguous()
    (lk, gk), ms_k = timed_ms(lambda: kernel(off))
    (lp, gp), ms_p = timed_ms(lambda: plain(off), repeats=1)
    lr, gr = fwi_l1_loss_grad_plain(vp0, wav, *geom, cfg, off, dir_pad,
                                    dtype=torch.float64)
    lk, lp, lr = float(lk), float(lp), float(lr)
    rel_loss = abs(lk - lp) / abs(lp)
    rel_g = _rel_l2(gk, gp)
    err_k, err_p = _rel_l2(gk.double(), gr), _rel_l2(gp.double(), gr)
    err = float((gk - gp).abs().max())
    print(f"B2 fwi_l1_loss_grad [18 shots, nt {NT}, residual "
          f"signs fixed]: loss {lk:.9g} vs plain {lp:.9g} (rel "
          f"{rel_loss:.2e}, tol 1e-5); grad rel L2 vs plain {rel_g:.2e}, "
          f"max|err| {err:.3e} of max {float(gp.abs().max()):.3e}; against "
          f"the plain version in float64: kernel {err_k:.2e}, plain float32 "
          f"{err_p:.2e} (tol max(1e-4, 2x plain)); kernel {ms_k:.2f} ms, "
          f"plain {ms_p:.2f} ms")
    check(math.isfinite(lk) and bool(torch.isfinite(gk).all()),
          "B2 output not finite")
    check(rel_loss <= 1e-5, "B2 loss disagrees with its plain version")
    check(abs(lk - lr) <= 1e-5 * abs(lr), "B2 loss vs float64")
    check(err_k <= max(1e-4, 2.0 * err_p),
          "B2 gradient is less accurate than its plain version")

    # (2) the real misfit, each side with obs and direct rows made by its
    # own forward (as the engine does): in the window before the scattered
    # arrivals y = pred - direct cancels, and the L1 signs there follow
    # rounding; the plain gradient's move under a 1e-7 relative change of
    # its direct rows measures that sensitivity
    dir_p = forward2_plain(const, wav, *geom, cfg, return_rows=True)
    obs_p = (forward2_plain(vp, wav, *geom, cfg)
             - torch.gather(dir_p, 2, idx))
    obs_rows_p = scatter_rows(trace_normalize(obs_p), geom[3], nt=g.nt,
                              nx=g.nx, pml_width=g.pml_width)
    dir_pad_p = torch.nn.functional.pad(dir_p, (0, 0, 0, pad)).contiguous()
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = torch.randn(dir_pad_p.shape, generator=gen, device=dev)
    dir_pert = (dir_pad_p * (1.0 + 1e-7 * noise)).contiguous()
    lk2, gk2 = kernel(obs_rows)
    lp2, gp2 = plain(obs_rows_p, dir_pad_p)
    lq2, gq2 = plain(obs_rows_p, dir_pert)
    rel_self = _rel_l2(gq2, gp2)
    rel_loss_self = abs(float(lq2) - float(lp2)) / abs(float(lp2))
    rel_g2 = _rel_l2(gk2, gp2)
    rel_loss2 = abs(float(lk2) - float(lp2)) / abs(float(lp2))
    print(f"B2 on the real misfit: loss {float(lk2):.9g} vs plain "
          f"{float(lp2):.9g} (rel {rel_loss2:.2e}), grad rel L2 "
          f"{rel_g2:.2e}; under a 1e-7 change of its direct rows the plain "
          f"loss moves {rel_loss_self:.2e} and its gradient {rel_self:.2e} "
          f"(tol max(1e-5, 10x) and max(1e-4, 10x))")
    check(rel_loss2 <= max(1e-5, 10.0 * rel_loss_self),
          "B2 loss (real misfit) disagrees")
    check(rel_g2 <= max(1e-4, 10.0 * rel_self),
          "B2 gradient (real misfit) disagrees beyond the misfit's own "
          "sensitivity")

    # (3) obs and direct rows come from B1, the misfit from B2
    l_true, _ = kernel(obs_rows, v=vp)
    print(f"B2 loss at the true model: {float(l_true):.3e} (tol 1e-6)")
    check(float(l_true) <= 1e-6, "B2 loss at the true model is not ~0")
    return {"max_abs_err": err, "ms": ms_k, "plain_ms": ms_p}


def phase_slice(dev):
    import torch
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.train import train
    from physicsbasedfwi2_tpu_torch.ops import fwi_fused, scalar2
    cfg = get_workload("marmousi_acoustic",
                       save_dir=str(ROOT / "build" / "chip_smoke"))
    print(f"slice: marmousi_acoustic {cfg.nz}x{cfg.nx}, nt {cfg.nt}, "
          f"{cfg.num_shots} shots x {cfg.num_receivers} receivers, "
          f"{cfg.netG} filters {cfg.filters}")
    scalar2.forward2.launches = 0
    fwi_fused.fwi_l1_loss_grad.launches = 0
    t0 = time.perf_counter()
    engine, history = train(cfg, epochs=3, quiet=True, device=dev)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"forward2": scalar2.forward2.launches,
                "fwi_l1_loss_grad": fwi_fused.fwi_l1_loss_grad.launches}
    for rec in history:
        print("epoch", json.dumps(rec))
    print(f"slice: {total:.2f} s in all (engine setup included), "
          f"launches {launches}, physics path {engine.physics_path}, "
          f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
          f"GiB")
    check(engine.physics_path == "fused-cuda",
          f"physics path {engine.physics_path}")
    check(launches["forward2"] >= 2, "B1 was not launched for obs + direct")
    check(launches["fwi_l1_loss_grad"] == 3, "B2 not launched once per epoch")
    for rec in history:
        for k, v in rec.items():
            if isinstance(v, float):
                check(math.isfinite(v), f"epoch {rec['epoch']}: {k}={v}")
    losses = [rec["loss_D"] for rec in history]
    check(len(set(losses)) == len(losses), f"loss_D does not move: {losses}")
    # the engine's own data must fit exactly at the true model
    loss_true, grad = engine.physics_value_and_grad(engine.wl.vp_true)
    print(f"slice: misfit at the true model {float(loss_true):.3e} "
          f"(tol 1e-6), gradient {tuple(grad.shape)}")
    check(float(loss_true) <= 1e-6, "engine misfit at the true model")
    check(tuple(grad.shape) == (cfg.nz, cfg.nx)
          and bool(torch.isfinite(grad).all()), "engine gradient")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this smoke test runs "
              "only on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import physicsbasedfwi2_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    phase_card()
    b1 = phase_b1(dev)
    b2 = phase_b2(dev)
    launches = phase_slice(dev)
    kernels = [
        {"name": "forward2", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "physicsbasedfwi2_tpu/ops/pallas_scalar2.py:91",
         "launches": launches["forward2"], **b1},
        {"name": "fwi_l1_loss_grad", "route": "cuda",
         "source": KERNEL_SOURCE,
         "replaces": "physicsbasedfwi2_tpu/ops/pallas_fwi_fused.py:50",
         "launches": launches["fwi_l1_loss_grad"], **b2},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
