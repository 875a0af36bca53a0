#!/usr/bin/env python3
"""Where the time goes on the elastic path of the PyTorch + CUDA port.

Run from the root of a checkout on a machine with one CUDA card:
``python3 profile_torch.py [--out FILE]`` (default
``build/profile_torch/profile_torch.json``).
It prints, and writes as JSON:

1. the elastic engine's setup, part by part: the synthetic workload
   (its split-PML ``simulate_elastic`` of every shot), the ring forward
   that regenerates the observed data, the generator, and the engine
   around them;
2. the first stage's data (low-pass and row layout), which the first
   physics epoch builds;
3. a device trace of kernel B3 (``torch.profiler``, CUDA activity only)
   at the slice shape on each of its routes: device time and launches
   by kernel (on the resident route the forward sweep
   ``el_fwd_resident``, the misfit ``el_misfit_cols`` and the reverse
   sweep ``el_rev_resident`` separately), the busy share of the call;
4. ``marmousi_elastic`` physics epochs through the engine (B3 on the
   route it takes by shape, the resident one): host wall per epoch, the
   device time by kernel family (B3's kernels against everything else)
   and the busy share over a traced window, B3's launches by route and
   the epochs' peak device memory.

Numbers from a CPU run would not be device numbers, so the script
refuses to run without a card.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _sync_time(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _host_profile(fn, top: int = 16):
    """(result, [(seconds cumulative, function)] of the ``top`` host
    functions by cumulative time) of fn(), ending in a device sync."""
    import cProfile
    import pstats
    import torch
    prof = cProfile.Profile()
    prof.enable()
    out = fn()
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(((v[3], f"{Path(k[0]).name}:{k[1]}:{k[2]}")
                   for k, v in st.stats.items()), reverse=True)
    return out, [(round(t, 4), f) for t, f in rows[:top]]


def _trace(fn):
    """(device ns by kernel name, launches by name, window ns) of fn()
    under torch.profiler with CUDA activity only."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ns, count = collections.Counter(), collections.Counter()
    lo, hi = None, None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name()
        ns[name] += e.duration_ns()
        count[name] += 1
        lo = e.start_ns() if lo is None else min(lo, e.start_ns())
        hi = e.end_ns() if hi is None else max(hi, e.end_ns())
    return ns, count, (hi - lo) if lo is not None else 0


def _short(name: str) -> str:
    for k in ("el_fwd_resident", "el_rev_resident", "el_fwd_v", "el_fwd_s",
              "el_adj_v", "el_adj_s", "el_misfit_cols", "sum_shots5",
              "sum_loss"):
        if k in name:
            return k
    if "Memcpy" in name or "memcpy" in name:
        return "memcpy " + name.split("(")[-1].rstrip(")")
    if "Memset" in name or "memset" in name:
        return "memset"
    return name[:60]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=str(ROOT / "build" / "profile_torch" /
                                        "profile_torch.json"))
    p.add_argument("--epochs", type=int, default=5,
                   help="physics epochs timed (after 2 untimed)")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.engines import (
        ElasticDIPEngine, elastic_workload)
    from physicsbasedfwi2_tpu_torch.models import define_generator
    from physicsbasedfwi2_tpu_torch.ops import cuda_build
    from physicsbasedfwi2_tpu_torch.ops.elastic_fused import (
        fused_elastic_loss_grad_meds, prep_damp, prep_medium,
        simulate_elastic_ring)
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import reset_launches

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    cuda_build.load_library()
    report = {"card": smi, "torch": torch.__version__}
    cfg = get_workload("marmousi_elastic",
                       save_dir=str(ROOT / "build" / "profile_torch"))

    # 1. setup, part by part; the first engine build under the host
    # profiler shows what a cold process pays once
    wl, t_wl = _sync_time(lambda: elastic_workload(cfg, dev))
    wl_true = tuple(wl.true[k] for k in ("vp", "vs", "rho"))
    simulate_elastic_ring(*wl_true, wl.wavelet, *wl.geom, wl.cfg)  # warm
    _, t_ring = _sync_time(lambda: simulate_elastic_ring(
        *wl_true, wl.wavelet, *wl.geom, wl.cfg))
    ns, nt, nr = wl.obs_vx.shape
    _, t_net = _sync_time(lambda: define_generator(
        cfg.netG, out_shape=(cfg.nz, cfg.nx), in_shape=(nt, nr, ns),
        filters=cfg.filters, head=cfg.elastic_head,
        generator=torch.Generator().manual_seed(cfg.seed)).to(dev))
    (engine, t_engine), report["engine_first_host_top"] = _host_profile(
        lambda: _sync_time(lambda: ElasticDIPEngine(cfg, workload=wl,
                                                    device=dev)))
    _, t_engine2 = _sync_time(lambda: ElasticDIPEngine(cfg, workload=wl,
                                                       device=dev))
    wl, report["workload_build_host_top"] = _host_profile(
        lambda: elastic_workload(cfg, dev))
    report["setup_s"] = {"workload_build": t_wl, "ring_forward_35": t_ring,
                         "generator": t_net,
                         "engine_given_the_workload_first": t_engine,
                         "engine_given_the_workload_again": t_engine2}
    print("setup s:", json.dumps(report["setup_s"]))
    for k in ("engine_first_host_top", "workload_build_host_top"):
        print(k, json.dumps(report[k]))

    # 2. the first stage's data
    fc = cfg.freq_stages[0]
    _, t_pack1 = _sync_time(lambda: engine._stage_pack(fc))
    engine._stage_cache.clear()
    _, t_pack2 = _sync_time(lambda: engine._stage_pack(fc))
    report["stage_pack_s"] = {"first": t_pack1, "again": t_pack2}
    print("stage pack s:", json.dumps(report["stage_pack_s"]))

    # 3. B3 at the slice shape (5 shots, the 4 Hz stage's data)
    pd = engine._stage_pack(fc)
    idx = torch.arange(0, cfg.num_shots, 7, device=dev)
    meds = prep_medium(*(wl.start[k] for k in ("vp", "vs", "rho")), wl.cfg)
    damp = prep_damp(wl.cfg, dev)
    geom = tuple(a[idx] for a in wl.geom)

    def b3(route):
        return fused_elastic_loss_grad_meds(
            meds, damp, pd["wav"], *geom, wl.cfg, pd["orx"][idx],
            pd["orz"][idx], KC=8, misfit=cfg.misfit, route=route)

    report["b3"] = {}
    for route in ("resident", "per_step"):
        b3(route)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            b3(route)
        stop.record()
        torch.cuda.synchronize()
        ms_b3 = start.elapsed_time(stop) / 3
        k_ns, k_n, window = _trace(lambda: [b3(route) for _ in range(2)])
        by = collections.defaultdict(lambda: [0.0, 0])
        for name, v in k_ns.items():
            by[_short(name)][0] += v / 2e6
            by[_short(name)][1] += k_n[name] // 2
        busy = sum(k_ns.values())
        report["b3"][route] = {
            "ms_per_call": ms_b3, "traced_ms_per_call": window / 2e6,
            "busy_share": busy / window if window else None,
            "per_call_by_kernel": {k: {"ms": v[0], "launches": v[1]}
                                   for k, v in sorted(
                                       by.items(), key=lambda kv: -kv[1][0])}}
        print(f"B3 ({route} route):", json.dumps(report["b3"][route]))

    # 4. physics epochs through the engine
    epoch = cfg.lstart
    reset_launches(fused_elastic_loss_grad_meds)
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(2):
        epoch += 1
        engine.optimize_parameters(epoch, freq=fc)
    walls = []
    for _ in range(args.epochs):
        epoch += 1
        _, w = _sync_time(lambda: (engine.test(),
                                   engine.optimize_parameters(epoch,
                                                              freq=fc)))
        walls.append(w)
    e_ns, e_n, e_window = _trace(lambda: [
        (engine.test(), engine.optimize_parameters(epoch + 1 + i, freq=fc))
        for i in range(2)])
    fam = collections.defaultdict(float)
    for name, v in e_ns.items():
        fam["B3" if _short(name).startswith(("el_", "sum_")) else
            "memcpy/memset" if _short(name).startswith("mem") else
            "other (generator, prep, gradient processing)"] += v / 2e6
    report["epoch"] = {"wall_s": walls,
                       "traced_ms_per_epoch": e_window / 2e6,
                       "busy_share": (sum(e_ns.values()) / e_window
                                      if e_window else None),
                       "device_ms_per_epoch": dict(fam),
                       "b3_launches_resident_per_step": (
                           fused_elastic_loss_grad_meds.resident_launches,
                           fused_elastic_loss_grad_meds.per_step_launches)}
    print("epoch:", json.dumps(report["epoch"]))
    # since the reset before the epochs: the epochs' peak
    report["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"peak memory {report['peak_memory_gib']:.2f} GiB; wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
