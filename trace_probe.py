#!/usr/bin/env python3
"""Which records a ``torch.profiler`` device trace loses, and whether
host waits inside the trace keep them.

Run from the root of a checkout on a machine with one CUDA card:
``python3 trace_probe.py [ROUNDS] [BURN_S]`` (default 16 rounds of 15 s).
Each round keeps the card busy with untraced matrix products for
``BURN_S`` seconds, then takes four traces of the same call: 64 short
marker kernels (``torch.cuda._sleep``), then N one-element adds, then
64 more markers, with a device sync between the three parts.  The
traces differ in N (25,000 or 3,000), in whether CPU activity is traced
too, and in whether the host waits 20 ms after the trace starts and
before it stops.  Each trace prints one JSON line: the leading and
trailing markers and the adds it holds (all of them: 64, 64, N), and
with CPU activity the least and the median of (a kernel's start minus
its launch's start), which is negative where the trace's GPU clock runs
ahead of its host clock.
"""
import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

CUDA = torch.autograd.DeviceType.CUDA


def burn(a, seconds: float) -> None:
    t = time.time()
    while time.time() - t < seconds:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()


def trace(x, n_adds: int, pad_s: float, cpu: bool, t0: float,
          lead: int = 64, trail: int = 64) -> dict:
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        if pad_s:
            time.sleep(pad_s)
        for _ in range(lead):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(n_adds):
            x.add_(1)
        torch.cuda.synchronize()
        for _ in range(trail):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        if pad_s:
            time.sleep(pad_s)
    res = prof.profiler.kineto_results
    ev = list(res.events())
    gpu = sorted((e.start_ns(), e.end_ns(), e.name(), e.correlation_id())
                 for e in ev if e.device_type() == CUDA)
    adds = [g for g in gpu if "spin" not in g[2]]
    spins = [g for g in gpu if "spin" in g[2]]
    first = adds[0][0] if adds else None
    last = adds[-1][1] if adds else None
    out = {"t": round(time.time() - t0, 1), "nsmall": n_adds, "pad": pad_s,
           "cpu": cpu,
           "lead": sum(first is not None and g[1] <= first for g in spins),
           "trail": sum(last is not None and g[0] >= last for g in spins),
           "adds": len(adds), "gpu_records": len(gpu)}
    if cpu:
        launch = {e.correlation_id(): e.start_ns() for e in ev
                  if e.device_type() != CUDA and "LaunchKernel" in e.name()}
        d = sorted(g[0] - launch[g[3]] for g in gpu if g[3] in launch)
        out["matched"] = len(d)
        if d:
            out["min_gpu_minus_launch_us"] = d[0] / 1e3
            out["median_gpu_minus_launch_us"] = d[len(d) // 2] / 1e3
    out["trace_start_to_first_gpu_us"] = (
        (gpu[0][0] - res.trace_start_ns()) / 1e3 if gpu else None)
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("trace_probe.py needs a CUDA card", file=sys.stderr)
        return 2
    rounds = int(argv[0]) if argv else 16
    burn_s = float(argv[1]) if len(argv) > 1 else 15.0
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    x = torch.zeros(1024, device="cuda")
    a = torch.randn(4096, 4096, device="cuda")
    t0 = time.time()
    for _ in range(rounds):
        burn(a, burn_s)
        for n_adds, pad_s, cpu in ((25000, 0, False), (25000, 0.02, False),
                                   (3000, 0, True), (3000, 0.02, True)):
            print(json.dumps(trace(x, n_adds, pad_s, cpu, t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
