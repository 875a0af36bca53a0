"""Host spans, the device trace and their reduction.

Spans are the benchmark's own: ``(name, start, end)`` on the host's
``perf_counter`` clock, kept in memory during the run.  The device trace
is ``torch.profiler`` with CUDA activity alone (recording the host's
operations too slows a kernel-heavy loop by orders of magnitude); the
host waits 50 ms after the trace starts and before it stops, or the
trace loses its first or last records.  A short marker kernel
(``torch.cuda._sleep``) launched right after a synchronize at a known
host time puts the device's records on the host's clock; a second one
closes the window.
"""

from __future__ import annotations

import re
import time
from pathlib import Path

MARK = "spin_kernel"
WAIT_S = 0.05


class Spans:
    """Named host intervals, in memory."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []

    def add(self, name: str, t0: float, t1: float) -> None:
        self.items.append((name, t0, t1))

    def of(self, name: str, lo: float = float("-inf"),
           hi: float = float("inf")) -> list[tuple[float, float]]:
        return [(a, b) for n, a, b in self.items
                if n == name and a >= lo and b <= hi]


class Trace:
    """A device trace over the measured window."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        time.sleep(WAIT_S)
        torch.cuda.synchronize()
        self.t_open = time.perf_counter()
        torch.cuda._sleep(1000)

    def close(self) -> None:
        torch = self.torch
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(WAIT_S)
        self.prof.stop()

    def records(self) -> list[tuple[str, float, float]]:
        """Device records (name, start, end) strictly between the two
        markers, on the host clock (seconds)."""
        torch = self.torch
        recs = [(e.name(), e.start_ns(), e.end_ns())
                for e in self.prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA]
        marks = sorted((a, b) for n, a, b in recs if MARK in n)
        if len(marks) < 2:
            raise RuntimeError(f"device trace: {len(marks)} of 2 marker "
                               f"kernels in {len(recs)} records")
        lo, hi = marks[0], marks[-1]
        # the first marker starts ~ when the host launched it
        off = lo[0] * 1e-9 - self.t_open
        return sorted((n, a * 1e-9 - off, b * 1e-9 - off)
                      for n, a, b in recs
                      if MARK not in n and a >= lo[1] and b <= hi[0])


def union(intervals) -> list[tuple[float, float]]:
    """The union of [start, end) intervals, merged and sorted."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy(records, lo: float, hi: float) -> float:
    """Seconds in [lo, hi] in which some record ran."""
    return sum(min(b, hi) - max(a, lo)
               for a, b in union((a, b) for _, a, b in records)
               if b > lo and a < hi)


def gaps(records, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle intervals of [lo, hi] between the records."""
    out, at = [], lo
    for a, b in union((a, b) for _, a, b in records):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def host_state(spans: Spans, t: float, names) -> str:
    """The innermost of ``names``' spans that holds time ``t`` (the
    latest-starting), else "loop"."""
    best, start = "loop", float("-inf")
    for n, a, b in spans.items:
        if n in names and a <= t < b and a > start:
            best, start = n, a
    return best


def quantile(xs, q: float) -> float:
    """The ``q`` quantile of ``xs`` by linear interpolation between the
    order statistics (numpy's default)."""
    s = sorted(xs)
    if not s:
        raise ValueError("quantile of nothing")
    pos = q * (len(s) - 1)
    i = int(pos)
    j = min(i + 1, len(s) - 1)
    return s[i] + (s[j] - s[i]) * (pos - i)


_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?(\w+)\s*\(")


def kernel_names(csrc: Path) -> dict[str, tuple[str, ...]]:
    """The hand-written kernels' names, each with the stems of the source
    files that define it (``scalar2``, ``elastic``, ...): every
    ``__global__`` function of the program's CUDA sources."""
    out: dict[str, tuple[str, ...]] = {}
    for f in sorted(csrc.glob("*.cu")):
        for m in _GLOBAL.finditer(f.read_text()):
            out[m.group(1)] = out.get(m.group(1), ()) + (f.stem,)
    return out


def _plain(record_name: str) -> str:
    s = record_name.replace("(anonymous namespace)::", "")
    return s[5:] if s.startswith("void ") else s


def base_name(record_name: str) -> str:
    """A device record's function name without return type, namespaces,
    template arguments and parameters ("(anonymous namespace)::
    fwd_resident<1>((anonymous namespace)::FwdArgs)" -> "fwd_resident")."""
    s = re.split(r"[<(]", _plain(record_name), maxsplit=1)[0].strip()
    return s.rsplit("::", 1)[-1]


def short(record_name: str, width: int = 80) -> str:
    return _plain(record_name)[:width]
