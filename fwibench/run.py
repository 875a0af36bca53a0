#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch + CUDA port.

    python3 fwibench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for.  The cell (``BENCHMARK.json``'s ``workloads``) names a
configuration (``fwibench/configs/<config>.json``: the registered
recipe, the sizes as run) and a traffic mix
(``fwibench/traffic/<traffic>.json``: the recipe's overrides); its
limits are ``fwibench/limits/<cell>.json`` and each per-layer metric is
read by ``fwibench/metrics/<metric>.py``.

Set-up makes the inputs from the seed (models, wavelet, acquisition,
generator weights on the card), builds the engine
(``create_engine``), and drives it through ``engine/train.py::train``
for its first epochs: the compared steps, images and a checkpoint.  The
window then hands that engine to ``train`` again, epoch after epoch,
for ``--seconds``; the epoch times are the intervals between the
engine's ``optimize_parameters`` calls on this process's clock, and the
window ends at the first call past the deadline.  After the window the
program's state is freed and the plain reference
(``fwibench/reference``) follows the compared steps from the same
inputs; ``correct`` holds when every compared number is within its
limit.  The last line of standard output is the result's JSON.

A recipe with anchor epochs (``lstart``) has the reference run them
first, from the seed, before the engine is built (its seconds are not
set-up, and its memory is freed and off the device during the window).
The engine runs its own anchor epochs from the seed, compared as
``anchor``; at ``lstart`` the reference's weights and Adam moments are
loaded into it, so that the compared physics steps of both sides, and
the held-out misfit the drift guard takes there, start from a state the
reference made.

Exit codes: 0 a result; 2 no card (or too few); 3 JAX loaded; 1 any
other failure.  A run writes only the checkout's ``build/`` (the kernel
library) and a directory under ``TMPDIR`` (logs, images, checkpoints),
which it removes.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for _k, _v in (("PBFWI_TORCH_BUILD_DIR", "build/torch_kernels"),
               ("TORCH_EXTENSIONS_DIR", "build/torch_extensions"),
               ("TRITON_CACHE_DIR", "build/triton")):
    os.environ[_k] = str(ROOT / _v)
os.environ.setdefault("USE_FLAX", "0")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from fwibench import devtrace, inputs  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "physicsbasedfwi2_tpu")
PROGRAM = "physicsbasedfwi2_tpu_torch"


class WindowClosed(Exception):
    """Raised at the first ``optimize_parameters`` call past the
    deadline: that epoch is not run."""


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's, optax's or
    the JAX package's (the whole top-level name compared)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"fwibench: no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: dict) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries that ``cell`` reports."""
    def mine(m):
        return m.get("workloads") is None or cell["name"] in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell["name"] in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def reader(name: str):
    """``fwibench/metrics/<name>.py``'s ``read``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"fwibench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Clock:
    """Wraps the engine's calls: the time of each ``optimize_parameters``
    call, the compared steps' state, and (traced runs) spans of
    ``test`` and ``holdout_misfit``.  Reads the host clock only."""

    def __init__(self, engine, spans: devtrace.Spans, snap: dict):
        self.engine, self.spans, self.snap = engine, spans, snap
        self.calls: list[float] = []
        self.epoch = 0
        self.deadline = None
        self.seconds = None
        self.window = False
        self._opt = engine.optimize_parameters
        engine.optimize_parameters = self._optimize

    def trace_spans(self):
        for name, attr in (("test", "test"), ("holdout", "holdout_misfit")):
            fn = getattr(self.engine, attr, None)
            if fn is not None:
                setattr(self.engine, attr, self._span(name, fn))

    def _span(self, name, fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.spans.add(name, t0, time.perf_counter())
            return out
        return wrapped

    def _optimize(self, epoch, *a, **kw):
        t0 = time.perf_counter()
        self.epoch = epoch
        if self.window:
            if self.deadline is None:
                self.deadline = t0 + self.seconds
            self.calls.append(t0)
            if t0 >= self.deadline:
                raise WindowClosed
        out = self._opt(epoch, *a, **kw)
        t1 = time.perf_counter()
        if self.window:
            self.spans.add("optimize", t0, t1)
        if epoch in self.snap:
            self.snap[epoch](epoch, out)
        return out


def _load_state(engine, state: dict) -> None:
    """Put ``state`` ({"w", "m", "v", "t"}: the reference's weights, Adam
    moments and step count) into the engine's generator and optimizer."""
    import torch
    with torch.no_grad():
        for k, p in engine.net.named_parameters():
            p.copy_(state["w"][k])
            st = engine.opt.state[p]
            st["exp_avg"].copy_(state["m"][k])
            st["exp_avg_sq"].copy_(state["v"][k])
            if torch.is_tensor(st["step"]):
                st["step"].fill_(state["t"])
            else:
                st["step"] = state["t"]


def _warm_libraries(device) -> None:
    """The card's context, cuDNN and cuBLAS loaded (set-up, before the
    reference's anchor epochs would load them outside it)."""
    import torch
    if device.type != "cuda":
        return
    x = torch.ones((1, 1, 8, 8), device=device)
    torch.nn.functional.conv2d(x, torch.ones((1, 1, 3, 3), device=device))
    x[0, 0] @ x[0, 0]
    torch.cuda.synchronize(device)


def _state(engine, with_moments: bool) -> dict:
    """The engine's weights by name and, with ``with_moments``, Adam's
    first and second moments ("m", "v")."""
    out = {"w": {k: v.detach().clone()
                 for k, v in engine.net.named_parameters()}}
    if with_moments:
        st = engine.opt.state
        for key, name in (("m", "exp_avg"), ("v", "exp_avg_sq")):
            out[key] = {k: st[p][name].detach().clone()
                        for k, p in engine.net.named_parameters()}
    return out


def sizes(config: dict, traffic: dict, shrink=None) -> tuple[dict, dict]:
    """(sizes, engine-config fields) of a cell as run: the configuration's,
    the traffic's overrides, then ``shrink``'s (the CPU tests')."""
    size = {**config["size"], **(shrink or {}).get("size", {})}
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in {**config["engine_config"], **traffic["overrides"],
                           **(shrink or {}).get("engine_config", {})}.items()}
    fields.update({k: size[k] for k in (
        "nz", "nx", "dx", "nt", "dt", "pml_width", "num_shots",
        "num_receivers", "water_rows", "freq")})
    return size, fields


def reference_case(size: dict, cfg, models: dict, geom: dict, wav,
                   weights: dict, device, n_cmp: int) -> dict:
    """The reference's inputs for the first ``n_cmp`` physics steps: the
    seed's inputs, the recipe's settings as run, and for the elastic
    recipes the held-out shots and each epoch's shot draw."""
    c = {k: getattr(cfg, k) for k in (
        "water_vel", "grad_scale", "lr", "beta1", "adam_eps", "lstart",
        "freq_stages", "grad_taper_rows", "tether_weight", "water_rows",
        "delta_scale", "clip_min", "clip_max", "step_cap",
        "phase_reset_opt")}
    c["physics"] = size["physics"]
    draws = hold = None
    if size["physics"] == "elastic":
        c["delta_scale"] = tuple(c["delta_scale"] or (100.0, 100.0))[:2]
        c["clip_min"] = tuple(c["clip_min"] or (1500.0, 0.0))[:2]
        c["clip_max"] = tuple(c["clip_max"] or (4700.0, 2700.0))[:2]
        if c["grad_taper_rows"] is None:
            c["grad_taper_rows"] = c["water_rows"]
        hold, pool = inputs.holdout_split(size["num_shots"],
                                          cfg.holdout_shots)
        nsub = min(cfg.shots_per_iter or size["num_shots"], len(pool))
        draws = inputs.shot_draws(inputs.seed_of(cfg.seed),
                                  cfg.lstart + n_cmp, pool, nsub)
    g = {"nz": size["nz"], "nx": size["nx"], "dx": size["dx"],
         "dt": size["dt"], "pml": size["pml_width"], "vmax_pml": 5000.0}
    return {"config": c, "grid": g, "geom": geom, "wavelet": wav,
            "models": models, "weights": weights, "device": device,
            "arch": arch_of(cfg, size), "draws": draws, "hold": hold}


def arch_of(cfg, size: dict) -> dict:
    return {"net": cfg.netG, "in_shape": (size["nt"], size["num_receivers"],
                                          size["num_shots"]),
            "out_shape": (size["nz"], size["nx"]),
            "filters": tuple(cfg.filters), "latent_dim": cfg.latent_dim,
            "time_decimation": cfg.time_decimation, "n_fields": 2}


def build_engine(cfg, size: dict, models: dict, geom: dict, wav, device):
    """``create_engine`` on a workload of the seed's models, wavelet and
    acquisition, without observed data: the engine makes them with its
    path's forward operator."""
    import numpy as np
    import torch
    from physicsbasedfwi2_tpu_torch.engine.engines import create_engine
    from physicsbasedfwi2_tpu_torch.geo import Grid2D
    from physicsbasedfwi2_tpu_torch.geo.acquisition import Acquisition
    acq = Acquisition(*(np.asarray(geom[k], np.int32)
                        for k in ("src_z", "src_x", "rcv_z", "rcv_x")))

    def dev(a):
        return torch.as_tensor(a, device=device)

    if size["physics"] == "acoustic":
        from physicsbasedfwi2_tpu_torch.data.synthetic import (
            SyntheticAcousticWorkload)
        from physicsbasedfwi2_tpu_torch.ops import AcousticConfig
        grid = Grid2D(nz=size["nz"], nx=size["nx"], dx=size["dx"],
                      nt=size["nt"], dt=size["dt"],
                      pml_width=size["pml_width"])
        wl = SyntheticAcousticWorkload(
            grid=grid, cfg=AcousticConfig(grid=grid, chunk=cfg.chunk,
                                          vmax_pml=5000.0),
            acq=acq, wavelet=wav.clone(), vp_true=dev(models["true"]["vp"]),
            vp_start=dev(models["start"]["vp"]), obs=None, obs_norm=None)
    else:
        from physicsbasedfwi2_tpu_torch.data.synthetic import (
            SyntheticElasticWorkload)
        from physicsbasedfwi2_tpu_torch.ops.elastic import ElasticConfig
        grid = Grid2D(nz=size["nz"], nx=size["nx"], dx=size["dx"],
                      nt=size["nt"], dt=size["dt"],
                      pml_width=size["pml_width"], free_surface=True)
        wl = SyntheticElasticWorkload(
            grid=grid, cfg=ElasticConfig(grid=grid, chunk=cfg.chunk,
                                         vmax_pml=5000.0),
            acq=acq, wavelet=wav.clone(),
            true={k: dev(v) for k, v in models["true"].items()},
            start={k: dev(v) for k, v in models["start"].items()},
            obs_vx=None, obs_vz=None)
    return create_engine(cfg, workload=wl, device=device)


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        device=None, shrink: dict | None = None, hook=None) -> dict:
    """One run of ``cell_name``; returns the result (``correct``,
    ``metrics``, ``device``, ``checks``, ...).  ``shrink`` overrides sizes
    (the CPU tests' tiny shapes) and ``hook(engine)`` may alter the
    engine before its first epoch (the tests' planted faults)."""
    import torch
    import physicsbasedfwi2_tpu_torch as program
    if ROOT not in Path(program.__file__).resolve().parents:
        raise RuntimeError(f"{PROGRAM} loaded from {program.__file__}, "
                           f"not from this checkout ({ROOT})")
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.train import train
    from physicsbasedfwi2_tpu_torch.experiments import timing
    from fwibench.reference import generator, steps

    bench = manifest()
    cell = cell_of(bench, cell_name)
    config = load_json(BENCH / "configs" / f"{cell['config']}.json")
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{cell_name}.json")
    e2e, layer = cell_metrics(bench, cell)
    device = torch.device(device or "cuda:0")
    s = inputs.seed_of(seed)
    spans = devtrace.Spans()
    tmp = tempfile.mkdtemp(prefix="fwibench-")
    try:
        size, fields = sizes(config, traffic, shrink)
        cfg = get_workload(config["recipe"], **fields, seed=s,
                           save_dir=tmp, name=cell_name)
        n_cmp = limits["steps"]
        warm = max((shrink or {}).get("setup_epochs",
                                      traffic["setup_epochs"]),
                   cfg.lstart + n_cmp)

        # ---- set-up: inputs ---------------------------------------------
        t0 = time.perf_counter()
        models = inputs.models(size, s)
        geom = inputs.acquisition(size)
        wav = inputs.ricker(size["freq"], size["nt"], size["dt"], device)
        arch = arch_of(cfg, size)
        weights = inputs.weights(generator.spec(arch), s, device)
        _warm_libraries(device)

        # ---- the reference's anchor epochs, off the set-up's clock ------
        t_ref = time.perf_counter()
        case = reference_case(size, cfg, models, geom, wav, weights, device,
                              n_cmp)
        ref_anchor = steps.anchor(case)
        if ref_anchor is not None:
            ref_anchor, case = steps.move((ref_anchor, case), "cpu")
            steps.release()
            if device.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
        t_pre = time.perf_counter() - t_ref

        # ---- set-up: engine, first epochs -------------------------------
        engine = build_engine(cfg, size, models, geom, wav, device)
        engine.net.load_state_dict(weights)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        spans.add("workload", t0 + t_pre, time.perf_counter())
        if hook is not None:
            hook(engine)

        prog: dict = {"loss": []}
        first = cfg.lstart + 1
        b1 = cfg.beta1

        def snap(epoch, out):
            key = "loss_D" if "loss_D" in out else "loss_D_MSE"
            if epoch == 1:
                prog["mse1"] = float(out["loss_M_MSE"])
            if epoch > cfg.lstart:
                prog["loss"].append(float(out[key]))
            if epoch == cfg.lstart and epoch > 0:
                prog["w_anchor"] = _state(engine, False)["w"]
                _load_state(engine, ref_anchor["state_anchor"])
                st = _state(engine, True)
                prog["w_anchor_from"], prog["m_anchor"] = st["w"], st["m"]
            if epoch == first:
                m = _state(engine, True)["m"]
                m0 = None if cfg.phase_reset_opt else prog.get("m_anchor")
                prog["g1"] = {k: (v - (b1 * m0[k] if m0 else 0.0)) / (1 - b1)
                              for k, v in m.items()}
            if epoch == cfg.lstart + n_cmp:
                prog["w_end"] = _state(engine, False)["w"]

        prog["w0"] = {k: v.detach().clone()
                      for k, v in engine.net.named_parameters()}
        clock = Clock(engine, spans, {e: snap for e in range(
            1, cfg.lstart + n_cmp + 1)})
        if cfg.holdout_shots:
            _first_holdout(engine, clock, prog)
        total = cfg.n_epochs + cfg.n_epochs_decay
        train(cfg, engine=engine, epochs=warm, quiet=True)
        if cfg.holdout_shots:
            del engine.holdout_misfit
            if "loss_H" not in prog:
                raise RuntimeError("no held-out misfit in set-up")
        prog_obs = (engine.wl.obs.detach().cpu()
                    if size["physics"] == "acoustic" else
                    (engine.wl.obs_vx.detach().cpu(),
                     engine.wl.obs_vz.detach().cpu()))
        if trace:
            clock.trace_spans()
            tr = devtrace.Trace()
            before = timing.launch_counts()
        if device.type == "cuda":
            torch.cuda.synchronize(device)

        # ---- the window -----------------------------------------------
        gc.collect()
        clock.window, clock.seconds = True, seconds
        t_window = time.perf_counter()
        try:
            train(cfg, engine=engine, epochs=total, start_epoch=warm + 1,
                  quiet=True)
        except WindowClosed:
            pass
        else:
            raise RuntimeError("the recipe's epochs ended inside the window")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_end = time.perf_counter()
        calls = clock.calls
        epochs = len(calls) - 1
        if epochs < 2:
            raise RuntimeError(f"{epochs} whole epochs in the window")
        ep_times = [b - a for a, b in zip(calls, calls[1:])]
        found = forbidden_modules()
        if found:
            return {"forbidden": found}
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        ctx = None
        if trace:
            tr.close()
            launches = timing.launches_since(before)
            ctx = Context(
                cell=cell, size=size, cfg=cfg, spans=spans,
                calls=calls, ep_times=ep_times, launches=launches,
                records=tr.records(), lo=calls[0], hi=calls[-1],
                kernels=devtrace.kernel_names(
                    ROOT / PROGRAM / "csrc"),
                gen_flop=_generator_flop(arch))
        engine.optimize_parameters = clock._opt
        del engine, clock
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

        # ---- the reference follows the compared steps -----------------
        case, ref_anchor = steps.move((case, ref_anchor), device)
        ref = steps.run(case, n_cmp, anchor=ref_anchor)
        nums = steps.numbers(prog, ref)
        nums["obs"] = steps.obs_gap(prog_obs, ref["obs"])
        if "loss_H" in prog:
            w_h = (ref["w_anchor"] if prog["h_epoch"] == cfg.lstart
                   and "w_anchor" in ref else prog["w_H"])
            nums["lossH"] = steps.rel(prog["loss_H"], steps.holdout_loss(
                case, w_h, prog["h_fc"]))
        info = {}
        checks = {}
        for k, lim in limits["limits"].items():
            checks[k] = {"value": nums[k], "limit": lim}
        correct = all(c["value"] <= c["limit"] for c in checks.values())
        for k, v in nums.items():
            if k not in checks:
                info[k] = v

        result = {"correct": correct, "attempted": epochs, "failed": 0}
        if trace:
            vals = {}
            for m in layer:
                v = reader(m["name"])(ctx)
                if v is not None:
                    vals[m["name"]] = {"value": v, "unit": m["unit"]}
            result["metrics"] = vals
            result["breakdown"] = breakdown(ctx)
        else:
            setup_s = t_window - T_START - t_pre
            known = {"setup_s": setup_s,
                     "epoch_s": (calls[-1] - calls[0]) / epochs,
                     "epoch_p95_s": devtrace.quantile(ep_times, 0.95)}
            result["metrics"] = {m["name"]: {"value": known[m["name"]],
                                             "unit": m["unit"]}
                                 for m in e2e}
        result["device"] = device_line(device, peak, ctx)
        zero = {k: (0, 0, 0) for k in timing.launch_counts()}
        result["info"] = {"epochs": epochs, "window_s": t_end - t_window,
                          "route": timing.route(timing.launches_since(zero)),
                          **info}
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _first_holdout(engine, clock: Clock, prog: dict) -> None:
    """Keep the first held-out misfit the engine takes in set-up (the
    drift guard's at ``lstart``, at the reference's state): its value,
    epoch, band and the weights it was taken at."""
    fn = engine.holdout_misfit

    def first(fc=None):
        v = fn(fc)
        if "loss_H" not in prog:
            prog.update(loss_H=float(v), h_epoch=clock.epoch, h_fc=fc,
                        w_H=_state(engine, False)["w"])
        return v

    engine.holdout_misfit = first


def _generator_flop(arch: dict) -> float:
    """The generator's flop in one epoch: a training decode's forward
    and backward and the validation decode's forward, counted on the
    reference's layers with meta tensors."""
    import torch
    from fwibench import counts
    from fwibench.reference import generator
    meta = torch.device("meta")
    w = {k: torch.empty(shape, device=meta, requires_grad=True)
         for k, shape, _, _ in generator.spec(arch)}
    prec = generator.Precision("fp32")
    x = torch.empty((1, *arch["in_shape"]), device=meta)

    def fwd():
        if arch["net"] == "Auto22":
            return generator.auto22(w, x, arch, prec)
        return generator.autoelmar22(w, x, x, arch, prec)

    return (counts.generator_flop(lambda: fwd().sum().backward())
            + counts.generator_flop(fwd))


class Context:
    """What a per-layer metric's reader reads: the cell, its sizes and
    recipe, host spans, epoch call times, launch counts by kernel over
    the window, the device records on the host clock, the window
    [lo, hi] (first to last ``optimize_parameters`` call), the
    hand-written kernels' names by source, and the generator's flop an
    epoch."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    @property
    def epochs(self) -> int:
        return len(self.calls) - 1

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def in_window(self):
        return [r for r in self.records if r[1] >= self.lo and r[2] <= self.hi]

    def busy_s(self) -> float:
        return devtrace.busy(self.records, self.lo, self.hi)

    def hand_written(self, name: str) -> tuple[str, ...]:
        """The source stems that define a device record's kernel; empty
        for a library's or PyTorch's."""
        return self.kernels.get(devtrace.base_name(name), ())


def breakdown(ctx: Context) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each gap named by the host span it fell in."""
    tot: dict[str, float] = {}
    for n, a, b in ctx.in_window():
        k = devtrace.short(n)
        tot[k] = tot.get(k, 0.0) + (b - a)
    ops = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
    gaps = devtrace.gaps(ctx.records, ctx.lo, ctx.hi)
    named = [(devtrace.host_state(ctx.spans, 0.5 * (a + b),
                                  ("test", "optimize", "holdout")), b - a)
             for a, b in gaps]
    named.sort(key=lambda kv: -kv[1])
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in named[:10]]}


def device_line(device, peak: int, ctx) -> dict:
    import torch
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    out = {"platform": platform, "kind": kind, "count": 1,
           "memory_peak_bytes": int(peak)}
    if ctx is not None:
        out["busy_s"] = ctx.busy_s()
        out["window_s"] = ctx.window_s
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = cell_of(manifest(), args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"fwibench: {cell['name']} needs {cell['chips']} CUDA "
              f"card(s); {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2
    from physicsbasedfwi2_tpu_torch.experiments import timing
    print(f"fwibench: {timing.card(torch.device('cuda:0'))}", file=sys.stderr)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules() or result.get("forbidden")
    if found:
        print(f"fwibench: loaded {found}: the run must not import JAX or "
              f"the JAX package", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
