"""The timing harnesses (``physicsbasedfwi2_tpu_torch/experiments/``:
``bench``, ``bench_configs``, ``bench_elastic``, ``bench_kernel_breakdown``)
against the JAX package's ``bench.py`` and ``benchmarks/`` tools, on the
CPU at shrunk sizes.

The JAX tools are imported from their files through the fixture of
tests/test_torch_experiments.py.  ``bench.py``'s chained iterations are
compiled there at full size inside ``run()``, so the JAX side here
composes the JAX package's functions as ``run()`` and ``run_elastic()``
compose them, on the port's shrunk case (the same numpy arrays), with
the Pallas kernels in interpret mode.  The port runs through its plain
kernel versions (``device="cpu"``).
"""

import argparse
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from physicsbasedfwi2_tpu.geo import Grid2D as JGrid
from physicsbasedfwi2_tpu.ops import (
    AcousticConfig as JAcoustic, ElasticConfig as JElastic,
    select_acoustic as j_select, simulate_elastic as j_simulate_elastic,
    trace_normalize as j_tn,
)
from physicsbasedfwi2_tpu.ops import pallas_elastic_fused as jef
from physicsbasedfwi2_tpu.ops.elastic_fast import (
    simulate_elastic_fast as j_simulate_elastic_fast,
)
from physicsbasedfwi2_tpu.ops.pallas_fwi_fused import (
    fwi_l1_loss_grad as j_fwi_l1_loss_grad, scatter_rows as j_scatter_rows,
)
from physicsbasedfwi2_tpu.ops.pallas_scalar2 import (
    acoustic_pallas2 as j_acoustic_pallas2,
)
from physicsbasedfwi2_tpu_torch.experiments import (
    bench, bench_configs, bench_elastic, bench_kernel_breakdown,
)
from physicsbasedfwi2_tpu_torch.landscape.cli import small_overrides
from physicsbasedfwi2_tpu_torch.ops import trace_normalize
from physicsbasedfwi2_tpu_torch.ops.fwi_fused import fwi_l1_loss_grad_plain
from physicsbasedfwi2_tpu_torch.ops.scalar2 import (
    acoustic_pallas2, scatter_rows,
)

from torch_parity import n, rel_max

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# (loss rtol, gradient tolerance of its max) by backend or scheme.  A
# bound of (1e-5, 1e-4) is below float32 rounding on these cases: each
# package's float32 gradient stands 1e-4 to 8e-4 of its max from the
# port's float64 run of the same scheme, largest at the source cells
# (measured on the CPU, port / JAX: xla 1.0e-4 / 1.4e-4, B2 7.8e-4 /
# 2.3e-4 (the L1 misfit's zero-lag correlation cancels in float32),
# sponge 1.2e-4 / 0.9e-4, split PML 2.4e-4 / 1.8e-4; B2's loss 1.5e-5 /
# 8.9e-5, the split-PML loss 3.2e-6 / 6e-6).  The bounds are about
# twice those, and the test holds the port's float32 run to its float64
# run within the same bound.
TOLS = {"pallas": (2e-4, 2e-3), "xla": (1e-5, 5e-4), "fused": (1e-5, 5e-4),
        "fast": (1e-5, 5e-4), "pml": (3e-5, 1e-3)}
_ORIG_PALLAS_CALL = pl.pallas_call


@pytest.fixture(scope="module")
def jtool():
    """The JAX package's ``bench.py`` and ``benchmarks/`` timing tools,
    each imported from its file.  An import that points
    ``jax_compilation_cache_dir`` at the repository's ``.cache/jax`` has
    the previous setting put back."""
    prev = jax.config.jax_compilation_cache_dir
    mods = {}
    try:
        for name, path in (("bench", ROOT / "bench.py"),
                           ("bench_configs",
                            ROOT / "benchmarks" / "bench_configs.py")):
            spec = importlib.util.spec_from_file_location(
                f"jax_bench_{name}", path)
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
    return mods


@contextlib.contextmanager
def interpret_mode():
    """Every ``pl.pallas_call`` in interpret mode (``acoustic_pallas2``
    takes no ``interpret`` argument)."""
    def call(*a, **k):
        return _ORIG_PALLAS_CALL(*a, **{**k, "interpret": True})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", call)
        yield


def _jax_cfg(cfg, cls):
    """The JAX config of a port config (the same fields)."""
    fields = dataclasses.asdict(cfg)
    return cls(grid=JGrid(**fields.pop("grid")), **fields)


def _j(a):
    return jnp.asarray(n(a))


def _lines(text: str) -> list[dict]:
    return [json.loads(s) for s in text.splitlines() if s.startswith("{")]


def _main(main, argv) -> tuple[int, list[dict]]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, _lines(out.getvalue())


def _compare(port_evals, ref_evals, tols):
    """Each evaluation's loss to ``tols[0]`` (relative), each gradient to
    ``tols[1]`` of its max."""
    for (pl_, *pg), (rl, *rg) in zip(port_evals, ref_evals, strict=True):
        np.testing.assert_allclose(float(pl_), float(rl), rtol=tols[0])
        for a, b in zip(pg, rg, strict=True):
            assert rel_max(a, b) <= tols[1], rel_max(a, b)


def _port_chains(vg, params, lr):
    """The port's chain of two iterations: the summed losses after one
    (its first evaluation's loss: ``chain`` adds it to a float32 zero,
    test_chain_feeds_each_step_and_sums_the_losses) and after two, and
    each evaluation's (loss, *grads)."""
    evals = []

    def recorded(*p):
        out = vg(*p)
        evals.append(out)
        return out
    acc2, _ = bench.chain(recorded, params, 2, lr)
    return float(evals[0][0]), float(acc2), evals


def _jax_chain(vg, params, lr):
    """Two chained iterations as ``bench.py``'s ``chain`` body runs them
    (``p - lr * grad``, the losses summed): the summed losses after one
    and after two, and each evaluation's (loss, *grads)."""
    evals, acc, accs = [], 0.0, []
    for _ in range(2):
        loss, *grads = vg(*params)
        evals.append((loss, *grads))
        params = tuple(p - lr * g for p, g in zip(params, grads))
        acc = acc + loss
        accs.append(float(acc))
    return accs, evals


def test_chain_feeds_each_step_and_sums_the_losses():
    """``chain``: each ``p - lr * grad`` feeds the next call, the losses
    are summed from a float32 zero on the params' device."""
    seen = []

    def vg(a, b):
        seen.append((a.clone(), b.clone()))
        return (a.sum() + 2 * b.sum(), torch.full_like(a, 1.0),
                torch.full_like(b, 4.0))
    p0 = (torch.zeros(2), torch.ones(3))
    for n in (1, 2, 3):
        seen.clear()
        acc, (a, b) = bench.chain(vg, p0, n, 0.5)
        assert [float(x[0][0]) for x in seen] == [-0.5 * k for k in range(n)]
        assert [float(x[1][0]) for x in seen] == [1.0 - 2.0 * k
                                                  for k in range(n)]
        # loss_k = 2 (-0.5 k) + 2 * 3 (1 - 2 k)
        assert float(acc) == sum(-k + 6 * (1 - 2 * k) for k in range(n))
        assert acc.dtype == torch.float32
        assert torch.equal(a, torch.full((2,), -0.5 * n))
        assert torch.equal(b, torch.full((3,), 1.0 - 2.0 * n))


# ------------------------------------------------------------------ build

def test_build_matches_jax_bench_build(jtool):
    """The full-size acoustic case equals ``bench.build()``: the models and
    geometry to the bit, the wavelet within one float32 ulp of its peak
    1.0 (the two packages' float32 ``exp`` round apart at a few
    samples), and the config's fields."""
    jcfg, jwav, jgeom, jvp_true, jvp0 = jtool["bench"].build()
    cfg, wav, geom, vp_true, vp0 = bench.build(device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    np.testing.assert_array_equal(n(vp_true), np.asarray(jvp_true))
    np.testing.assert_array_equal(n(vp0), np.asarray(jvp0))
    assert n(vp_true).dtype == n(vp0).dtype == np.float32
    for a, b in zip(geom, jgeom, strict=True):
        np.testing.assert_array_equal(n(a), np.asarray(b))
        assert n(a).dtype == np.asarray(b).dtype
    np.testing.assert_allclose(n(wav), np.asarray(jwav), rtol=0,
                               atol=np.spacing(np.float32(1.0)))


# ------------------------------------------------------- chained iterations

@pytest.fixture(scope="module")
def acoustic_case():
    return bench.build(device="cpu", **bench.SMALL)


@pytest.fixture(scope="module")
def elastic_case():
    return bench.build_elastic(device="cpu", **bench.SMALL_EL)


def _jax_acoustic_value_and_grad(backend, case):
    """bench.py's ``run()`` value and gradient on the same arrays (each
    part under ``jax.jit``: one compile, not one an op)."""
    cfg, wav, geom, vp_true, _ = case
    jcfg = _jax_cfg(cfg, JAcoustic)
    g = jcfg.grid
    wav, vp_true = _j(wav), _j(vp_true)
    geom = tuple(_j(a) for a in geom)
    if backend == "pallas":
        def rows(v):
            obs_norm = j_tn(j_acoustic_pallas2(v, wav, *geom, jcfg))
            direct = j_acoustic_pallas2(jnp.full_like(v, 1500.0), wav,
                                        *geom, jcfg)
            return tuple(j_scatter_rows(d, geom[3], nt=g.nt, nx=g.nx,
                                        pml_width=g.pml_width)
                         for d in (obs_norm, direct))
        with interpret_mode():
            obs_rows, dir_rows = jax.jit(rows)(vp_true)
        return jax.jit(lambda v: j_fwi_l1_loss_grad(
            v, wav, *geom, jcfg, obs_rows, dir_rows, interpret=True))
    sim = j_select(backend)
    obs_norm, direct = jax.jit(lambda v: (
        j_tn(sim(v, wav, *geom, jcfg)),
        sim(jnp.full_like(v, 1500.0), wav, *geom, jcfg)))(vp_true)

    def loss_fn(v):
        pred = sim(v, wav, *geom, jcfg) - direct
        m = jnp.max(jnp.abs(pred), axis=1, keepdims=True)
        return jnp.mean(jnp.abs(pred / (m + 1e-10) - obs_norm))
    return jax.jit(jax.value_and_grad(loss_fn))


def _float64(case):
    """The case with its float arrays in float64 (the autograd schemes
    then run in float64)."""
    return tuple(a.double() if isinstance(a, torch.Tensor) else a
                 for a in case)


def _float64_b2(case):
    """B2's plain version in float64 at vp0, on the rows ``pallas``
    builds."""
    cfg, wav, geom, vp_true, vp0 = case
    g = cfg.grid
    obs_norm = trace_normalize(acoustic_pallas2(vp_true, wav, *geom, cfg))
    direct = acoustic_pallas2(torch.full_like(vp_true, 1500.0), wav, *geom,
                              cfg)
    rows = [scatter_rows(d, geom[3], nt=g.nt, nx=g.nx, pml_width=g.pml_width)
            for d in (obs_norm, direct)]
    return fwi_l1_loss_grad_plain(vp0, wav, *geom, cfg, *rows,
                                  dtype=torch.float64)


@pytest.mark.parametrize("backend", bench.BACKENDS)
def test_acoustic_chain_matches_jax(acoustic_case, backend):
    vp0 = acoustic_case[4]
    tols = TOLS[backend]
    acc1, acc2, evals = _port_chains(
        bench.acoustic_value_and_grad(backend, acoustic_case), (vp0,), 1e-6)
    jvg = _jax_acoustic_value_and_grad(backend, acoustic_case)
    accs, jevals = _jax_chain(jvg, (_j(vp0),), 1e-6)
    np.testing.assert_allclose([acc1, acc2], accs, rtol=tols[0])
    _compare(evals, jevals, tols)
    if backend == "pallas":
        ref = _float64_b2(acoustic_case)
    else:
        case64 = _float64(acoustic_case)
        ref = bench.acoustic_value_and_grad(backend, case64)(case64[4])
    _compare(evals[:1], [ref], tols)


def _jax_elastic_value_and_grad(scheme, case):
    """bench.py's ``run_elastic()`` value and gradients on the same
    arrays (each part under ``jax.jit``)."""
    ecfg, wav, geom, _, vs, rho, vp_t = case
    jcfg = _jax_cfg(ecfg, JElastic)
    wav, vs, rho, vp_t = (_j(a) for a in (wav, vs, rho, vp_t))
    geom = tuple(_j(a) for a in geom)
    if scheme == "fused":
        orx, orz = jax.jit(lambda v: tuple(
            jef.scatter_rows_el(o, geom[3], jcfg, KC=8)
            for o in jef.simulate_elastic_ring(v, vs, rho, wav, *geom,
                                               jcfg)))(vp_t)

        def value_and_grad(vp_, vs_):
            loss, g = jef.fused_elastic_loss_grad(
                vp_, vs_, rho, wav, *geom, jcfg, orx, orz, KC=8,
                wrt=("vp", "vs"), interpret=True)
            return loss, g["vp"], g["vs"]
        return jax.jit(value_and_grad)
    sim = (j_simulate_elastic_fast if scheme == "fast"
           else j_simulate_elastic)
    ovx, ovz = jax.jit(lambda v: sim(v, vs, rho, wav, *geom, jcfg))(vp_t)

    def loss_fn(vp_, vs_):
        pvx, pvz = sim(vp_, vs_, rho, wav, *geom, jcfg)
        return jnp.mean((pvx - ovx) ** 2) + jnp.mean((pvz - ovz) ** 2)

    def value_and_grad(vp_, vs_):
        loss, (gvp, gvs) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            vp_, vs_)
        return loss, gvp, gvs
    return jax.jit(value_and_grad)


def test_elastic_case_matches_jax_expressions(elastic_case):
    """The shrunk elastic case is ``run_elastic()``'s construction at the
    shrunk size (water rows and block scaled with the grid): the
    geometry and models to the bit, rho within one ulp (float32 pow)."""
    ecfg, _, geom, vp, vs, rho, vp_t = elastic_case
    sz = bench.SMALL_EL
    nz, nx, ns, nr = sz["nz"], sz["nx"], sz["num_shots"], sz["num_receivers"]
    src_x = np.round(np.linspace(5, nx - 6, ns)).astype(np.int32)
    rcv_x = np.tile(np.round(np.linspace(1, nx - 2, nr)).astype(np.int32),
                    (ns, 1))
    for a, b in zip(geom, (np.full(ns, 2, np.int32), src_x,
                           np.full((ns, nr), 2, np.int32), rcv_x)):
        np.testing.assert_array_equal(n(a), b)
    water = nz * 10 // 100
    z = jnp.arange(nz, dtype=jnp.float32)[:, None]
    jvp = jnp.broadcast_to(
        1500.0 + jnp.where(z < water, 0.0, (z - water) * 25.0),
        (nz, nx)).astype(jnp.float32)
    jvs = jnp.where(jvp > 1500.0, jvp / 1.8, 0.0)
    jvp_t = jvp.at[nz * 40 // 100: nz * 60 // 100,
                   nx * 100 // 300: nx * 200 // 300].add(200.0)
    np.testing.assert_array_equal(n(vp), np.asarray(jvp))
    np.testing.assert_array_equal(n(vs), np.asarray(jvs))
    np.testing.assert_array_equal(n(vp_t), np.asarray(jvp_t))
    np.testing.assert_array_max_ulp(n(rho), np.asarray(310.0 * jvp ** 0.25),
                                    maxulp=1)
    assert ecfg.grid.free_surface and ecfg.grid.dx == 20.0


@pytest.mark.parametrize("scheme", bench.EL_SCHEMES)
def test_elastic_chain_matches_jax(elastic_case, scheme):
    params = (elastic_case[3], elastic_case[4])
    tols = TOLS[scheme]
    acc1, acc2, evals = _port_chains(
        bench.elastic_value_and_grad(scheme, elastic_case), params, 1e-3)
    jvg = _jax_elastic_value_and_grad(scheme, elastic_case)
    accs, jevals = _jax_chain(jvg, tuple(_j(p) for p in params), 1e-3)
    np.testing.assert_allclose([acc1, acc2], accs, rtol=tols[0])
    _compare(evals, jevals, tols)
    if scheme != "fused":  # B3's float64 plain run: test_torch_elastic.py
        case64 = _float64(elastic_case)
        ref = bench.elastic_value_and_grad(scheme, case64)(
            case64[3], case64[4])
        _compare(evals[:1], [ref], tols)


def test_bench_main_lines_on_the_cpu(monkeypatch):
    """``bench.main`` at the shrunk sizes: the JAX lines' metric names and
    fields (no elastic baseline), every path named, every value finite,
    the device "cpu", no kernel launched.  The end-to-end lines run over
    a stand-in ``bench_one`` (tested below); the chains at nt 60 (their
    values are held to JAX's above)."""
    calls = []
    monkeypatch.setattr(bench, "SMALL", dict(bench.SMALL, nt=60))
    monkeypatch.setattr(bench, "SMALL_EL", dict(bench.SMALL_EL, nt=60))

    def bench_one(workload, iters, **kw):
        calls.append((workload, iters, kw))
        return {"seconds_per_iteration": 0.25, "shots_per_sec": 1.0,
                "mcell_steps_per_sec": 1.0, "path": "fused-plain"}
    monkeypatch.setattr(bench, "bench_one", bench_one)
    rc, lines = _main(bench.main, [
        "--small", "--device", "cpu", "--iters", "1", "--engine-iters", "1",
        "--backend", "pallas", "--el-scheme", "fused,pml"])
    assert rc == 0
    assert [ln["metric"] for ln in lines] == [
        "marmousi_acoustic_fwi_iteration_wallclock_pallas",
        "marmousi_elastic_fwi_iteration_wallclock_fused",
        "marmousi_elastic_fwi_iteration_wallclock_pml",
        "marmousi_acoustic_engine_iteration_end_to_end",
        "marmousi_elastic_engine_iteration_end_to_end"]
    assert [ln["path"] for ln in lines] == [
        "fused-plain", "fused-plain", "pml", "fused-plain", "fused-plain"]
    for ln in lines:
        assert ln["device"] == "cpu" and ln["launches"] == {}
        assert ln["unit"] == "s" and np.isfinite(ln["value"]) \
            and ln["value"] > 0
        assert ("vs_baseline" in ln) == ("acoustic" in ln["metric"])
        assert "baseline" not in ln or "acoustic" in ln["metric"]
    assert abs(lines[0]["vs_baseline"] - 0.35 / lines[0]["value"]) <= 0.01
    assert lines[3]["vs_baseline"] == 1.4 and lines[4]["value"] == 0.25
    assert calls == [(w, 1, dict(device=torch.device("cpu"),
                                 **small_overrides(w == "marmousi_elastic")))
                     for w in ("marmousi_acoustic", "marmousi_elastic")]
    for bad in (["--backend", "pallas,cuda"], ["--el-scheme", "ring"]):
        with pytest.raises(SystemExit):
            bench.main(bad + ["--device", "cpu"])


def test_route_from_launch_counts():
    from physicsbasedfwi2_tpu_torch.experiments.timing import route
    assert route({}) == "plain"
    assert route({"a": [3, 3, 0], "b": [1, 1, 0]}) == "resident"
    assert route({"a": [2, 0, 2]}) == "per-step"
    assert route({"a": [3, 3, 0], "b": [1, 0, 1]}) == "mixed"


# ------------------------------------------------------------ bench_configs

def test_configs_equal_jax(jtool):
    assert bench_configs.CONFIGS == jtool["bench_configs"].CONFIGS


class _Clock:
    """A ``time`` module whose ``perf_counter`` steps 0.5 s a read."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += 0.5
        return self.now


class _Engine:
    def __init__(self, cfg, **_):
        self.physics_path = "stand-in"
        self.device = torch.device("cpu")
        self.epochs = []

    def optimize_parameters(self, epoch):
        self.epochs.append(epoch)


def test_bench_one_arithmetic_matches_jax(jtool, monkeypatch):
    """Over a stand-in engine and the same clock, ``bench_one`` returns
    the JAX tool's record for every BASELINE config: the fields of
    bench_configs.py:63-70 from the registered config."""
    import physicsbasedfwi2_tpu.engine as j_engine
    monkeypatch.setattr(j_engine, "create_engine", _Engine)
    monkeypatch.setattr(bench_configs, "create_engine", _Engine)
    for _, workload in bench_configs.CONFIGS:
        monkeypatch.setattr(jtool["bench_configs"], "time", _Clock())
        want = jtool["bench_configs"].bench_one(workload, iters=3)
        monkeypatch.setattr(bench_configs, "time", _Clock())
        assert bench_configs.bench_one(workload, 3) == want


def test_bench_one_on_a_shrunk_workload():
    """``bench_configs.main --small`` on the CPU: the engine's
    physics-phase iterations at the CLIs' shrunk sizes, the JAX record's
    fields, the fused path's plain version (no kernel launched), and
    shots_per_sec and mcell_steps_per_sec from the config as
    bench_configs.py:63-70 has them (within the rounding of the
    seconds)."""
    small = small_overrides(False)
    rc, lines = _main(bench_configs.main, [
        "--small", "--device", "cpu", "--only", "marmousi_acoustic",
        "--iters", "1"])
    assert rc == 0 and len(lines) == 1
    r = lines[0]
    assert set(r) == {"config", "workload", "seconds_per_iteration",
                      "shots_per_sec", "mcell_steps_per_sec", "path",
                      "launches", "device"}
    assert r["config"] == "only_marmousi_acoustic"
    assert r["workload"] == "marmousi_acoustic"
    assert r["path"] == "fused-plain"
    assert r["device"] == "cpu" and r["launches"] == {}
    dt = r["seconds_per_iteration"]
    shots = small["num_shots"]
    assert dt > 0
    # within the rounding of the fields (2 and 1 decimals) and of dt (5)
    np.testing.assert_allclose(r["shots_per_sec"], shots / dt, rtol=1e-3,
                               atol=0.005)
    np.testing.assert_allclose(
        r["mcell_steps_per_sec"],
        small["nz"] * small["nx"] * small["nt"] * shots / dt / 1e6,
        rtol=1e-3, atol=0.05)


def test_failed_config_prints_its_row_and_exits_nonzero(monkeypatch):
    def bench_one(workload, iters, **kw):
        if workload == "latent_inversion":
            raise RuntimeError("stand-in failure")
        return {"seconds_per_iteration": 1.0, "shots_per_sec": 1.0,
                "mcell_steps_per_sec": 1.0, "path": "stand-in"}
    monkeypatch.setattr(bench_configs, "bench_one", bench_one)
    rc, lines = _main(bench_configs.main, ["--device", "cpu"])
    assert rc == 1
    assert [ln["workload"] for ln in lines] == [
        w for _, w in bench_configs.CONFIGS]
    bad = lines[3]
    assert bad == {"config": "4_vae_latent_inversion",
                   "workload": "latent_inversion",
                   "error": "RuntimeError: stand-in failure",
                   "device": "cpu"}
    assert all("error" not in ln for i, ln in enumerate(lines) if i != 3)
    assert all(ln["launches"] == {} for i, ln in enumerate(lines) if i != 3)
    monkeypatch.setattr(bench_configs, "bench_one",
                        lambda w, i, **kw: bench_one("ok", i))
    assert _main(bench_configs.main, ["--device", "cpu"])[0] == 0


# ------------------------------------------------------------ bench_elastic

def test_bench_elastic_line_on_the_cpu(monkeypatch):
    """``bench_elastic.main`` on the shrunk case (the full 100 x 300 grid
    takes ~30 s a chain on the CPU): the JAX line's fields, and the
    cell-steps over the padded grid x 3 passes."""
    sz = dict(bench.SMALL_EL, nt=40)
    monkeypatch.setattr(
        bench_elastic, "build_elastic",
        lambda nt, device: bench.build_elastic(device=device,
                                               **dict(sz, nt=nt)))
    rc, lines = _main(bench_elastic.main, ["--nt", "40", "--device", "cpu"])
    assert rc == 0 and len(lines) == 1
    ln = lines[0]
    assert set(ln) == {"metric", "value", "unit", "cell_steps_per_sec",
                       "workload", "path", "device"}
    assert ln["metric"] == "marmousi_elastic_fwi_iteration_wallclock"
    assert ln["workload"] == "3 shots x 0.1s x 20x32 P-SV fwd+adjoint"
    assert ln["device"] == "cpu" and ln["path"] == "pml" and ln["value"] > 0
    # padded 40 x 72 (free surface: no top PML), 3 passes; within the
    # rounding of the rate (4 digits) and of the seconds (4 decimals)
    cs = float(ln["cell_steps_per_sec"])
    np.testing.assert_allclose(cs * ln["value"], 3 * 40 * 40 * 72 * 3,
                               rtol=1e-3 + 5e-5 / ln["value"])


# -------------------------------------------------- the breakdown harness

# the JAX rows' keys (benchmarks/bench_kernel_breakdown.py:224-228, 254-263)
JAX_VARIANT_KEYS = {"variant", "s_per_call", "ns_per_cell_step",
                    "stencil_Tops", "nt"}
JAX_FULL_KEYS = {"variant", "s_per_call", "three_sweep_stencil_projection_s",
                 "structural_overhead_s", "src_cost_s", "rcv_cost_s",
                 "ckpt_cost_s", "nt"}


def test_breakdown_rows_carry_the_jax_keys():
    args = argparse.Namespace(kc=8, reps=1, device=torch.device("cpu"),
                              card="cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = bench_kernel_breakdown.measure_once(args, 6)
    rows = _lines(out.getvalue())
    assert [r["variant"] for r in rows] == [
        "stencil", "+src", "+rcv", "+ckpt", "full_fused"]
    for i, r in enumerate(rows[:4]):
        want = JAX_VARIANT_KEYS | ({"delta_s"} if i else set())
        assert set(r) == want | {"device"} and r["nt"] == 6
        assert res[r["variant"]] == r["s_per_call"] > 0
    assert set(rows[4]) == JAX_FULL_KEYS | {"device"}
    assert rows[4]["src_cost_s"] == rows[1]["delta_s"]
    assert res["full_fused"] == rows[4]["s_per_call"]


def test_full_row_checks_the_whole_gradient(monkeypatch):
    """The ``full_fused`` row's chained scalar carries every element of
    B2's gradient: one inf in it makes ``time_fn`` raise (the variants
    left out, a tiny case)."""
    B = bench_kernel_breakdown
    real = B.fwi_l1_loss_grad

    def tiny_case(nt, device):
        cfg, wav, geom, vp, _ = bench.build(nz=10, nx=12, nt=nt,
                                            num_shots=2, device=device)
        return cfg, wav, vp, geom

    def poisoned(*a, **k):
        loss, g = real(*a, **k)
        g = g.clone()
        g[4, 7] = float("inf")
        return loss, g
    monkeypatch.setattr(B, "VARIANTS", ())
    monkeypatch.setattr(B, "case", tiny_case)
    monkeypatch.setattr(B, "fwi_l1_loss_grad", poisoned)
    args = argparse.Namespace(kc=8, reps=2, device=torch.device("cpu"),
                              card="cpu")
    with pytest.raises(FloatingPointError, match="the last call gave"):
        B.measure_once(args, 6)


def test_breakdown_summary_by_hand():
    names = ("stencil", "+src", "+rcv", "+ckpt", "full_fused")
    passes = [dict(zip(names, v)) for v in (
        (0.010, 0.011, 0.012, 0.013, 0.050),
        (0.012, 0.010, 0.013, 0.015, 0.046),
        (0.011, 0.012, 0.011, 0.014, 0.048),
        (0.009, 0.013, 0.012, 0.016, 0.047))]
    s = bench_kernel_breakdown.summarize(passes)
    assert s["compiles"] == 4
    # stencil: sorted 0.009, 0.010, 0.011, 0.012 -> median 0.0105
    assert s["summary"]["stencil"] == {"median_s": 0.0105, "min_s": 0.009,
                                       "max_s": 0.012, "spread_pct": 28.6}
    # full_fused: 0.046, 0.047, 0.048, 0.050 -> median 0.0475
    assert s["summary"]["full_fused"] == {
        "median_s": 0.0475, "min_s": 0.046, "max_s": 0.05,
        "spread_pct": 8.4}
    assert s["median_structural_overhead_s"] == round(
        0.0475 - 0.0105 * (2 + 29 / 25), 6)
    assert s["median_src_cost_s"] == round(0.0115 - 0.0105, 6)
    odd = bench_kernel_breakdown.summarize(passes[:3])
    assert odd["summary"]["+ckpt"]["median_s"] == 0.014


# ---------------------------------------------------------------- the card

def test_harnesses_import_no_jax():
    """The harnesses import neither JAX nor the JAX package (a fresh
    process)."""
    code = ("import sys; import physicsbasedfwi2_tpu_torch.experiments."
            "bench, physicsbasedfwi2_tpu_torch.experiments.bench_configs, "
            "physicsbasedfwi2_tpu_torch.experiments.bench_elastic, "
            "physicsbasedfwi2_tpu_torch.experiments.bench_kernel_breakdown; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'physicsbasedfwi2_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", [bench, bench_configs, bench_elastic,
                                   bench_kernel_breakdown],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_main_without_a_card_raises(module, monkeypatch):
    """Where no card is visible, without ``--device cpu`` every harness
    refuses to run rather than time the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card is visible"):
        module.main([])
