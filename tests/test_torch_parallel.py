"""``parallel/`` on ``torch.distributed``: gloo ranks on the CPU, each a
process of its own (``dryrun.spawn``, a ``file://`` store under the
test's directory), run ``tests/parallel_ranks.py`` on npz inputs made here;
the same inputs go through the JAX package's sharded functions on as
many of the 8 virtual CPU devices.  Every rank must return the same
bits, and the ranks' result must match JAX's at the stated tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.geo import Grid2D as JGrid, ricker as j_ricker
from physicsbasedfwi2_tpu.geo import surface_line
from physicsbasedfwi2_tpu.ops import AcousticConfig as JAcoustic
from physicsbasedfwi2_tpu.ops import ElasticConfig as JElastic
from physicsbasedfwi2_tpu.ops import simulate_acoustic as j_simulate
from physicsbasedfwi2_tpu.ops import simulate_elastic as j_simulate_el
from physicsbasedfwi2_tpu.ops import trace_normalize as j_trace_normalize
from physicsbasedfwi2_tpu import parallel as jpar
from physicsbasedfwi2_tpu_torch import parallel as tpar
from parallel_ranks import run_check
from physicsbasedfwi2_tpu_torch.parallel.dryrun import spawn

from torch_parity import n, rel_l2, rel_max, t, torch_acoustic

torch.set_num_threads(1)


def run_ranks(tmp_path, name: str, world: int, **inputs) -> dict:
    """The check ``name`` on ``world`` gloo ranks; rank 0's outputs, after
    holding every other rank's to the same bits."""
    d = tmp_path / name
    d.mkdir()
    np.savez(d / "in.npz", **inputs)
    spawn(run_check, world, name, str(d / "in.npz"), str(d), "cpu",
          device="cpu", store_dir=str(d))
    outs = [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]
    for r, o in enumerate(outs[1:], 1):
        for k, v in o.items():
            np.testing.assert_array_equal(v, outs[0][k], err_msg=f"rank {r} "
                                          f"{k}")
    return outs[0]


def _lit(d: dict) -> np.ndarray:
    return np.array(repr(d))


GRID = dict(nz=40, nx=50, dx=10.0, nt=200, dt=0.002, pml_width=16)
CFG = dict(chunk=25, vmax_pml=2500.0)


def _acoustic_case(ns, grid=GRID, cfg=CFG, nr=20, f=10.0):
    """tests/test_sharding.py's acoustic case: numpy inputs and JAX's
    config."""
    jcfg = JAcoustic(grid=JGrid(**grid), **cfg)
    wav = np.asarray(j_ricker(f, grid["nt"], grid["dt"]))
    acq = surface_line(ns, nr, grid["nx"], src_depth=2, rcv_depth=2)
    geom = tuple(np.asarray(a) for a in
                 (acq.src_z, acq.src_x, acq.rcv_z, acq.rcv_x))
    vp0 = np.full((grid["nz"], grid["nx"]), 1800.0, np.float32)
    vpt = vp0.copy()
    vpt[grid["nz"] // 2:grid["nz"] // 2 + 10, 15:35] = 2100.0
    return jcfg, wav, geom, vp0, vpt


def _geom_kw(geom):
    return dict(zip(("src_z", "src_x", "rcv_z", "rcv_x"), geom))


def test_pad_shots_to_multiple_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 3, 2)).astype(np.float32)
    b = rng.integers(0, 9, (5, 4)).astype(np.int32)
    (ja, jb), jm = jpar.pad_shots_to_multiple([jnp.asarray(a),
                                              jnp.asarray(b)], 4)
    (pa, pb), pm = tpar.pad_shots_to_multiple([t(a), t(b)], 4)
    for got, ref in ((pa, ja), (pb, jb), (pm, jm)):
        assert got.dtype == torch.from_numpy(np.array(ref)).dtype
        np.testing.assert_array_equal(n(got), np.asarray(ref))
    (pa,), pm = tpar.pad_shots_to_multiple([t(a)], 5, pad_value=-1.0)
    assert pa.shape == (5, 3, 2) and float(pm.sum()) == 5


def test_pad_shots_for_fused_matches_jax():
    rng = np.random.default_rng(1)
    ns, nt, nx = 6, 32, 24
    wav = rng.standard_normal(nt).astype(np.float32)
    geom = (rng.integers(0, 9, ns).astype(np.int32),
            rng.integers(0, 9, ns).astype(np.int32),
            rng.integers(0, 9, (ns, 5)).astype(np.int32),
            rng.integers(0, 9, (ns, 5)).astype(np.int32))
    rows = [rng.standard_normal((ns, nt, nx)).astype(np.float32)
            for _ in range(2)]
    jout, jns, jpad = jpar.pad_shots_for_fused(
        jnp.asarray(wav), *map(jnp.asarray, geom), *map(jnp.asarray, rows), 4)
    pout, pns, ppad = tpar.pad_shots_for_fused(t(wav), *map(t, geom),
                                              *map(t, rows), 4)
    assert (pns, ppad) == (jns, jpad) == (6, 8)
    for got, ref in zip(pout, jout):
        np.testing.assert_array_equal(n(got), np.asarray(ref))


def test_shot_sharded_acoustic_gradient_world3_with_mask(tmp_path):
    """4 shots padded to 6 over 3 ranks: 2 pad shots on the last rank,
    weighted 0 by the mask."""
    jcfg, wav, geom, vp0, vpt = _acoustic_case(4)
    obs_norm = np.asarray(j_trace_normalize(j_simulate(
        jnp.asarray(vpt), wav, *map(jnp.asarray, geom), jcfg)))
    (sz, sx, rz, rx, obs_p), mask = jpar.pad_shots_to_multiple(
        [*map(jnp.asarray, geom), jnp.asarray(obs_norm)], 3)
    jl, jg = jpar.shot_sharded_acoustic_gradient(
        jpar.make_mesh(3), jnp.asarray(vp0), obs_p, wav, sz, sx, rz, rx,
        jcfg, misfit="l2", shot_mask=mask)
    out = run_ranks(tmp_path, "acoustic", 3, grid=_lit(GRID), cfg=_lit(CFG),
                    vp=vp0, wav=wav, obs_norm=np.asarray(obs_p),
                    mask=np.asarray(mask), misfit=np.array("l2"),
                    **_geom_kw(tuple(map(np.asarray, (sz, sx, rz, rx)))))
    # float32 sums in another order: loss 1e-5, gradient 1e-4 rel L2
    np.testing.assert_allclose(float(out["loss"]), float(jl), rtol=1e-5)
    assert rel_l2(out["grad"], jg) <= 1e-4


def test_sample_shot_sharded_gradient_2x2(tmp_path):
    """2 samples x 4 shots on a {sample, shot} mesh of 2 x 2, with a
    direct wave: the loss over the whole mesh, each sample's gradient
    over its shots, gathered over the samples."""
    jcfg, wav, geom, vp0, vpt = _acoustic_case(4)
    jg_ = tuple(map(jnp.asarray, geom))
    vps_t = np.stack([vpt, np.roll(vpt, 6, axis=1)])
    obs = np.stack([np.asarray(j_simulate(jnp.asarray(v), wav, *jg_, jcfg))
                    for v in vps_t])
    direct = 0.5 * np.asarray(j_simulate(jnp.asarray(vp0), wav, *jg_, jcfg))
    obs_norm = np.asarray(j_trace_normalize(jnp.asarray(obs - direct[None]),
                                            time_axis=2))
    vps0 = np.stack([vp0, vp0 + 50.0])
    jl, jg = jpar.sample_shot_sharded_acoustic_gradient(
        jpar.make_mesh2d(2, 2), jnp.asarray(vps0), jnp.asarray(obs_norm),
        wav, *jg_, jcfg, misfit="l2", direct=jnp.asarray(direct))
    out = run_ranks(tmp_path, "sample_shot", 4, grid=_lit(GRID),
                    cfg=_lit(CFG), mesh=_lit((2, 2)), vps=vps0, wav=wav,
                    obs_norm=obs_norm, direct=direct, misfit=np.array("l2"),
                    **_geom_kw(geom))
    assert out["grad"].shape == vps0.shape
    np.testing.assert_allclose(float(out["loss"]), float(jl), rtol=1e-5)
    for s in range(2):
        assert rel_l2(out["grad"][s], np.asarray(jg)[s]) <= 1e-4, s


def test_shot_sharded_elastic_gradient_world2(tmp_path):
    """4 shots over 2 ranks through the split-PML propagator, a reflector
    12 rows down as the true model.  The raw L2 residual is the
    difference of two gathers that agree to ~1e-3, so the ~1.5e-6 by
    which the packages' propagators differ grows to ~2.5e-4 in it: the
    port holds JAX's sharded pair to 1e-3 (loss, gradients rel L2), and
    its own one-process gradient (sum order only) to 1e-5."""
    from physicsbasedfwi2_tpu_torch.ops import elastic_gradient
    from torch_parity import torch_elastic
    grid = dict(nz=36, nx=48, dx=10.0, nt=120, dt=0.0015, pml_width=14)
    cfg = dict(chunk=20, vmax_pml=2800.0)
    jcfg = JElastic(grid=JGrid(**grid), **cfg)
    wav = np.asarray(j_ricker(12.0, grid["nt"], grid["dt"]))
    acq = surface_line(4, 16, 48, src_depth=2, rcv_depth=2)
    geom = tuple(np.asarray(a) for a in
                 (acq.src_z, acq.src_x, acq.rcv_z, acq.rcv_x))
    vp = np.full((36, 48), 2000.0, np.float32)
    vs = np.full((36, 48), 1100.0, np.float32)
    rho = np.full((36, 48), 2000.0, np.float32)
    vpt = vp.copy()
    vpt[12:] = 2400.0
    ovx, ovz = (np.asarray(a) for a in j_simulate_el(
        jnp.asarray(vpt), jnp.asarray(vs), jnp.asarray(rho), wav,
        *map(jnp.asarray, geom), jcfg))
    jl, jgs = jpar.shot_sharded_elastic_gradient(
        jpar.make_mesh(2), jnp.asarray(vp), jnp.asarray(vs), jnp.asarray(rho),
        jnp.asarray(ovx), jnp.asarray(ovz), wav, *map(jnp.asarray, geom),
        jcfg, wrt=("vp", "vs"))
    out = run_ranks(tmp_path, "elastic", 2, grid=_lit(grid), cfg=_lit(cfg),
                    vp=vp, vs=vs, rho=rho, obs_vx=ovx, obs_vz=ovz, wav=wav,
                    **_geom_kw(geom))
    tl, tgs = elastic_gradient(
        t(vp), t(vs), t(rho), lambda p: (torch.mean((p[0] - t(ovx)) ** 2)
                                         + torch.mean((p[1] - t(ovz)) ** 2))
        / 2, t(wav), *map(t, geom), torch_elastic(grid, cfg), wrt=("vp", "vs"))
    np.testing.assert_allclose(float(out["loss"]), float(jl), rtol=1e-3)
    np.testing.assert_allclose(float(out["loss"]), float(tl), rtol=1e-5)
    for k in ("vp", "vs"):
        assert rel_l2(out[f"grad_{k}"], jgs[k]) <= 1e-3, k
        assert rel_l2(out[f"grad_{k}"], tgs[k]) <= 1e-5, k


def test_shot_sharded_fused_gradient_world4_matches_interpret(tmp_path):
    """Kernel B2's plain version per rank (6 shots padded to 8 over 4
    ranks, the ns_pad / ns_real correction) against the JAX kernel in
    interpret mode under shard_map on 4 devices.  The observed rows are
    offset by 3 inside the receiver columns so that every residual
    keeps its sign (as tests/test_torch_fwi_fused.py does): where
    prediction and data are rounding-level, the L1 signs follow each
    runtime's rounding."""
    from physicsbasedfwi2_tpu.ops.pallas_fwi_fused import (
        fwi_l1_loss_grad as j_fused, scatter_rows as j_scatter_rows)
    grid = dict(nz=32, nx=48, dx=10.0, nt=96, dt=0.001, pml_width=8)
    cfg = dict(chunk=16, vmax_pml=3000.0)
    jcfg, wav, geom, vp0, vpt = _acoustic_case(6, grid, cfg, nr=16, f=12.0)
    KC = 16
    jg_ = tuple(map(jnp.asarray, geom))
    obs_norm = j_trace_normalize(j_simulate(jnp.asarray(vpt), wav, *jg_,
                                            jcfg))
    obs_rows = np.array(j_scatter_rows(obs_norm, jg_[3], nt=96, nx=48,
                                       pml_width=8, KC=KC))
    obs_rows[:, :, geom[3][0] + 8] += 3.0
    dir_rows = np.zeros_like(obs_rows)
    (wavp, *gp, obs_p, dir_p), ns, ns_pad = jpar.pad_shots_for_fused(
        jnp.asarray(wav), *jg_, jnp.asarray(obs_rows), jnp.asarray(dir_rows),
        4)
    jl, jg = jpar.shot_sharded_fused_acoustic_gradient(
        jpar.make_mesh(4), jnp.asarray(vp0), wavp, *gp, jcfg, obs_p, dir_p,
        KC=KC, interpret=True)
    jl_1, jg_1 = j_fused(jnp.asarray(vp0), jnp.asarray(wav), *jg_, jcfg,
                         jnp.asarray(obs_rows), jnp.asarray(dir_rows), KC=KC,
                         interpret=True)
    out = run_ranks(tmp_path, "fused", 4, grid=_lit(grid), cfg=_lit(cfg),
                    vp=vp0, wav=np.asarray(wavp), obs_rows=np.asarray(obs_p),
                    dir_rows=np.asarray(dir_p), KC=np.array(KC),
                    **_geom_kw(tuple(map(np.asarray, gp))))
    s = ns_pad / ns
    # float32 sums in another order, as the B2 tests: loss 1e-5,
    # gradient 1e-4 rel L2; the sharded pair equals the unsharded one
    np.testing.assert_allclose(float(out["loss"]), float(jl), rtol=1e-5)
    assert rel_l2(out["grad"], jg) <= 1e-4
    np.testing.assert_allclose(float(out["loss"]) * s, float(jl_1),
                               rtol=1e-5)
    assert rel_l2(out["grad"] * s, jg_1) <= 1e-4


HALO_GRID = dict(nz=32, nx=88, dx=10.0, nt=160, dt=0.002, pml_width=16)
HALO_CFG = dict(chunk=20, vmax_pml=2500.0)


def _halo_case():
    """tests/test_sharding.py's halo case (2 shots, one receiver row)."""
    wav = np.asarray(j_ricker(10.0, 160, 0.002))
    geom = (np.array([4, 4], np.int32), np.array([20, 60], np.int32),
            np.full((2, 10), 3, np.int32),
            np.tile(np.arange(10, dtype=np.int32) * 8 + 4, (2, 1)))
    vp = np.full((32, 88), 1800.0, np.float32)
    vp[16:] = 2200.0
    return wav, geom, vp


def test_simulate_acoustic_dd_world4(tmp_path):
    """The padded width 120 in 4 slabs of 30 columns, a 2-column halo
    exchange before each x derivative: against JAX's on 4 devices and
    the port's one-process propagator, to JAX's 1e-4 of max."""
    from physicsbasedfwi2_tpu.parallel.halo import (
        simulate_acoustic_dd as j_dd)
    from physicsbasedfwi2_tpu_torch.ops import simulate_acoustic
    wav, geom, vp = _halo_case()
    jcfg = JAcoustic(grid=JGrid(**HALO_GRID), **HALO_CFG)
    jrec = np.asarray(j_dd(jnp.asarray(vp), wav, *map(jnp.asarray, geom),
                           jcfg, jpar.make_mesh(4)))
    out = run_ranks(tmp_path, "halo", 4, grid=_lit(HALO_GRID),
                    cfg=_lit(HALO_CFG), vp=vp, wav=wav, **_geom_kw(geom))
    with torch.no_grad():
        ref = simulate_acoustic(t(vp), t(wav), *map(t, geom),
                                torch_acoustic(HALO_GRID, HALO_CFG))
    assert out["rec"].shape == jrec.shape == (2, 160, 10)
    assert rel_max(out["rec"], jrec) < 1e-4
    assert rel_max(out["rec"], ref) < 1e-4


def test_simulate_acoustic_dd_rejects_varying_receiver_depth():
    wav, geom, vp = _halo_case()
    rz = geom[2].copy()
    rz[1, 3] = 5
    with pytest.raises(ValueError, match="single receiver-depth row"):
        tpar.simulate_acoustic_dd(t(vp), t(wav), t(geom[0]), t(geom[1]),
                                  t(rz), t(geom[3]),
                                  torch_acoustic(HALO_GRID, HALO_CFG), None)


def test_loss_surface_2d_sharded_world3(tmp_path):
    """A 3 x 4 surface (12 points, 4 a rank) of the trace-normalized L2
    misfit of a velocity model along two injected directions, against
    JAX's sharded sweep on 3 devices."""
    from physicsbasedfwi2_tpu.landscape import (
        loss_surface_2d_sharded as j_surface)
    grid = dict(GRID, nt=120)
    jcfg, wav, geom, vp0, vpt = _acoustic_case(2, grid)
    jg_ = tuple(map(jnp.asarray, geom))
    obs_norm = np.asarray(j_trace_normalize(j_simulate(jnp.asarray(vpt), wav,
                                                       *jg_, jcfg)))
    rng = np.random.default_rng(3)
    d1, d2 = (100.0 * rng.standard_normal(vp0.shape).astype(np.float32)
              for _ in range(2))
    xs, ys = np.linspace(-1, 1, 4), np.linspace(-0.5, 0.5, 3)

    def jloss(p, data):
        pred = j_trace_normalize(j_simulate(p["vp"], wav, *jg_, jcfg))
        return jnp.mean((pred - data) ** 2)

    jsurf, _, _ = j_surface(jloss, {"vp": jnp.asarray(vp0)}, jpar.make_mesh(3),
                            d1={"vp": jnp.asarray(d1)},
                            d2={"vp": jnp.asarray(d2)}, xs=xs, ys=ys,
                            data=jnp.asarray(obs_norm))
    out = run_ranks(tmp_path, "surface", 3, grid=_lit(grid), cfg=_lit(CFG),
                    vp=vp0, wav=wav, obs_norm=obs_norm, d1=d1, d2=d2, xs=xs,
                    ys=ys, **_geom_kw(geom))
    assert out["losses"].shape == np.asarray(jsurf).shape == (3, 4)
    np.testing.assert_allclose(out["losses"], np.asarray(jsurf), rtol=1e-5)
