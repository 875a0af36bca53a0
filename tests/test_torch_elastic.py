"""The elastic slice's ops and generator against the JAX package, on the
JAX package's own small fused-elastic case (36 x 48, nt 64, dx 15, PML
8, free surface, 2 shots x 10 receivers), inputs from numpy.

Kernel B3's plain version is held against ``jax.value_and_grad`` of the
pure-JAX replica ``elastic_fused_reference`` (the JAX package's own
oracle for the Pallas kernel) within the JAX package's own bounds, and
once against the Pallas kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.data.synthetic import (
    SyntheticElasticWorkload as JWorkload, make_elastic_model as j_mem,
)
from physicsbasedfwi2_tpu.geo import ricker as j_ricker
from physicsbasedfwi2_tpu.geo.acquisition import (
    elastic_line as j_elastic_line, seabed_rows as j_seabed_rows,
)
from physicsbasedfwi2_tpu.geo.filters import (
    lowpass_filter_time as j_lowpass,
)
from physicsbasedfwi2_tpu.models import (
    ElasticAutoEncoderNet as JElasticNet,
    apply_elastic_output as j_apply_elastic_output,
)
from physicsbasedfwi2_tpu.ops import simulate_elastic as j_simulate_elastic
from physicsbasedfwi2_tpu.ops.gradproc import (
    rescale_to_model as j_rescale, taper_top as j_taper,
)
from physicsbasedfwi2_tpu.ops.misfit import trace_normalize as j_tn
from physicsbasedfwi2_tpu.ops import pallas_elastic_fused as jef
from physicsbasedfwi2_tpu_torch.data.synthetic import (
    SyntheticElasticWorkload, make_elastic_model, make_marmousi_like,
)
from physicsbasedfwi2_tpu_torch.geo import (
    elastic_line, lowpass_filter_time, ricker, seabed_rows,
)
from physicsbasedfwi2_tpu_torch.models import (
    ElasticAutoEncoderNet, apply_elastic_output, define_generator,
)
from physicsbasedfwi2_tpu_torch.models.convert import (
    npz_from_state_dict, params_from_flax, state_dict_from_npz,
)
from physicsbasedfwi2_tpu_torch.ops import elastic_fused as ef
from physicsbasedfwi2_tpu_torch.ops import trace_normalize
from physicsbasedfwi2_tpu_torch.ops.elastic import simulate_elastic
from physicsbasedfwi2_tpu_torch.ops.gradproc import (
    rescale_to_model, taper_top,
)

from torch_parity import (
    elastic_case, jax_elastic, n, rel_max, t, torch_elastic,
)

torch.set_num_threads(1)
KC = 8


@pytest.fixture(scope="module")
def case():
    grid, cfg, wargs, med, geom = elastic_case()
    jcfg, tcfg = jax_elastic(grid, cfg), torch_elastic(grid, cfg)
    jgeom = tuple(jnp.asarray(a) for a in geom)
    tgeom = tuple(t(a) for a in geom)
    # observed data from the fused path's own operator (JAX replica)
    ovx, ovz = jef.simulate_elastic_ring(
        *(jnp.asarray(a) for a in med), j_ricker(*wargs), *jgeom, jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jwav=j_ricker(*wargs),
                twav=ricker(*wargs), med=med, jgeom=jgeom, tgeom=tgeom,
                obs=(np.asarray(ovx), np.asarray(ovz)))


def _trial(case, scale):
    vp, vs, rho = case["med"]
    return (vp * np.float32(scale)).astype(np.float32), vs, rho


def _obs_rows(case, misfit):
    obs = case["obs"]
    if misfit == "tnl1":
        obs = tuple(np.asarray(j_tn(jnp.asarray(o))) for o in obs)
    return obs, tuple(ef.scatter_rows_el(t(o), case["tgeom"][3],
                                         case["tcfg"], KC=KC) for o in obs)


# ---------------------------------------------------------------------------
# forward helpers
# ---------------------------------------------------------------------------

def test_prep_medium_damp_and_rows_match_jax(case):
    vp, vs, rho = _trial(case, 0.95)
    jm = jef.prep_medium(jnp.asarray(vp), jnp.asarray(vs), jnp.asarray(rho),
                         case["jcfg"])
    tm = ef.prep_medium(t(vp), t(vs), t(rho), case["tcfg"])
    for a, b in zip(jm, tm):
        # the same float32 operations: equal to the last bit or so
        assert rel_max(b, a) <= 1e-6
    assert torch.equal(ef.prep_damp(case["tcfg"]),
                       t(jef.prep_damp(case["jcfg"])))
    ovx = case["obs"][0]
    np.testing.assert_array_equal(
        n(ef.scatter_rows_el(t(ovx), case["tgeom"][3], case["tcfg"], KC=KC)),
        np.asarray(jef.scatter_rows_el(jnp.asarray(ovx), case["jgeom"][3],
                                       case["jcfg"], KC=KC)))


def test_simulate_elastic_ring_matches_jax(case):
    med = [t(a) for a in case["med"]]
    tvx, tvz = ef.simulate_elastic_ring(*med, case["twav"], *case["tgeom"],
                                        case["tcfg"])
    # float32 rounding in another order over 64 steps: 1e-5 of max
    assert rel_max(tvx, case["obs"][0]) <= 1e-5
    assert rel_max(tvz, case["obs"][1]) <= 1e-5


def test_simulate_elastic_matches_jax(case):
    jmed = [jnp.asarray(a) for a in case["med"]]
    jvx, jvz = j_simulate_elastic(*jmed, case["jwav"], *case["jgeom"],
                                  case["jcfg"])
    tvx, tvz = simulate_elastic(*(t(a) for a in case["med"]), case["twav"],
                                *case["tgeom"], case["tcfg"])
    assert rel_max(tvx, jvx) <= 1e-5
    assert rel_max(tvz, jvz) <= 1e-5


@pytest.mark.parametrize("fc", [0.0, 15.0, 40.0])
def test_lowpass_filter_matches_jax(case, fc):
    ovx = case["obs"][0]
    got = lowpass_filter_time(t(ovx), fc, 0.0015, axis=1)
    ref = j_lowpass(jnp.asarray(ovx), fc, 0.0015, axis=1)
    # float32 FFTs (pocketfft vs XLA's): 1e-5 of max
    assert rel_max(got, ref) <= 1e-5
    wav = lowpass_filter_time(case["twav"], fc, 0.0015)
    assert rel_max(wav, j_lowpass(case["jwav"], fc, 0.0015)) <= 1e-5


@pytest.mark.parametrize("rows,smooth", [(5, 0), (5, 4), (0, 0)])
def test_taper_and_rescale_match_jax(rows, smooth):
    rng = np.random.default_rng(3)
    g = rng.standard_normal((20, 12)).astype(np.float32)
    m = (2000.0 + 100.0 * rng.standard_normal((20, 12))).astype(np.float32)
    got = taper_top(t(g), rows, smooth=smooth)
    ref = j_taper(jnp.asarray(g), rows, smooth=smooth)
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(n(rescale_to_model(got, t(m))),
                               np.asarray(j_rescale(ref, jnp.asarray(m))),
                               rtol=1e-6)


def test_geometry_and_models_equal_exactly():
    vp = make_marmousi_like(40, 64, seed=2, water_rows=6)
    for a, b in zip(make_elastic_model(vp, water_rows=6),
                    j_mem(vp, water_rows=6)):
        np.testing.assert_array_equal(a, b)
    vs = make_elastic_model(vp, water_rows=6)[0]
    np.testing.assert_array_equal(seabed_rows(vs), j_seabed_rows(vs))
    for kw in (dict(src_row=7, rcv_row=7),
               dict(src_row=3, rcv_rows_per_col=j_seabed_rows(vp))):
        a = elastic_line(6, 20, 64, 40, **kw)
        b = j_elastic_line(6, 20, 64, 40, **kw)
        for f in ("src_z", "src_x", "rcv_z", "rcv_x"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_synthetic_elastic_workload_matches_jax():
    kw = dict(nz=30, nx=40, dx=15.0, nt=80, dt=0.0015, pml_width=8,
              freq=20.0, num_shots=3, num_receivers=12, seed=1,
              water_rows=4, chunk=16)
    jwl = JWorkload.build(**kw)
    wl = SyntheticElasticWorkload.build(**kw, device="cpu")
    assert wl.cfg.grid == wl.grid and wl.grid.free_surface
    for k in ("vp", "vs", "rho"):
        np.testing.assert_array_equal(n(wl.true[k]), np.asarray(jwl.true[k]))
        np.testing.assert_array_equal(n(wl.start[k]),
                                      np.asarray(jwl.start[k]))
    for f in ("src_z", "src_x", "rcv_z", "rcv_x"):
        np.testing.assert_array_equal(getattr(wl.acq, f),
                                      getattr(jwl.acq, f))
    assert rel_max(wl.wavelet, jwl.wavelet) <= 1e-6
    # the split-PML simulation: float32 rounding over 80 steps
    assert rel_max(wl.obs_vx, jwl.obs_vx) <= 1e-5
    assert rel_max(wl.obs_vz, jwl.obs_vz) <= 1e-5


# ---------------------------------------------------------------------------
# kernel B3's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("misfit", ["l2", "tnl1"])
def test_b3_plain_matches_jax_reference(case, misfit):
    """The JAX package's bounds (tests/test_elastic.py): loss 1e-6
    relative, each medium gradient 1e-5 of its max.  The trial model is
    0.9 vp (the JAX test's 0.95 leaves a raw-L2 residual so small that
    the replica's own float32 rounding moves its loss 2e-6 from a
    float64 run of the same problem; the port's plain version is 2e-7
    from it)."""
    vp, vs, rho = _trial(case, 0.9)
    jcfg, tcfg = case["jcfg"], case["tcfg"]
    jmeds = jef.prep_medium(jnp.asarray(vp), jnp.asarray(vs),
                            jnp.asarray(rho), jcfg)
    damp = jef.prep_damp(jcfg)
    obs, (orx, orz) = _obs_rows(case, misfit)
    ref_loss, ref_g = jax.value_and_grad(
        lambda m: jef.elastic_fused_reference(
            m, damp, case["jwav"], *case["jgeom"], jcfg,
            jnp.asarray(obs[0]), jnp.asarray(obs[1]), misfit=misfit))(jmeds)
    loss, gm = ef.fused_elastic_loss_grad_meds(
        ef.prep_medium(t(vp), t(vs), t(rho), tcfg), ef.prep_damp(tcfg),
        case["twav"], *case["tgeom"], tcfg, orx, orz, KC=KC, misfit=misfit)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    for a, b in zip(ref_g, gm):
        assert rel_max(b, a) <= 1e-5


def test_b3_plain_matches_jax_reference_absorbing_top():
    """The same bounds with an absorbing top (no free-surface row; the
    sponge on all four sides), on the raw-L2 misfit."""
    grid, cfg, wargs, med, geom = elastic_case(free_surface=False)
    jcfg, tcfg = jax_elastic(grid, cfg), torch_elastic(grid, cfg)
    jgeom = tuple(jnp.asarray(a) for a in geom)
    jwav = j_ricker(*wargs)
    ovx, ovz = jef.simulate_elastic_ring(
        *(jnp.asarray(a) for a in med), jwav, *jgeom, jcfg)
    vp, vs, rho = (med[0] * np.float32(0.9)).astype(np.float32), *med[1:]
    jmeds = jef.prep_medium(jnp.asarray(vp), jnp.asarray(vs),
                            jnp.asarray(rho), jcfg)
    ref_loss, ref_g = jax.value_and_grad(
        lambda m: jef.elastic_fused_reference(
            m, jef.prep_damp(jcfg), jwav, *jgeom, jcfg, ovx, ovz))(jmeds)
    rows = [ef.scatter_rows_el(t(o), t(geom[3]), tcfg, KC=KC)
            for o in (ovx, ovz)]
    meds = ef.prep_medium(t(vp), t(vs), t(rho), tcfg)
    assert meds[0].shape == (56, 128)
    loss, gm = ef.fused_elastic_loss_grad_meds(
        meds, ef.prep_damp(tcfg), ricker(*wargs), *(t(a) for a in geom),
        tcfg, *rows, KC=KC)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    for a, b in zip(ref_g, gm):
        assert rel_max(b, a) <= 1e-5


def test_b3_plain_matches_pallas_interpret(case):
    """One interpret-mode call of the Pallas kernel pins the row layout,
    the KC padding (nt 64 -> 64 at KC 8, 72 at KC 24) and the loss
    scaling."""
    vp, vs, rho = _trial(case, 0.95)
    jcfg, tcfg = case["jcfg"], case["tcfg"]
    jmeds = jef.prep_medium(jnp.asarray(vp), jnp.asarray(vs),
                            jnp.asarray(rho), jcfg)
    obs, _ = _obs_rows(case, "tnl1")
    kc = 24
    jrows = [jef.scatter_rows_el(jnp.asarray(o), case["jgeom"][3], jcfg,
                                 KC=kc) for o in obs]
    jl, jg = jef.fused_elastic_loss_grad_meds(
        jmeds, jef.prep_damp(jcfg), case["jwav"], *case["jgeom"], jcfg,
        *jrows, KC=kc, misfit="tnl1", interpret=True)
    trows = [ef.scatter_rows_el(t(o), case["tgeom"][3], tcfg, KC=kc)
             for o in obs]
    assert trows[0].shape == jrows[0].shape == (2, 72, 128)
    loss, gm = ef.fused_elastic_loss_grad_meds(
        ef.prep_medium(t(vp), t(vs), t(rho), tcfg), ef.prep_damp(tcfg),
        case["twav"], *case["tgeom"], tcfg, *trows, KC=kc, misfit="tnl1")
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    for a, b in zip(jg, gm):
        assert rel_max(b, a) <= 1e-5


def test_chain_rule_matches_jax_vjp(case):
    """fused_elastic_loss_grad's physical gradients: the kernel's medium
    gradients pulled back through prep_medium by torch.autograd, against
    jax.vjp of prep_medium applied to the same medium gradients."""
    vp, vs, rho = _trial(case, 0.95)
    tcfg = case["tcfg"]
    _, (orx, orz) = _obs_rows(case, "l2")
    loss, grads = ef.fused_elastic_loss_grad(
        t(vp), t(vs), t(rho), case["twav"], *case["tgeom"], tcfg, orx, orz,
        KC=KC, wrt=("vp", "vs", "rho"))
    _, gmeds = ef.fused_elastic_loss_grad_meds(
        ef.prep_medium(t(vp), t(vs), t(rho), tcfg), ef.prep_damp(tcfg),
        case["twav"], *case["tgeom"], tcfg, orx, orz, KC=KC)
    _, vjp = jax.vjp(lambda a, b, c: jef.prep_medium(a, b, c, case["jcfg"]),
                     jnp.asarray(vp), jnp.asarray(vs), jnp.asarray(rho))
    ref = vjp(tuple(jnp.asarray(n(g)) for g in gmeds))
    assert float(loss) > 0
    for name, r in zip(("vp", "vs", "rho"), ref):
        assert rel_max(grads[name], r) <= 1e-5, name
    # the fluid top rows (vs = 0) get no vs gradient through mu_xz's
    # double where, and nothing is NaN
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


@pytest.mark.parametrize("misfit,tol", [("l2", 1e-14), ("tnl1", 1e-9)])
def test_loss_at_true_model(case, misfit, tol):
    tcfg = case["tcfg"]
    med = [t(a) for a in case["med"]]
    ovx, ovz = ef.simulate_elastic_ring(*med, case["twav"], *case["tgeom"],
                                        tcfg)
    if misfit == "tnl1":
        ovx, ovz = trace_normalize(ovx), trace_normalize(ovz)
    rows = [ef.scatter_rows_el(o, case["tgeom"][3], tcfg, KC=KC)
            for o in (ovx, ovz)]
    loss, _ = ef.fused_elastic_loss_grad(*med, case["twav"], *case["tgeom"],
                                         tcfg, *rows, KC=KC, misfit=misfit)
    assert float(loss) < tol


def test_float64_plain_and_wrapper_errors(case):
    vp, vs, rho = _trial(case, 0.9)
    tcfg = case["tcfg"]
    _, rows = _obs_rows(case, "l2")
    meds = ef.prep_medium(t(vp), t(vs), t(rho), tcfg)
    damp = ef.prep_damp(tcfg)
    args = (case["twav"], *case["tgeom"], tcfg, *rows)
    l32, g32 = ef.fused_elastic_loss_grad_meds(meds, damp, *args, KC=KC)
    l64, g64 = ef.fused_elastic_loss_grad_meds_plain(
        meds, damp, *args, KC=KC, dtype=torch.float64)
    assert g64[0].dtype == torch.float64
    np.testing.assert_allclose(float(l32), float(l64), rtol=1e-5)
    for a, b in zip(g32, g64):
        assert rel_max(a.double(), b) <= 1e-4
    with pytest.raises(ValueError, match="misfit"):
        ef.fused_elastic_loss_grad_meds(meds, damp, *args, KC=KC,
                                        misfit="tnl2")
    # a device with no kernel raises; it never falls back
    with pytest.raises(ValueError, match="no kernel"):
        ef.fused_elastic_loss_grad_meds(
            meds, damp.to("meta"), *args, KC=KC)
    with pytest.raises(ValueError, match="no kernel"):
        ef.simulate_elastic_ring(*(t(a).to("meta") for a in case["med"]),
                                 *args[:5], tcfg)


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

EL_FILTERS = (4, 8, 16)
EL_OUT = (20, 24)
EL_IN = (1, 64, 16, 3)   # [B, nt, nr, ns]


@pytest.fixture(scope="module")
def el_nets():
    rng = np.random.default_rng(1)
    xv, xz = (rng.standard_normal(EL_IN).astype(np.float32)
              for _ in range(2))
    jnet = JElasticNet(out_shape=EL_OUT, filters=EL_FILTERS, head="linear")
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.asarray(xv), jnp.asarray(xz)))
    net = ElasticAutoEncoderNet(out_shape=EL_OUT, in_shape=EL_IN[1:],
                                filters=EL_FILTERS, head="linear")
    net.load_state_dict(params_from_flax(params))
    return jnet, params, net, xv, xz


def test_elastic_net_matches_flax(el_nets):
    jnet, params, net, xv, xz = el_nets
    jf, jz = jax.jit(jnet.apply)(params, jnp.asarray(xv), jnp.asarray(xz))
    with torch.no_grad():
        f, z = net(t(xv), t(xz))
    assert f.shape == jf.shape == (1, *EL_OUT, 2)
    assert z.shape == jz.shape
    for got, ref in ((f, jf), (z, jz)):
        np.testing.assert_allclose(
            n(got), np.asarray(ref), rtol=1e-5,
            atol=1e-5 * float(jnp.abs(ref).max()))


def test_elastic_npz_checkpoint_round_trip(el_nets):
    _, params, net, _, _ = el_nets
    arrays = npz_from_state_dict(net.state_dict(), net)
    assert "['params']['decoder_field1']['Conv_0']['kernel']" in arrays
    assert "['params']['combine_vz']['kernel']" in arrays
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    keys = {jax.tree_util.keystr(k) for k in flat}
    assert set(arrays) == keys
    sd = state_dict_from_npz(arrays)
    for k, v in net.state_dict().items():
        assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("clip_mode", ["hard", "ste"])
def test_apply_elastic_output_matches_jax(clip_mode):
    rng = np.random.default_rng(5)
    deltas = (3.0 * rng.standard_normal((1, 10, 8, 2))).astype(np.float32)
    lowf = np.stack([np.full((10, 8), 2000.0), np.full((10, 8), 900.0)],
                    -1)[None].astype(np.float32)
    true = (lowf + 50.0).astype(np.float32)
    kw = dict(delta_scale=(100.0, 100.0), clip_min=(1500.0, 700.0),
              clip_max=(2150.0, 1100.0), pin_rows=2, clip_mode=clip_mode)
    w = rng.standard_normal((1, 10, 8, 2)).astype(np.float32)

    def jf(d):
        return jnp.sum(j_apply_elastic_output(d, jnp.asarray(lowf),
                                              jnp.asarray(true), **kw)
                       * jnp.asarray(w))

    jm = j_apply_elastic_output(jnp.asarray(deltas), jnp.asarray(lowf),
                                jnp.asarray(true), **kw)
    jg = jax.grad(jf)(jnp.asarray(deltas))
    d = t(deltas).requires_grad_()
    m = apply_elastic_output(d, t(lowf), t(true), **kw)
    (m * t(w)).sum().backward()
    np.testing.assert_allclose(n(m), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(n(d.grad), np.asarray(jg), rtol=1e-6)
    # some cells are clipped: the two modes differ there
    assert float(np.abs(np.asarray(jm) - (lowf + 100.0 * deltas)).max()) > 0


def test_elastic_registry():
    kw = dict(out_shape=(20, 24), in_shape=(64, 16, 3), filters=EL_FILTERS)
    for name, nf in (("AutoElMar22", 2), ("AutoEl22", 2),
                     ("AutoElFullMar22", 2), ("AutoSEAMMar22", 2),
                     ("AutoRealData", 2), ("AutoElFullRhoMar22", 3),
                     ("AutoElMarZp22", 3)):
        net = define_generator(name, head="linear", **kw)
        assert isinstance(net, ElasticAutoEncoderNet) and net.n_fields == nf
        f, _ = net(torch.zeros(1, 64, 16, 3) + 0.1,
                   torch.zeros(1, 64, 16, 3) - 0.1)
        assert f.shape == (1, 20, 24, nf)
    # MC dropout: the decoders' blocks drop at 0.1, the encoder's do not
    net = define_generator("AutoElMarMCDIP22", head="linear", **kw)
    assert isinstance(net, ElasticAutoEncoderNet) and net.n_fields == 2
    rates = {name.split(".")[0]: m.dropout for name, m in net.named_modules()
             if type(m).__name__ == "ConvBlock"}
    assert rates == {"encoder": 0.0, "decoder_field0": 0.1,
                     "decoder_field1": 0.1}
