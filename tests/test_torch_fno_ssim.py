"""The FNO modules (models/fno.py) and SSIM (ops/ssim.py) against the JAX
package: SpectralConv1d, SpectralConv2d (also with fewer than 2 * modes1
rows, where the last rows' block overwrites the first's) and FNO2d
(width 8, depth 2, modes 4) with the Flax weights carried across,
forward and the input and weight VJPs; the converter both ways for FNO2d;
``lp_loss`` relative and absolute; ``ssim`` at windows 5 and 11, reduced
and as a map, its gradient, and against a constant target."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.models import fno as jfno
from physicsbasedfwi2_tpu.ops.ssim import ssim as j_ssim
from physicsbasedfwi2_tpu_torch.models import (
    FNO2d, SpectralConv1d, SpectralConv2d, lp_loss,
)
from physicsbasedfwi2_tpu_torch.models.convert import (
    npz_from_state_dict, params_from_flax, params_to_flax,
    state_dict_from_npz,
)
from physicsbasedfwi2_tpu_torch.ops import ssim

from torch_parity import n, t

torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(a):
    """NHWC (or NLC) tensor -> NCHW (NCL)."""
    return a.permute(0, a.ndim - 1, *range(1, a.ndim - 1))


def _nhwc(a):
    return a.permute(0, *range(2, a.ndim), 1)


# case -> (Flax module, port module from the input channels, input shape
# in the Flax layout, whether the port takes NHWC)
CASES = {
    "spectral1d": (jfno.SpectralConv1d(features=4, modes=5),
                   lambda c: SpectralConv1d(c, 4, 5), (2, 20, 3), False),
    "spectral2d": (jfno.SpectralConv2d(features=4, modes1=4, modes2=3),
                   lambda c: SpectralConv2d(c, 4, 4, 3), (2, 12, 10, 3),
                   False),
    "spectral2d-overlap": (jfno.SpectralConv2d(features=2, modes1=4,
                                               modes2=3),
                           lambda c: SpectralConv2d(c, 2, 4, 3),
                           (1, 6, 9, 2), False),
    "fno": (jfno.FNO2d(out_channels=1, width=8, depth=2, modes=4),
            lambda c: FNO2d(c, 1, width=8, depth=2, modes=4),
            (2, 32, 32, 3), True),
    "fno-odd": (jfno.FNO2d(out_channels=2, width=8, depth=2, modes=4),
                lambda c: FNO2d(c, 2, width=8, depth=2, modes=4),
                (1, 15, 13, 2), True),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jmod, make, shape, nhwc = CASES[request.param]
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    params = _np(jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    mod = make(shape[-1])
    mod.load_state_dict(params_from_flax(params))

    def jcall(p, xx):
        out = jmod.apply(p, xx)
        return out[0] if isinstance(out, tuple) else out

    def pcall(xt):
        if nhwc:
            return mod(xt)[0]
        return _nhwc(mod(_nchw(xt)))

    return dict(name=request.param, jcall=jcall, params=params, mod=mod,
                x=x, pcall=pcall)


def test_forward_matches_flax(case):
    ref = np.asarray(jax.jit(case["jcall"])(case["params"],
                                            jnp.asarray(case["x"])))
    with torch.no_grad():
        got = n(case["pcall"](t(case["x"])))
    assert got.shape == ref.shape
    # rfft/irfft and einsums in float32 summed in another order: 1e-5
    # of max
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


def test_vjp_matches_flax(case):
    jcall, params, x = case["jcall"], case["params"], jnp.asarray(case["x"])
    w = np.random.default_rng(1).standard_normal(
        jcall(params, x).shape).astype(np.float32)
    jgp, jgx = _np(jax.jit(jax.grad(
        lambda p, xx: jnp.sum(jcall(p, xx) * w), argnums=(0, 1)))(params, x))
    jg = params_from_flax(jgp)
    mod = case["mod"]
    mod.zero_grad()
    xt = t(case["x"]).requires_grad_(True)
    torch.sum(case["pcall"](xt) * t(w)).backward()
    # 1e-4 relative, 1e-5 of the largest entry
    np.testing.assert_allclose(n(xt.grad), np.asarray(jgx), rtol=1e-4,
                               atol=1e-5 * float(np.abs(jgx).max()))
    scale = max(float(g.abs().max()) for g in jg.values())
    assert jg.keys() == dict(mod.named_parameters()).keys()
    for name, p in mod.named_parameters():
        np.testing.assert_allclose(n(p.grad), n(jg[name]), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


def test_converter_round_trip_and_npz_keys(case):
    params, mod = case["params"], case["mod"]
    back = params_to_flax(params_from_flax(params), mod)
    ref = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_leaves_with_path(params)}
    got = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_leaves_with_path(back)}
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    sd = state_dict_from_npz(npz_from_state_dict(mod.state_dict(), mod))
    for k, v in mod.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_fno_init_from_generator():
    """Seeded init repeats; spectral weights normal with std 1 / width."""
    a = FNO2d(3, width=16, depth=1, modes=6,
              generator=torch.Generator().manual_seed(0))
    b = FNO2d(3, width=16, depth=1, modes=6,
              generator=torch.Generator().manual_seed(0))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    w = a.fnos[0].spectral.w1_real.detach()
    assert abs(float(w.std()) * 16 - 1) < 0.1   # 9216 draws
    out, latent = a(torch.rand(2, 20, 24, 3))
    assert out.shape == (2, 20, 24, 1) and latent is None


@pytest.mark.parametrize("relative", [True, False])
@pytest.mark.parametrize("p", [1, 2])
def test_lp_loss_matches_jax(relative, p):
    rng = np.random.default_rng(2)
    pred = rng.standard_normal((3, 8, 6, 1)).astype(np.float32)
    target = rng.standard_normal((3, 8, 6, 1)).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda a: jfno.lp_loss(
        a, jnp.asarray(target), p, relative=relative))(jnp.asarray(pred))
    a = t(pred).requires_grad_(True)
    v = lp_loss(a, t(target), p, relative=relative)
    v.backward()
    np.testing.assert_allclose(v.item(), float(jv), rtol=1e-6)
    np.testing.assert_allclose(n(a.grad), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)
    assert float(lp_loss(torch.ones(2, 8, 8), torch.ones(2, 8, 8))) < 1e-6


@pytest.mark.parametrize("window", [5, 11])
@pytest.mark.parametrize("reduce", [True, False])
def test_ssim_matches_jax(window, reduce):
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, 24, 20, 2)).astype(np.float32)
    y = (x + 0.2 * rng.standard_normal(x.shape)).astype(np.float32)
    w = rng.standard_normal((2, 24, 20, 2)).astype(np.float32)

    def jscalar(a):
        s = j_ssim(a, jnp.asarray(y), window_size=window, reduce=reduce)
        return s if reduce else jnp.sum(s * w)

    jv, jg = jax.value_and_grad(jscalar)(jnp.asarray(x))
    a = t(x).requires_grad_(True)
    s = ssim(a, t(y), window_size=window, reduce=reduce)
    assert s.shape == (() if reduce else x.shape)
    v = s if reduce else torch.sum(s * t(w))
    v.backward()
    # float32 Gaussian filtering: 1e-5 of the value, the gradient 1e-4
    # relative and 1e-5 of its max
    np.testing.assert_allclose(v.item(), float(jv), rtol=1e-5)
    np.testing.assert_allclose(n(a.grad), np.asarray(jg), rtol=1e-4,
                               atol=1e-5 * float(np.abs(jg).max()))


def test_ssim_constant_target_and_ties():
    """A constant target (the JAX engine test's) has range 0: the dynamic
    range is the prediction's, whose max and min split their gradient
    among ties as jnp.max does; a 2-D input is one image."""
    x = np.random.default_rng(4).uniform(0.2, 0.8, (1, 16, 16, 1)).astype(
        np.float32)
    x[0, 3, 4, 0] = x[0, 9, 9, 0] = 0.95   # a tied max
    x[0, 0, 0, 0] = x[0, 15, 15, 0] = 0.05  # a tied min
    y = np.full_like(x, 0.5)
    jv, jg = jax.value_and_grad(lambda a: 1 - j_ssim(
        a, jnp.asarray(y), window_size=5))(jnp.asarray(x))
    a = t(x).requires_grad_(True)
    v = 1 - ssim(a, t(y), window_size=5)
    v.backward()
    np.testing.assert_allclose(v.item(), float(jv), rtol=1e-5)
    np.testing.assert_allclose(n(a.grad), np.asarray(jg), rtol=1e-4,
                               atol=1e-5 * float(np.abs(jg).max()))
    two_d = ssim(t(x[0, :, :, 0]), t(y[0, :, :, 0]), window_size=5)
    np.testing.assert_allclose(two_d.item(), 1 - float(jv), rtol=1e-5)
    assert float(ssim(t(x), t(x))) == pytest.approx(1.0, abs=1e-6)
