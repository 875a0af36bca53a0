"""Kernel B2 (fused L1 loss + gradient): the port's plain version
against the Pallas kernel in interpret mode, the committed golden, the
misfit VJP against jax.grad, and the loss at the true model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.geo import ricker as j_ricker
from physicsbasedfwi2_tpu.ops import simulate_acoustic as j_simulate
from physicsbasedfwi2_tpu.ops import trace_normalize as j_trace_normalize
from physicsbasedfwi2_tpu.ops.pallas_fwi_fused import (
    fwi_l1_loss_grad as j_fused, scatter_rows as j_scatter_rows,
)
from physicsbasedfwi2_tpu.ops.pallas_scalar2 import forward2 as j_forward2
from physicsbasedfwi2_tpu_torch.ops import trace_normalize
from physicsbasedfwi2_tpu_torch.ops.fwi_fused import (
    EPS, _misfit_plain, fwi_l1_loss_grad, fwi_l1_loss_grad_plain,
    scatter_rows,
)
from physicsbasedfwi2_tpu_torch.ops.scalar2 import forward2

from torch_parity import (
    acoustic_case, golden, jax_acoustic, n, rel_l2, t, torch_acoustic,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden_case():
    """test_golden's fused case: obs from the first-order propagator at a
    perturbed model, and the direct rows of forward2 at 1700 m/s."""
    grid, cfg, wargs, vp, geom = acoustic_case()
    jcfg = jax_acoustic(grid, cfg)
    wav = np.asarray(j_ricker(*wargs))
    vpt = vp.copy()
    vpt[20:30, 15:35] += 150.0
    obs_norm = j_trace_normalize(j_simulate(jnp.asarray(vpt), wav,
                                            *map(jnp.asarray, geom), jcfg))
    g = jcfg.grid
    obs_rows = np.asarray(j_scatter_rows(obs_norm, jnp.asarray(geom[3]),
                                         nt=g.nt, nx=g.nx,
                                         pml_width=g.pml_width))
    direct = np.asarray(j_forward2(jnp.full_like(jnp.asarray(vp), 1700.0),
                                   wav, *map(jnp.asarray, geom), jcfg,
                                   return_rows=True, interpret=True))
    direct = np.pad(direct, ((0, 0), (0, obs_rows.shape[1] - g.nt), (0, 0)))
    return dict(grid=grid, cfg=cfg, wav=wav, vp=vp, geom=geom,
                obs_norm=np.asarray(obs_norm), obs_rows=obs_rows,
                direct=direct)


# "half": half the direct rows, so pred - dir never cancels; with the
# full direct wave, rows before the scattered arrivals cancel to rounding
# noise and the L1 signs there follow rounding (see the engine tests)
@pytest.mark.parametrize("dir_kind", ["zero", "half"])
def test_fused_matches_pallas_interpret(golden_case, dir_kind):
    c = golden_case
    dir_rows = (np.zeros_like(c["obs_rows"]) if dir_kind == "zero"
                else (0.5 * c["direct"]).astype(np.float32))
    jl, jg = j_fused(jnp.asarray(c["vp"]), jnp.asarray(c["wav"]),
                     *map(jnp.asarray, c["geom"]),
                     jax_acoustic(c["grid"], c["cfg"]),
                     jnp.asarray(c["obs_rows"]), jnp.asarray(dir_rows),
                     interpret=True)
    tl, tg = fwi_l1_loss_grad(t(c["vp"]), t(c["wav"]), *map(t, c["geom"]),
                              torch_acoustic(c["grid"], c["cfg"]),
                              t(c["obs_rows"]), t(dir_rows))
    assert tg.shape == jg.shape
    # float32 sums in another order: loss 1e-5, gradient 1e-4 rel L2
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert rel_l2(tg, jg) <= 1e-4


def test_fused_matches_golden(golden_case):
    c = golden_case
    ref = golden("fused_acoustic_small")
    tl, tg = fwi_l1_loss_grad(t(c["vp"]), t(c["wav"]), *map(t, c["geom"]),
                              torch_acoustic(c["grid"], c["cfg"]),
                              t(c["obs_rows"]),
                              torch.zeros(c["obs_rows"].shape))
    np.testing.assert_allclose(float(tl), float(ref["loss"][0]), rtol=1e-5)
    assert rel_l2(tg, ref["grad"]) <= 1e-4


def test_scatter_rows_matches_jax_with_duplicate_columns(golden_case):
    c = golden_case
    g = c["grid"]
    rcv_x = c["geom"][3].copy()
    rcv_x[:, 1] = rcv_x[:, 0]  # duplicate receivers add up
    ref = j_scatter_rows(jnp.asarray(c["obs_norm"]), jnp.asarray(rcv_x),
                         nt=g["nt"], nx=g["nx"], pml_width=g["pml_width"])
    got = scatter_rows(t(c["obs_norm"]), t(rcv_x), nt=g["nt"], nx=g["nx"],
                       pml_width=g["pml_width"])
    np.testing.assert_array_equal(n(got), np.asarray(ref))


def _jax_misfit(y, obs, mask, inv_count):
    m = jnp.max(jnp.abs(y), axis=1, keepdims=True)
    yn = y / (m + EPS)
    return inv_count * jnp.sum(jnp.abs((yn - obs) * mask[:, None, :]))


def test_misfit_vjp_with_ties_and_zeros_matches_jax_grad():
    """The hand-derived VJP against jax.grad of the same formula: each
    tied maximum carries its own sign / cnt (jnp.max's subgradient),
    and sign(0) = 0 for zero samples and zero residuals."""
    rng = np.random.default_rng(7)
    ns, nt, nx = 2, 16, 6
    y = rng.uniform(-0.4, 0.4, (ns, nt, nx)).astype(np.float32)
    # column maxima 0.5 (a power of two, so y/(m+eps) == y*(1/(m+eps))
    # exactly and residuals can be made exactly zero)
    y[:, 3, :] = 0.5
    y[0, 9, 0] = -0.5          # tie of opposite sign
    y[1, 4, 2] = 0.5           # tie of equal sign
    y[0, 5:8, 1] = 0.0         # zero samples
    y[1, :, 3] = 0.0           # a dead column: m = 0, all samples tie
    obs = rng.uniform(-1, 1, (ns, nt, nx)).astype(np.float32)
    obs[0, 2, 4] = 2.0 * y[0, 2, 4]   # zero residuals
    obs[1, 6, 5] = 2.0 * y[1, 6, 5]
    mask = np.ones((ns, nx), np.float32)
    mask[:, 5] = 0.0           # a column that is not a receiver
    mask[1, 5] = 1.0
    inv_count = 1.0 / (ns * nt * 5)
    jl, jg = jax.value_and_grad(_jax_misfit)(jnp.asarray(y),
                                             jnp.asarray(obs),
                                             jnp.asarray(mask), inv_count)
    tl, ybar = _misfit_plain(t(y), t(obs), t(mask), inv_count)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    # a handful of float32 terms per entry: 1e-6 of max
    np.testing.assert_allclose(n(ybar), np.asarray(jg), rtol=0,
                               atol=1e-6 * float(jnp.abs(jg).max()))


def test_loss_at_true_model_is_near_zero():
    """obs and direct rows made by the port's forward2: at the true
    model the residual is zero up to 1/(m+eps) vs division rounding."""
    grid, cfg, wargs, vp, geom = acoustic_case()
    vp = vp.copy()
    vp[24:30, 10:30] = 2400.0
    tc = torch_acoustic(grid, cfg)
    wav = t(np.asarray(j_ricker(*wargs)))
    g = tc.grid
    const = torch.full((g.nz, g.nx), 1700.0)
    dir_rows = forward2(const, wav, *map(t, geom), tc, return_rows=True)
    cols = t(geom[3]).long() + g.pml_width
    obs = (forward2(t(vp), wav, *map(t, geom), tc)
           - torch.gather(dir_rows, 2, cols[:, None, :].expand(-1, g.nt, -1)))
    obs_rows = scatter_rows(trace_normalize(obs), t(geom[3]), nt=g.nt,
                            nx=g.nx, pml_width=g.pml_width)
    dir_pad = torch.nn.functional.pad(
        dir_rows, (0, 0, 0, obs_rows.shape[1] - g.nt))
    loss, grad = fwi_l1_loss_grad(t(vp), wav, *map(t, geom), tc, obs_rows,
                                  dir_pad)
    assert float(loss) <= 1e-6
    loss0, _ = fwi_l1_loss_grad(t(vp) - 100.0, wav, *map(t, geom), tc,
                                obs_rows, dir_pad)
    assert float(loss0) > 1e3 * max(float(loss), 1e-12)


def test_float64_plain_and_unported_options():
    grid, cfg, wargs, vp, geom = acoustic_case()
    tc = torch_acoustic(grid, cfg)
    wav = t(np.asarray(j_ricker(*wargs)))
    rows = torch.zeros((2, 192, 128))
    rows[:, :180] = torch.randn((2, 180, 128),
                                generator=torch.Generator().manual_seed(0))
    l32, g32 = fwi_l1_loss_grad_plain(t(vp), wav, *map(t, geom), tc, rows,
                                      torch.zeros_like(rows))
    l64, g64 = fwi_l1_loss_grad_plain(t(vp), wav, *map(t, geom), tc, rows,
                                      torch.zeros_like(rows),
                                      dtype=torch.float64)
    assert g64.dtype == torch.float64
    # the same discrete problem without float32 rounding
    np.testing.assert_allclose(float(l32), float(l64), rtol=1e-5)
    assert rel_l2(g32, g64) <= 1e-4
    with pytest.raises(ValueError, match="no kernel"):
        fwi_l1_loss_grad(t(vp).to("meta"), wav, *map(t, geom), tc, rows,
                         torch.zeros_like(rows))


def test_wavelet_gradient_matches_pallas_interpret_and_fd():
    """dJ/dwavelet (want_wavelet_grad) on tests/test_acoustic.py's
    AutoWav case: against the Pallas kernel in interpret mode, and
    against a directional finite difference of the plain loss in
    float64 (small eps: the L1 signs and the per-trace max are kinks).

    Before the first arrival both the prediction and the observed data
    are rounding-level precursors, so the L1 signs there follow the
    runtime's handling of float32 subnormals (XLA on the CPU flushes
    them, PyTorch keeps them as float64 does): there the two packages'
    dJ/dwavelet differ by ~1e-3.  The comparison with the JAX kernel
    therefore offsets the observed rows by 3 inside the receiver
    columns, so that every residual keeps its sign."""
    from physicsbasedfwi2_tpu.geo import surface_line
    from physicsbasedfwi2_tpu.geo import Grid2D as JGrid
    from physicsbasedfwi2_tpu.ops import AcousticConfig as JConfig
    nz, nx, nt, KC = 32, 48, 96, 16
    grid = dict(nz=nz, nx=nx, dx=10.0, nt=nt, dt=0.001, pml_width=8)
    jcfg = JConfig(grid=JGrid(**grid), chunk=16, vmax_pml=3000.0)
    wav = np.asarray(j_ricker(12.0, nt, 0.001))
    acq = surface_line(2, 16, nx, src_depth=2, rcv_depth=2)
    geom = tuple(np.asarray(a) for a in
                 (acq.src_z, acq.src_x, acq.rcv_z, acq.rcv_x))
    vp = np.full((nz, nx), 1800.0, np.float32)
    vpt = vp.copy()
    vpt[12:20, 15:35] += 200.0
    obs_norm = j_trace_normalize(j_simulate(jnp.asarray(vpt), wav,
                                            *map(jnp.asarray, geom), jcfg))
    obs_rows = np.asarray(j_scatter_rows(obs_norm, jnp.asarray(geom[3]),
                                         nt=nt, nx=nx, pml_width=8, KC=KC))
    wav2 = np.broadcast_to(wav[None, :], (2, nt)).astype(np.float32)
    fixed = obs_rows.copy()
    fixed[:, :, geom[3][0] + 8] += 3.0
    jl, _, jgw = j_fused(jnp.asarray(vp), jnp.asarray(wav2),
                         *map(jnp.asarray, geom), jcfg, jnp.asarray(fixed),
                         jnp.zeros(obs_rows.shape), KC=KC,
                         want_wavelet_grad=True, interpret=True)
    tc = torch_acoustic(grid, dict(chunk=16, vmax_pml=3000.0))
    tl, _, tgw = fwi_l1_loss_grad(t(vp), t(wav2), *map(t, geom), tc,
                                  t(fixed), torch.zeros(obs_rows.shape),
                                  KC=KC, want_wavelet_grad=True)
    assert tgw.shape == jgw.shape == (2, nt)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    # float32 sums in another order, as the dJ/dvp comparisons above
    assert rel_l2(tgw, jgw) <= 1e-4

    # on the same misfit, the float64 plain version against a
    # directional FD of its loss (smooth there: no residual changes sign)
    def loss64(w):
        return float(fwi_l1_loss_grad_plain(
            t(vp), w, *map(t, geom), tc, t(fixed),
            torch.zeros(obs_rows.shape), KC=KC, dtype=torch.float64)[0])

    w0 = t(wav2).double()
    _, _, gw64 = fwi_l1_loss_grad_plain(
        t(vp), w0, *map(t, geom), tc, t(fixed), torch.zeros(obs_rows.shape),
        KC=KC, want_wavelet_grad=True, dtype=torch.float64)
    rng = np.random.default_rng(0)
    d = rng.standard_normal((2, nt))
    for _ in range(2):
        d[:, 1:-1] = 0.25 * (d[:, 2:] + d[:, :-2]) + 0.5 * d[:, 1:-1]
    d = torch.as_tensor(d / np.abs(d).max())
    eps = 1e-4 * float(np.abs(wav).max())
    fd = (loss64(w0 + eps * d) - loss64(w0 - eps * d)) / (2 * eps)
    ad = float(torch.sum(gw64 * d))
    # the wavelet enters in float32, as the kernel gets it: each sample
    # of w +- eps d is rounded by ~6e-8 of its size, ~6e-4 of the step
    # (a step 10x larger crosses a change of a trace's maximum)
    assert abs(fd - ad) <= 1e-3 * abs(fd), (fd, ad)

    # the real misfit: the wrapper's float32 against the plain float64
    args = (t(vp), t(wav2), *map(t, geom), tc, t(obs_rows),
            torch.zeros(obs_rows.shape))
    _, _, tgw = fwi_l1_loss_grad(*args, KC=KC, want_wavelet_grad=True)
    _, _, gw64 = fwi_l1_loss_grad_plain(*args, KC=KC, want_wavelet_grad=True,
                                        dtype=torch.float64)
    assert rel_l2(tgw, gw64) <= 1e-4
