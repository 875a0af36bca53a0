"""SGLD and SGHMC (optim/sgmcmc.py): at temperature 0 the same updates as
the JAX package's optax transforms, the noise's statistics, parameters
without a gradient, seeding, and the sampling checks of test_optim.py."""

import math

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from physicsbasedfwi2_tpu.optim import sghmc as j_sghmc, sgld as j_sgld
from physicsbasedfwi2_tpu_torch.optim import SGHMC, SGLD, sghmc, sgld

from torch_parity import n, t

torch.set_num_threads(1)

SHAPES = [(3, 4), (5,)]


def _params(rng):
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


@pytest.mark.parametrize("kind", ["sgld", "sghmc"])
def test_zero_temperature_matches_optax(kind):
    rng = np.random.default_rng(0)
    p0 = _params(rng)
    grads = [_params(rng) for _ in range(5)]
    lr = 0.05
    if kind == "sgld":
        jopt = j_sgld(lr, seed=0, temperature=0.0)
        make = lambda ps: sgld(ps, lr, seed=0, temperature=0.0)  # noqa: E731
    else:
        jopt = j_sghmc(lr, friction=0.1, seed=0, temperature=0.0)
        make = lambda ps: sghmc(ps, lr, friction=0.1,  # noqa: E731
                                seed=0, temperature=0.0)
    jp = [jnp.asarray(a) for a in p0]
    state = jopt.init(jp)
    tp = [torch.nn.Parameter(t(a)) for a in p0]
    opt = make(tp)
    for g in grads:
        upd, state = jopt.update([jnp.asarray(a) for a in g], state)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(tp, g):
            p.grad = t(a)
        opt.step()
        for p, ref in zip(tp, jp):
            np.testing.assert_allclose(n(p), np.asarray(ref), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("kind,sigma", [
    ("sgld", math.sqrt(2 * 1e-3 * 0.5)),
    ("sghmc", math.sqrt(2 * 0.05 * 1e-3 * 0.5))])
def test_noise_statistics(kind, sigma):
    """With a zero gradient one step's update is the noise alone: N(0,
    2 lr T) (SGHMC: N(0, 2 a lr T)), on 1e5 draws."""
    cls = SGLD if kind == "sgld" else SGHMC
    p = torch.nn.Parameter(torch.zeros(10**5))
    p.grad = torch.zeros_like(p)
    cls([p], 1e-3, seed=0, temperature=0.5).step()
    d = n(p).astype(np.float64)
    # the sample std's standard error is sigma / sqrt(2n), ~0.2 %
    assert abs(d.std() / sigma - 1) < 0.01
    assert abs(d.mean()) < 4 * sigma / math.sqrt(d.size)
    # Gaussian tails: ~0.27 % beyond 3 sigma
    assert abs(np.mean(np.abs(d) > 3 * sigma) - 0.0027) < 0.001


@pytest.mark.parametrize("kind", ["sgld", "sghmc"])
def test_parameter_without_grad_still_moves(kind):
    """optax updates every leaf: a parameter whose .grad is None takes its
    noise as with a zero gradient (and, under SGHMC, its momentum's
    decay)."""
    cls = SGLD if kind == "sgld" else SGHMC
    a = torch.nn.Parameter(torch.zeros(50))
    b = torch.nn.Parameter(torch.zeros(50))
    a.grad = torch.zeros_like(a)
    ref = torch.nn.Parameter(torch.zeros(50))
    cls([ref, b], 1e-2, seed=1).step()
    assert b.grad is None and not torch.equal(b, torch.zeros(50))
    cls([a, torch.nn.Parameter(torch.zeros(50))], 1e-2, seed=1).step()
    assert torch.equal(a, ref)   # the same draws as with a zero gradient
    if kind == "sghmc":
        # momentum from a first step's gradient decays on a step without
        c = torch.nn.Parameter(torch.zeros(4))
        opt = SGHMC([c], 0.1, friction=0.25, seed=0, temperature=0.0)
        c.grad = torch.ones(4)
        opt.step()
        c.grad = None
        opt.step()
        # v1 = -0.1, v2 = 0.75 v1: c = v1 + v2
        torch.testing.assert_close(c.detach(), torch.full((4,), -0.175))


@pytest.mark.parametrize("kind", ["sgld", "sghmc"])
def test_seeding_is_reproducible(kind):
    cls = SGLD if kind == "sgld" else SGHMC

    def run(seed):
        p = torch.nn.Parameter(torch.zeros(20))
        opt = cls([p], 1e-2, seed=seed)
        for _ in range(3):
            p.grad = p.detach().clone()
            opt.step()
        return p.detach()

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    assert cls([torch.nn.Parameter(torch.zeros(1))], 1.0).generator.device \
        == torch.device("cpu")


def test_sgld_samples_gaussian():
    """SGLD on a 1D Gaussian potential: sample variance ~ target."""
    p = torch.nn.Parameter(torch.zeros(1))
    opt = sgld([p], 1e-2, seed=0)
    samples = []
    for i in range(3000):
        p.grad = p.detach().clone()  # grad of 0.5 p^2 -> N(0, 1)
        opt.step()
        if i > 500:
            samples.append(float(p.detach()))
    var = np.var(samples)
    assert 0.5 < var < 2.0, var


def test_sghmc_runs_and_explores():
    p = torch.nn.Parameter(torch.zeros(2))
    opt = sghmc([p], 1e-3, friction=0.1, seed=0)
    traj = []
    for _ in range(2000):
        p.grad = p.detach().clone()
        opt.step()
        traj.append(n(p).copy())
    traj = np.stack(traj)
    assert np.isfinite(traj).all()
    assert traj[1000:].std() > 0.05  # explores, not stuck
