"""The port's L-BFGS (``optim/lbfgs.py``) against the JAX package's
``lbfgs_wolfe`` (``optax.lbfgs`` with the zoom line search).

Each step starts both optimizers from the same state, the JAX one's
(iterate, L-BFGS memory, last probe), so that float32 rounding, which
the Rosenbrock valley amplifies step after step, cannot carry from one
step into the next.  Per step the next iterate agrees within 1e-5 of the
larger of the two iterates' magnitudes, the accepted step size within
1e-5, and the number of probes exactly.  Cases: a quadratic, Rosenbrock
from the JAX test's start for 60 steps, a two-tensor problem that runs
past ``memory_size``, one whose zoom takes the cubic and the quadratic
interpolation, and one that runs out of line-search steps.  The free
runs of ``run_lbfgs`` converge as the JAX package's tests require.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.optim.lbfgs import lbfgs_wolfe as j_lbfgs_wolfe
from physicsbasedfwi2_tpu.optim.lbfgs import make_lbfgs_step as j_step
from physicsbasedfwi2_tpu_torch.optim import LbfgsState, lbfgs_wolfe
from physicsbasedfwi2_tpu_torch.optim import lbfgs as t_lbfgs

A = np.array([[3.0, 1.0], [1.0, 2.0]], np.float32)
RNG = np.random.default_rng(5)
X = RNG.standard_normal((8, 4)).astype(np.float32)
Y = RNG.standard_normal(8).astype(np.float32)
V = RNG.standard_normal(3).astype(np.float32)
W0 = [RNG.standard_normal((4, 3)).astype(np.float32),
      RNG.standard_normal(3).astype(np.float32)]
C = np.array([0.5, -0.25, 1.0], np.float32)


def _quad(p, xp):
    return 0.5 * p[0] @ xp(A) @ p[0]


def _rosen(p, xp):
    x, y = p[0][0], p[0][1]
    return (1 - x) ** 2 + 100.0 * (y - x ** 2) ** 2


def _two_tensor(p, xp):
    w, b = p
    tanh = jnp.tanh if xp is jnp.asarray else torch.tanh
    return (((tanh(xp(X) @ w + b) @ xp(V) - xp(Y)) ** 2).mean()
            + 0.05 * (w ** 2).mean())


def _quartic(p, xp):
    d = p[0] - xp(C)
    return (d ** 4).sum() + (d ** 2).sum()


# name: (objective, start, steps, optimizer keywords); the quadratic
# stops where its loss (2e-31 after 9 steps) would leave float32's normal
# range: XLA on the CPU flushes subnormals to zero, PyTorch keeps them
CASES = {
    "quadratic": (_quad, [np.array([5.0, -3.0], np.float32)], 9, {}),
    "rosenbrock": (_rosen, [np.array([-1.2, 1.0], np.float32)], 60, {}),
    "two_tensor_past_memory": (_two_tensor, W0, 20, dict(memory_size=3)),
    "zoom": (_quartic, [np.array([1.5, -0.7, 0.3], np.float32)], 6,
             dict(learning_rate=8.0)),
    "exhausted": (_quartic, [np.array([1.5, -0.7, 0.3], np.float32)], 4,
                  dict(learning_rate=1e4, max_linesearch_steps=3)),
}


def _port_state(js):
    """The JAX chain's state (scale_by_lbfgs, scale, zoom line search) as
    the port's ``LbfgsOptState`` (flat vectors, leaves in order)."""
    lb, _, ls = js

    def flat(leaves):
        return torch.tensor(np.concatenate(
            [np.asarray(a).reshape(-1) for a in leaves]))

    def mem(leaves):
        return torch.tensor(np.concatenate(
            [np.asarray(a).reshape(np.asarray(a).shape[0], -1)
             for a in leaves], 1))

    f = np.float32
    return t_lbfgs.LbfgsOptState(
        count=int(lb.count), params=flat(lb.params),
        updates=flat(lb.updates),
        diff_params_memory=mem(lb.diff_params_memory),
        diff_updates_memory=mem(lb.diff_updates_memory),
        weights_memory=np.asarray(lb.weights_memory, f),
        learning_rate=f(ls.learning_rate), value=f(ls.value),
        grad=flat(ls.grad), info=t_lbfgs.ZoomLinesearchInfo(
            int(ls.info.num_linesearch_steps), f(ls.info.decrease_error),
            f(ls.info.curvature_error)))


def _run(name, monkeypatch):
    """Both optimizers step by step from the JAX trajectory; returns the
    per-step (iterate error, JAX step size, port step size, JAX probes,
    port probes) and the zoom's interpolation choices."""
    fn, p0, steps, kw = CASES[name]
    jopt = j_lbfgs_wolfe(kw.get("learning_rate"),
                         memory_size=kw.get("memory_size", 10),
                         max_linesearch_steps=kw.get(
                             "max_linesearch_steps", 20))
    topt = lbfgs_wolfe(kw.get("learning_rate"),
                       memory_size=kw.get("memory_size", 10),
                       max_linesearch_steps=kw.get("max_linesearch_steps",
                                                   20))
    jstep = j_step(lambda p: fn(p, jnp.asarray), jopt)
    tstep = t_lbfgs.make_lbfgs_step(lambda p: fn(p, torch.tensor), topt)
    # record, for each zoom probe, whether the cubic and the quadratic
    # interpolant fell inside their guarded intervals
    choices = []
    cubic, quad = t_lbfgs._cubicmin, t_lbfgs._quadmin

    def cubic_rec(a, fa, fpa, b, fb, c, fc):
        out = cubic(a, fa, fpa, b, fb, c, fc)
        lo, d = min(a, b), abs(b - a)
        choices.append([bool(lo + 0.2 * d < out < lo + d - 0.2 * d)])
        return out

    def quad_rec(a, fa, fpa, b, fb):
        out = quad(a, fa, fpa, b, fb)
        lo, d = min(a, b), abs(b - a)
        choices[-1].append(bool(lo + 0.1 * d < out < lo + d - 0.1 * d))
        return out

    monkeypatch.setattr(t_lbfgs, "_cubicmin", cubic_rec)
    monkeypatch.setattr(t_lbfgs, "_quadmin", quad_rec)
    jp = [jnp.asarray(a) for a in p0]
    js = jopt.init(jp)
    rows = []
    for _ in range(steps):
        tp = [torch.tensor(np.asarray(a)) for a in jp]
        scale0 = max(float(np.abs(np.asarray(a)).max()) for a in jp)
        tp, ts, tv = tstep(tp, _port_state(js))
        jp, js, jv = jstep(jp, js)
        jflat = np.concatenate([np.ravel(a) for a in jp])
        tflat = np.concatenate([a.numpy().ravel() for a in tp])
        err = float(np.abs(jflat - tflat).max()
                    / max(scale0, float(np.abs(jflat).max())))
        rows.append((err, float(js[-1].learning_rate),
                     float(ts.learning_rate),
                     int(js[-1].info.num_linesearch_steps),
                     ts.info.num_linesearch_steps))
    return rows, choices


@pytest.mark.parametrize("name", sorted(CASES))
def test_steps_match_optax(name, monkeypatch):
    rows, choices = _run(name, monkeypatch)
    for k, (err, jlr, tlr, jn, tn) in enumerate(rows):
        assert err <= 1e-5, (k, err)
        assert abs(tlr - jlr) <= 1e-5 * abs(jlr), (k, tlr, jlr)
        assert tn == jn, (k, tn, jn)
    probes = [r[3] for r in rows]
    if name == "zoom":
        # the zoom used the cubic at least once, and the quadratic where
        # the cubic fell outside its interval
        assert any(c for c, _ in choices)
        assert any(q and not c for c, q in choices)
        assert max(probes) >= 3
    if name == "exhausted":
        # every line search ran out of its 3 probes and, finding no step
        # of sufficient decrease, took its last probe, or no step at all
        # once the last probe left the finite domain
        assert probes == [3] * len(rows)
        assert rows[0][1] > 0.0 and rows[-1][1] == 0.0


def test_first_step_and_memory():
    """The first direction is -g scaled by min(1, 1/||g||); the first
    update stores a zero pair weighted 0 in the last memory slot."""
    p = [torch.tensor([5.0, -3.0])]
    opt = lbfgs_wolfe()
    state = opt.init(p)
    grads = [torch.tensor(A) @ p[0]]
    value = _quad(p, torch.tensor)
    updates, state = opt.update(grads, state, p, value=value, grad=grads,
                                value_fn=lambda q: _quad(q, torch.tensor))
    g = grads[0]
    direction = -g / g.norm()
    assert torch.allclose(updates[0], float(state.learning_rate) * direction,
                          rtol=1e-6)
    assert state.count == 1 and state.weights_memory[-1] == 0.0
    assert not state.diff_params_memory.any()
    assert torch.equal(state.params, p[0]) and torch.equal(state.updates, g)
    assert isinstance(LbfgsState(p, state).opt_state, t_lbfgs.LbfgsOptState)


def test_run_lbfgs_converges():
    """The JAX package's convergence tests (tests/test_optim.py) on the
    port's free-running ``run_lbfgs``."""
    p, losses = t_lbfgs.run_lbfgs(lambda q: _rosen(q, torch.tensor),
                                  [torch.tensor([-1.2, 1.0])], steps=60)
    assert losses[-1] < 1e-6, losses[-1]
    np.testing.assert_allclose(p[0].numpy(), [1.0, 1.0], atol=1e-3)
    p, losses = t_lbfgs.run_lbfgs(lambda q: _quad(q, torch.tensor),
                                  [torch.tensor([5.0, -3.0])], steps=15)
    assert losses[-1] < 1e-8
