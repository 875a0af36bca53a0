"""L-BFGS with the zoom (strong-Wolfe) line search (port of
``physicsbasedfwi2_tpu/optim/lbfgs.py``, which builds on
``optax.lbfgs``).

This is optax 0.2.6's algorithm written out in PyTorch, not
``torch.optim.LBFGS`` (another line search, another memory update, other
stopping rules):

- ``scale_by_lbfgs``: the two-loop recursion over a ring memory of
  ``memory_size`` (parameter difference, gradient difference) pairs, a
  pair of inner product 0 weighted 0 (the first update stores such a
  pair), the initial inverse Hessian the identity scaled by
  ``min(1, 1/||g||)`` at the first step and by ``<s, y>/<y, y>`` after;
- ``scale(-1)`` (or ``-learning_rate``);
- ``scale_by_zoom_linesearch``: Nocedal and Wright's algorithms 3.5
  (interval search, the step doubling from 1) and 3.6 (zoom by cubic,
  then quadratic interpolation, then bisection), with Hager and Zhang's
  approximate sufficient decrease, and a step of sufficient decrease
  (or the last probe) taken when ``max_linesearch_steps`` run out.

Every probe evaluates the value and the gradient, and the last probe's
pair stays in the state, as optax's does.  Parameters are a list of
tensors (an ``nn.Module``'s parameters) taken as one vector: the inner
products are sums over all their elements, as ``optax.tree.vdot`` sums
over leaves.  The accept and reject decisions are host scalars in
float32, the precision of the JAX package's, so each probe costs one
device sync.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

def _real(t: torch.Tensor):
    """The host scalar type of ``t``'s dtype: float64 parameters run the
    line search in float64 (optax's under ``jax_enable_x64``)."""
    return np.float64 if t.dtype == torch.float64 else np.float32


class LbfgsState(NamedTuple):
    params: Any
    opt_state: Any


class ZoomLinesearchInfo(NamedTuple):
    """optax's ``ZoomLinesearchInfo``: the probes of the last line search
    (``num_linesearch_steps``) and the errors of its accepted step."""

    num_linesearch_steps: int
    decrease_error: np.float32
    curvature_error: np.float32


@dataclasses.dataclass
class LbfgsOptState:
    """The L-BFGS memory (optax's ``ScaleByLBFGSState``: flat float32
    vectors, the memories [memory_size, n]) and the line search's
    (``ScaleByZoomLinesearchState``: the accepted step size and the
    value and gradient of its last probe)."""

    count: int
    params: torch.Tensor
    updates: torch.Tensor
    diff_params_memory: torch.Tensor
    diff_updates_memory: torch.Tensor
    weights_memory: np.ndarray
    learning_rate: np.float32
    value: np.float32
    grad: torch.Tensor
    info: ZoomLinesearchInfo


def _flat(tensors) -> torch.Tensor:
    return torch.cat([x.reshape(-1) for x in tensors])


def _unflat(vec: torch.Tensor, like) -> list[torch.Tensor]:
    out, i = [], 0
    for x in like:
        out.append(vec[i: i + x.numel()].view(x.shape))
        i += x.numel()
    return out


def _dot(a: torch.Tensor, b: torch.Tensor):
    return _real(a)(torch.dot(a, b).item())


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc)
    with slope fpa at a (NaN where none is real)."""
    C = fpa
    db = b - a
    dc = c - a
    # powers as products, in the order of XLA's integer_pow
    dbdc = db * dc
    denom = dbdc * dbdc * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = (dc * dc * r0 - db * db * r1) / denom
    B = (-(dc * (dc * dc)) * r0 + db * (db * db) * r1) / denom
    three = type(a)(3.0)
    radical = B * B - three * A * C
    return a + (-B + np.sqrt(radical)) / (three * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db * db)
    return a - C / (type(a)(2.0) * B)


@dataclasses.dataclass
class _Probe:
    """A point on the line: step size, value, gradient, slope."""

    stepsize: np.float32
    value: np.float32
    grad: torch.Tensor
    slope: np.float32


# optax's zoom line search as ``scale_by_zoom_linesearch`` sets it up:
# sufficient decrease and curvature tolerances, the approximate-decrease
# tolerance, the interval search's growth, the interval length below
# which a step of sufficient decrease ends the search (optax's
# ``stepsize_precision``); no maximal step, ``tol`` 0
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INCREASE_FACTOR = 2.0
INTERVAL_THRESHOLD = 1e-5


def _decrease_error(F, stepsize, value, slope, value_init, slope_init):
    # Armijo (Nocedal and Wright 3.7a) or, close enough to a minimum,
    # Hager and Zhang's approximate decrease (their equations 23, 26, 27)
    rtol = F(SLOPE_RTOL)
    err = value - value_init - rtol * stepsize * slope_init
    approx = slope - (F(2.0) * rtol - F(1.0)) * slope_init
    delta = value - value_init - F(APPROX_DEC_RTOL) * abs(value_init)
    if np.isnan([err, approx, delta]).any():
        # only a violation counts; NaN counts as infinite
        return F(np.inf)
    return F(max(min(max(approx, delta), err), F(0.0)))


def _curvature_error(F, slope, slope_init):
    err = abs(slope) - F(CURV_RTOL) * abs(slope_init)
    return F(np.inf) if np.isnan(err) else F(max(err, F(0.0)))


class ZoomLinesearch:
    """optax's ``zoom_linesearch`` on host scalars, with at most
    ``max_linesearch_steps`` probes."""

    def __init__(self, max_linesearch_steps: int):
        self.max_steps = max_linesearch_steps

    def search(self, value_and_grad, params: torch.Tensor,
               updates: torch.Tensor, value, grad: torch.Tensor):
        """Run the line search from ``params`` along ``updates``;
        ``value``/``grad`` are the objective's at ``params`` and
        ``value_and_grad(flat) -> (value, flat gradient)``.  Returns
        (step size, value, gradient, info), the scalars of the
        parameters' precision."""
        F = _real(params)
        tol = F(0.0)
        value = F(float(value))
        slope = _dot(updates, grad)
        value_init, slope_init = value, slope
        cur = low = high = cubic = safe = _Probe(F(0.0), value, grad, slope)
        dec_err = curv_err = F(np.inf)
        interval_found = done = failed = False
        count = 0

        def probe(stepsize):
            v, g = value_and_grad(params + float(stepsize) * updates)
            return _Probe(stepsize, F(v), g, _dot(g, updates))

        def errors(p):
            dec = _decrease_error(F, p.stepsize, p.value, p.slope,
                                  value_init, slope_init)
            return dec, _curvature_error(F, p.slope, slope_init)

        with np.errstate(all="ignore"):
            while not (done or failed):
                if not interval_found:
                    # algorithm 3.5: search an interval holding a step
                    new_step = (F(1.0) if count == 0 else
                                F(INCREASE_FACTOR) * cur.stepsize)
                    new = probe(new_step)
                    dec_err, curv_err = errors(new)
                    err = max(dec_err, curv_err)
                    if dec_err <= tol:
                        safe = new
                    set_high = bool(dec_err > 0.0) or (
                        bool(new.value >= cur.value) and count > 0)
                    set_low = bool(new.slope >= 0.0) and not set_high
                    low, high = (new, cur) if set_low else (cur, new)
                    interval_found = set_high or set_low or bool(err <= tol)
                    done = bool(err <= tol)
                    failed = count + 1 >= self.max_steps and not done
                    cubic = low
                    cur = new
                else:
                    # algorithm 3.6: zoom into [low, high] by a cubic, a
                    # quadratic or a bisection, each kept off the ends
                    delta = abs(high.stepsize - low.stepsize)
                    left = min(high.stepsize, low.stepsize)
                    right = max(high.stepsize, low.stepsize)
                    cubic_chk = F(0.2) * delta
                    quad_chk = F(0.1) * delta
                    too_small = bool(delta <= INTERVAL_THRESHOLD)
                    mid_c = _cubicmin(low.stepsize, low.value, low.slope,
                                      high.stepsize, high.value,
                                      cubic.stepsize, cubic.value)
                    mid_q = _quadmin(low.stepsize, low.value, low.slope,
                                     high.stepsize, high.value)
                    if left + cubic_chk < mid_c < right - cubic_chk:
                        middle = F(mid_c)
                    elif left + quad_chk < mid_q < right - quad_chk:
                        middle = F(mid_q)
                    else:
                        middle = (low.stepsize + high.stepsize) / F(2.0)
                    mid = probe(middle)
                    dec_err, curv_err = errors(mid)
                    err = max(dec_err, curv_err)
                    if dec_err <= tol and bool(mid.value < safe.value):
                        safe = mid
                    done = bool(err <= tol)
                    set_high_mid = bool(dec_err > 0.0) or bool(
                        mid.value >= low.value)
                    set_high_low = bool(
                        mid.slope * (high.stepsize - low.stepsize) >= 0.0
                    ) and not set_high_mid
                    # the cubic's third point: the end that moved away
                    cubic = high if set_high_mid or set_high_low else low
                    if set_high_low:
                        high = low
                    elif set_high_mid:
                        high = mid
                    if not set_high_mid:
                        low = mid
                    failed = not done and (
                        count + 1 >= self.max_steps
                        or (too_small and bool(safe.stepsize > 0.0)))
                    cur = mid
                count += 1
                if failed and (bool(safe.stepsize > 0.0)
                               or np.isinf(dec_err)):
                    # out of probes: the best step of sufficient decrease
                    # (none at all where the last probe left the
                    # domain), else the last probe
                    cur = _Probe(safe.stepsize, safe.value, safe.grad,
                                 cur.slope)
        info = ZoomLinesearchInfo(count, dec_err, curv_err)
        return cur.stepsize, cur.value, cur.grad, info


class LbfgsWolfe:
    """``optax.lbfgs(learning_rate, memory_size, linesearch=
    scale_by_zoom_linesearch(max_linesearch_steps,
    initial_guess_strategy="one"))`` on a list of tensors, with optax's
    ``init``/``update`` interface (see :func:`lbfgs_wolfe`)."""

    def __init__(self, learning_rate: float | None = None, *,
                 memory_size: int = 10, max_linesearch_steps: int = 20):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.learning_rate = learning_rate
        self.memory_size = memory_size
        self.linesearch = ZoomLinesearch(max_linesearch_steps)

    def init(self, params) -> LbfgsOptState:
        p = _flat(params).detach()
        zeros = torch.zeros_like(p)
        mem = torch.zeros((self.memory_size,) + p.shape, dtype=p.dtype,
                          device=p.device)
        F = _real(p)
        return LbfgsOptState(
            count=0, params=zeros, updates=zeros.clone(),
            diff_params_memory=mem, diff_updates_memory=mem.clone(),
            weights_memory=np.zeros(self.memory_size, F),
            learning_rate=F(1.0), value=F(np.inf), grad=zeros.clone(),
            info=ZoomLinesearchInfo(0, F(np.inf), F(np.inf)))

    def _precondition(self, g, p, s: LbfgsOptState):
        """optax's ``scale_by_lbfgs``: store the pair of the step just
        taken, then the two-loop product P_k g.  Returns (P_k g, the
        memory part of the new state)."""
        F = _real(p)
        m = self.memory_size
        memory_idx = s.count % m
        prev_idx = (s.count - 1) % m
        if s.count > 0:
            dp = p - s.params
            du = g - s.updates
            vdot = _dot(du, dp)
            weight = F(0.0) if vdot == 0.0 else F(F(1.0) / vdot)
        else:
            dp, du, weight = torch.zeros_like(p), torch.zeros_like(g), F(0)
        dpm = s.diff_params_memory.clone()
        dum = s.diff_updates_memory.clone()
        wm = s.weights_memory.copy()
        dpm[prev_idx], dum[prev_idx], wm[prev_idx] = dp, du, weight
        with np.errstate(all="ignore"):
            if s.count > 0:
                den = _dot(du, du)
                gamma = F(vdot / den) if den > 0.0 else F(1.0)
            else:
                gamma = F(min(F(1.0), F(1.0) / np.sqrt(_dot(g, g))))
        order = [(memory_idx + i) % m for i in range(m)]
        vec = g
        alphas = {}
        for i in reversed(order):
            alphas[i] = float(wm[i]) * torch.dot(dpm[i], vec)
            vec = vec + (-alphas[i]) * dum[i]
        vec = float(gamma) * vec
        for i in order:
            beta = float(wm[i]) * torch.dot(dum[i], vec)
            vec = vec + (alphas[i] - beta) * dpm[i]
        return vec, dict(count=s.count + 1, params=p, updates=g,
                         diff_params_memory=dpm, diff_updates_memory=dum,
                         weights_memory=wm)

    def update(self, grads, state: LbfgsOptState, params, *, value,
               grad, value_fn: Callable):
        """optax's ``update(grads, state, params, value=, grad=,
        value_fn=)``: the L-BFGS direction, scaled by -1 (or
        -learning_rate), then the zoom line search along it, probing
        ``value_fn(list of tensors) -> scalar tensor`` (value and
        gradient by autograd).  Returns (updates as a list like
        ``params``, new state)."""
        like = list(params)
        p = _flat(like).detach()
        g = _flat(grads).detach()
        direction, mem = self._precondition(g, p, state)
        scale = -1.0 if self.learning_rate is None else -self.learning_rate
        direction = scale * direction

        def value_and_grad(flat):
            leaves = [x.detach().requires_grad_(True)
                      for x in _unflat(flat, like)]
            with torch.enable_grad():
                v = value_fn(leaves)
                gs = torch.autograd.grad(v, leaves, allow_unused=True)
            gs = [torch.zeros_like(x) if d is None else d
                  for x, d in zip(leaves, gs)]
            return v.item(), _flat(gs).detach()

        step, val, gr, info = self.linesearch.search(
            value_and_grad, p, direction, value, _flat(grad).detach())
        upd = float(step) * direction
        return _unflat(upd, like), LbfgsOptState(
            **mem, learning_rate=step, value=val, grad=gr, info=info)


def lbfgs_wolfe(learning_rate: float | None = None, *,
                memory_size: int = 10,
                max_linesearch_steps: int = 20) -> LbfgsWolfe:
    """L-BFGS with the strong-Wolfe zoom line search.  memory_size=10
    matches the reference config (history_size=10, line_search='Wolfe')."""
    return LbfgsWolfe(learning_rate, memory_size=memory_size,
                      max_linesearch_steps=max_linesearch_steps)


def apply_updates(params, updates) -> list[torch.Tensor]:
    """``optax.apply_updates``: p + u for each tensor."""
    return [p + u for p, u in zip(params, updates)]


def value_and_grad(loss_fn: Callable, params):
    """(value, gradients) of ``loss_fn(list of tensors) -> scalar``, both
    detached."""
    leaves = [p.detach().requires_grad_(True) for p in params]
    with torch.enable_grad():
        v = loss_fn(leaves)
        gs = torch.autograd.grad(v, leaves)
    return v.detach(), list(gs)


def make_lbfgs_step(loss_fn: Callable, opt: LbfgsWolfe):
    """A closure step ``(params, opt_state) -> (params, opt_state,
    value)`` of the full-batch objective ``loss_fn(list of tensors) ->
    scalar``.  It reuses the value and gradient of the line search's
    last probe where the state holds finite ones (optax's
    ``value_and_grad_from_state``), so no evaluation is spent twice."""

    def step(params, opt_state: LbfgsOptState):
        if np.isfinite(opt_state.value):
            value = torch.tensor(float(opt_state.value))
            grads = _unflat(opt_state.grad, params)
        else:
            value, grads = value_and_grad(loss_fn, params)
        updates, opt_state = opt.update(grads, opt_state, params,
                                        value=value, grad=grads,
                                        value_fn=loss_fn)
        return apply_updates(params, updates), opt_state, value

    return step


def run_lbfgs(loss_fn: Callable, params, *, steps: int,
              memory_size: int = 10, learning_rate: float | None = None):
    """Run L-BFGS for ``steps`` iterations from ``params`` (a list of
    tensors); returns (params, losses)."""
    opt = lbfgs_wolfe(learning_rate, memory_size=memory_size)
    params = [p.detach() for p in params]
    opt_state = opt.init(params)
    step = make_lbfgs_step(loss_fn, opt)
    losses = []
    for _ in range(steps):
        params, opt_state, value = step(params, opt_state)
        losses.append(float(value))
    return params, losses
