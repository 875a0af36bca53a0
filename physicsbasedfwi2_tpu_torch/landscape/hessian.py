"""Hessian spectra via Hessian-vector products (port of
``physicsbasedfwi2_tpu/landscape/hessian.py``).

The reference's ``hess_vec_prod.py`` and ``plot_hessian_eigen.py``
(scipy eigensolvers over HVPs).  Here the HVPs are exact and the extreme
eigenvalues come from a Lanczos iteration.

The JAX package's HVP is ``jax.jvp`` of ``jax.grad`` (forward over
reverse).  ``torch.func`` cannot take that route: its transforms refuse
the saved-tensor hooks of ``torch.utils.checkpoint``, which the
propagators' time loops use.  :func:`hvp` is reverse over reverse
(``create_graph``), exact for any loss but keeping the graph of every
recomputed time step, so its memory grows with nt.  :func:`composite_hvp`
splits a physics loss f(w) = L(D(w)) into the decoder D and the misfit L
and runs forward over reverse only through L, whose time loop then keeps
two carries (primal and tangent) a checkpointed chunk and no tangent a
time step (``ops/scan_utils.py::_DualChunk``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD


def _leaves(params):
    return {k: w.detach().requires_grad_(True) for k, w in params.items()}


def _grads(outputs, leaves, cotangents, **kw):
    """``torch.autograd.grad`` by name, zeros where a leaf is unused."""
    names = list(leaves)
    got = torch.autograd.grad(outputs, [leaves[k] for k in names],
                              cotangents, allow_unused=True, **kw)
    return {k: torch.zeros_like(leaves[k]) if g is None else g
            for k, g in zip(names, got)}


def hvp(loss_fn, params, v):
    """Exact Hessian-vector product of ``loss_fn`` at ``params`` (dicts
    of tensors by name), reverse over reverse."""
    with torch.enable_grad():
        p = _leaves(params)
        g = _grads(loss_fn(p), p, None, create_graph=True)
        dot = sum(torch.sum(g[k] * v[k]) for k in p)
        if not dot.requires_grad:
            return {k: torch.zeros_like(w) for k, w in params.items()}
        return {k: h.detach() for k, h in _grads(dot, p, None).items()}


def composite_hvp(decode, misfit, params, v):
    """Exact Hessian-vector product of f(w) = misfit(decode(w)).

    With u = J_D v and g = grad L at D(w):
    Hv = J_D^T (H_L u) + d/dw <J_D^T g, v>, in three steps:

    1. u = J_D v, by the double-vjp trick on the decoder alone (the vjp
       is linear in its cotangent), so no forward-mode formula is needed
       in the decoder (GroupNorm's backward has none);
    2. g and H_L u in one forward-over-reverse pass through the misfit,
       on a dual tensor of primal D(w) and tangent u (the propagators
       hand dual tensors to the time loop as its ``params``);
    3. both decoder terms in one reverse pass over the decoder's graph
       from step 1.
    """
    with torch.enable_grad():
        p = _leaves(params)
        y = decode(p)
        probe = torch.zeros_like(y, requires_grad=True)
        jt = _grads(y, p, probe, create_graph=True)
        live = [k for k in p if jt[k].requires_grad]
        (u,) = torch.autograd.grad([jt[k] for k in live], probe,
                                   [v[k] for k in live])
        with fwAD.dual_level():
            m = y.detach().requires_grad_(True)
            loss = misfit(fwAD.make_dual(m, u))
            (g,) = torch.autograd.grad(loss, m)
            g, hu = fwAD.unpack_dual(g)
            g = g.detach()
            hu = torch.zeros_like(g) if hu is None else hu.detach()
        jg = _grads(y, p, g, create_graph=True)
        live = [k for k in p if jg[k].requires_grad]
        hv = _grads([y] + [jg[k] for k in live], p,
                    [hu] + [v[k] for k in live])
    return {k: h.detach() for k, h in hv.items()}


def _dot(a, b) -> torch.Tensor:
    return sum(torch.sum(a[k] * b[k]) for k in a)


def lanczos_extreme_eigs(loss_fn, params, *, steps: int = 20,
                         generator=None, data=None, hvp_fn=None):
    """Estimate extreme Hessian eigenvalues with ``steps`` Lanczos
    iterations (full reorthogonalization; fine for steps <= ~50; the
    tridiagonal matrix in float64, solved by ``np.linalg.eigvalsh``).

    The start vector is a normal draw from ``generator`` (default seed 0)
    per leaf, normalized, in the parameters' dtype.  ``hvp_fn(params,
    v)`` is the HVP to use; by default :func:`hvp` of ``loss_fn``
    (called as ``loss_fn(params, data)`` when ``data`` is given).

    Returns (eig_min, eig_max, ritz_values)."""
    gen = generator if generator is not None else (
        torch.Generator().manual_seed(0))
    if hvp_fn is None:
        f = loss_fn if data is None else (lambda q: loss_fn(q, data))
        hvp_fn = lambda p, w: hvp(f, p, w)  # noqa: E731
    v = {k: torch.randn(tuple(w.shape), generator=gen,
                        device=gen.device).to(w)
         for k, w in params.items()}
    nrm = torch.sqrt(_dot(v, v))
    v = {k: a / nrm for k, a in v.items()}
    vs = [v]
    alphas, betas = [], []
    for j in range(steps):
        w = hvp_fn(params, vs[-1])
        alpha = _dot(w, vs[-1])
        w = {k: w[k] - alpha * vs[-1][k] for k in w}
        if j > 0:
            w = {k: w[k] - betas[-1] * vs[-2][k] for k in w}
        # full reorthogonalization
        for u in vs:
            c = _dot(w, u)
            w = {k: w[k] - c * u[k] for k in w}
        beta = torch.sqrt(_dot(w, w))
        alphas.append(float(alpha))
        if j < steps - 1:
            if float(beta) < 1e-10:
                break
            betas.append(float(beta))
            vs.append({k: a / betas[-1] for k, a in w.items()})

    k = len(alphas)
    T = np.zeros((k, k))
    for i, a in enumerate(alphas):
        T[i, i] = a
    for i, b in enumerate(betas[: k - 1]):
        T[i, i + 1] = T[i + 1, i] = b
    ritz = np.linalg.eigvalsh(T)
    return float(ritz.min()), float(ritz.max()), ritz
