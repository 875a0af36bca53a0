"""The first training steps of a cell, in plain PyTorch: the observed
data, the generator's decode, the physics misfit and its gradient, the
recipe's gradient processing, the generator's backward and Adam.

``run(case, steps)`` follows a deep-image-prior recipe from the seed's
inputs and returns what the comparison reads: the physics loss of each
physics step, every weight's gradient at the first physics step, the
weights before and after the compared steps (and, for a recipe with
anchor epochs, after them), and the observed data.

Acoustic (Auto22, L1): vp = vmin + field (vmax - vmin) of the true
model's range, water cells pinned to 1500 m/s; the misfit of the traces
less the direct wave (the same scheme in a constant 1500 m/s model); the
gradient times depth index^2, zero in the water, times ``grad_scale``.

Elastic (AutoElMar22, tnl1): m = start + 100 m/s x deltas, clipped to
[1500, 4700] (vp) and [0, 2700] (vs), the water rows pinned to the true
model; density the starting model's.  ``lstart`` anchor epochs fit m to
the starting model (mean squared), then each physics epoch fits the
epoch's drawn shots at the first continuation stage's band (order-6
Butterworth on the wavelet and the observed traces); the gradient
zeroed above ``grad_taper_rows``, times depth index^2, times
``grad_scale``, plus the tether ``tether_weight`` rms(g) (m - start) /
rms(m - start) per field.

Adam: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, w -= lr m_hat /
(sqrt(v_hat) + eps), b2 = 0.999.

``fault="half_shots"`` runs the misfit on every other shot only (a batch
with half its rows left out, the mean over the rest); ``fault="grad_x2"``
doubles the physics gradient (a gradient wrong by a constant factor,
which Adam's step does not see).
"""

from __future__ import annotations

import math

import torch

from fwibench.reference import acoustic, elastic, generator


class Adam:
    def __init__(self, params: dict, b1: float, eps: float):
        self.p, self.b1, self.b2, self.eps = params, b1, 0.999, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict, lr: float):
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, w in self.p.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[k].sqrt() / math.sqrt(c2)).add_(self.eps)
            w.addcdiv_(self.m[k], denom, value=-lr / c1)

    def load(self, state: dict):
        """Weights, moments and step count from ``state`` ({"w", "m",
        "v", "t"})."""
        with torch.no_grad():
            for k, w in self.p.items():
                w.copy_(state["w"][k])
                self.m[k].copy_(state["m"][k])
                self.v[k].copy_(state["v"][k])
        self.t = state["t"]


def _grads(out, cot, params):
    names = list(params)
    gs = torch.autograd.grad(out, [params[k] for k in names], cot,
                             allow_unused=True)
    return {k: torch.zeros_like(params[k]) if g is None else g
            for k, g in zip(names, gs)}


def _clone(d):
    return {k: v.detach().clone() for k, v in d.items()}


def _subset(geom, idx):
    """The acquisition of the shots ``idx`` (a 1-D index tensor)."""
    idx = idx.cpu().numpy()
    return {k: v[idx] for k, v in geom.items()}


def acoustic_run(case: dict, steps: int, prec, fault=None) -> dict:
    c, dev = case["config"], case["device"]
    if c["lstart"]:
        raise ValueError("the acoustic reference has no anchor epochs")
    g, geom, wav = case["grid"], case["geom"], case["wavelet"]
    true = torch.as_tensor(case["models"]["true"]["vp"], device=dev)
    with torch.no_grad():
        obs = acoustic.simulate(true, wav, geom, g)
        direct = acoustic.simulate(torch.full_like(true, c["water_vel"]),
                                   wav, geom, g)
    stored = obs - direct
    obs_norm = acoustic.trace_normalize(stored)
    shots_in = stored.permute(1, 2, 0)[None].contiguous()
    p = {k: v.detach().clone().requires_grad_() for k, v in
         case["weights"].items()}
    opt = Adam(p, c["beta1"], c["adam_eps"])
    water = true == c["water_vel"]
    depth2 = torch.arange(true.shape[0], dtype=torch.float32,
                          device=dev)[:, None] ** 2
    idx = (torch.arange(0, stored.shape[0], 2, device=dev)
           if fault == "half_shots" else None)
    out = {"obs": stored, "loss": [], "w0": _clone(p)}
    for k in range(steps):
        with prec.switches(dev):
            field = generator.auto22(p, shots_in, case["arch"], prec)
        vp = true.min() + field[0, :, :, 0] * (true.max() - true.min())
        vp = torch.where(water, torch.full_like(vp, c["water_vel"]), vp)
        if k == 0:
            out["mse1"] = float(torch.mean((vp.detach() - true) ** 2))
        leaf = vp.detach().requires_grad_()
        gm, dm, on = geom, direct, obs_norm
        if idx is not None:
            gm = _subset(geom, idx.cpu())
            dm, on = direct[idx], obs_norm[idx]
        with torch.enable_grad():
            loss = acoustic.l1_misfit(acoustic.simulate(leaf, wav, gm, g),
                                      dm, on)
            (gvp,) = torch.autograd.grad(loss, leaf)
        gvp = torch.where(water, torch.zeros_like(gvp), gvp * depth2)
        gvp = gvp * c["grad_scale"]
        if fault == "grad_x2":
            gvp = 2.0 * gvp
        with prec.switches(dev):
            grads = _grads(vp, gvp, p)
        out["loss"].append(float(loss.detach()))
        if k == 0:
            out["g1"] = _clone(grads)
        opt.step(grads, c["lr"])
    out["w_end"] = _clone(p)
    return out


def _elastic_model(p, case, prec):
    c, dev = case["config"], case["device"]
    with prec.switches(dev):
        d = generator.autoelmar22(p, case["in_vx"], case["in_vz"],
                                  case["arch"], prec)
    m = case["lowf"] + d * torch.tensor(c["delta_scale"], device=dev)
    m = torch.minimum(torch.maximum(
        m, torch.tensor(c["clip_min"], device=dev)),
        torch.tensor(c["clip_max"], device=dev))
    row = torch.arange(m.shape[1], device=dev)[None, :, None, None]
    return torch.where(row < c["water_rows"], case["true_m"], m)


def elastic_anchor(case: dict, prec) -> dict:
    """The observed data and the ``lstart`` anchor epochs from the seed's
    weights: the state the physics steps start from ({"w", "m", "v",
    "t"}: weights, Adam's moments, step count), with the first decode's
    model MSE.  Adds the generator's inputs and the model bounds to
    ``case``."""
    c, dev = case["config"], case["device"]
    g, geom, wav = case["grid"], case["geom"], case["wavelet"]
    true = {k: torch.as_tensor(v, device=dev)
            for k, v in case["models"]["true"].items()}
    start = {k: torch.as_tensor(v, device=dev)
             for k, v in case["models"]["start"].items()}
    with torch.no_grad():
        ovx, ovz = elastic.simulate(true["vp"], true["vs"], true["rho"], wav,
                                    geom, g)
    case["obs_full"] = (ovx, ovz)
    case["in_vx"] = ovx.permute(1, 2, 0)[None].contiguous()
    case["in_vz"] = ovz.permute(1, 2, 0)[None].contiguous()
    case["lowf"] = torch.stack([start["vp"], start["vs"]], -1)[None]
    case["true_m"] = torch.stack([true["vp"], true["vs"]], -1)[None]
    p = {k: v.detach().clone().requires_grad_() for k, v in
         case["weights"].items()}
    opt = Adam(p, c["beta1"], c["adam_eps"])
    out = {"obs": (ovx, ovz), "w0": _clone(p)}
    for e in range(1, c["lstart"] + 1):
        m = _elastic_model(p, case, prec)
        if e == 1:
            out["mse1"] = float(torch.mean((m.detach() - case["true_m"]) ** 2))
        with prec.switches(dev):
            grads = _grads(torch.mean((m - case["lowf"]) ** 2), None, p)
        opt.step(grads, c["lr"])
    if c["lstart"]:
        out["w_anchor"] = _clone(p)
    out["state_anchor"] = {"w": _clone(p), "m": _clone(opt.m),
                           "v": _clone(opt.v), "t": opt.t}
    return out


def elastic_run(case: dict, steps: int, prec, fault=None,
                from_state=None, anchor=None) -> dict:
    """The physics steps after :func:`elastic_anchor` (``anchor``, run
    here when not given).  With ``from_state`` they start from that
    state in place of the anchor's own."""
    c, dev = case["config"], case["device"]
    if anchor is None:
        anchor = elastic_anchor(case, prec)
    g, geom, wav = case["grid"], case["geom"], case["wavelet"]
    rho = torch.as_tensor(case["models"]["start"]["rho"], device=dev)
    ovx, ovz = case["obs_full"]
    fc = c["freq_stages"][0]
    wav_fc = elastic.lowpass(wav, fc, g["dt"], -1)
    ox = elastic.trace_normalize(elastic.lowpass(ovx, fc, g["dt"], 1))
    oz = elastic.trace_normalize(elastic.lowpass(ovz, fc, g["dt"], 1))
    p = {k: v.detach().clone().requires_grad_() for k, v in
         case["weights"].items()}
    opt = Adam(p, c["beta1"], c["adam_eps"])
    opt.load(from_state or anchor["state_anchor"])
    out = {**anchor, "loss": []}
    if from_state is not None:
        out["w_anchor_from"] = _clone(p)
    if c["phase_reset_opt"]:
        opt = Adam(p, c["beta1"], c["adam_eps"])
    nz = case["true_m"].shape[1]
    z = torch.arange(nz, dtype=torch.float32, device=dev)[:, None]
    proc = ((z >= c["grad_taper_rows"]).to(torch.float32) * z ** 2
            * c["grad_scale"])
    for e in range(c["lstart"] + 1, c["lstart"] + steps + 1):
        m = _elastic_model(p, case, prec)
        if e == 1:
            out["mse1"] = float(torch.mean((m.detach() - case["true_m"]) ** 2))
        idx = case["draws"][e - 1]
        if fault == "half_shots":
            idx = idx[::2]
        leaf = m[0].detach().requires_grad_()
        with torch.enable_grad():
            px, pz = elastic.simulate(leaf[..., 0], leaf[..., 1], rho,
                                      wav_fc, _subset(geom, idx), g,
                                      gain_grad=False)
            loss = elastic.tnl1_misfit(px, pz, ox[idx.to(dev)],
                                       oz[idx.to(dev)])
            (gm,) = torch.autograd.grad(loss, leaf)
        gm = gm * proc[..., None]
        if fault == "grad_x2":
            gm = 2.0 * gm
        if c["tether_weight"] > 0:
            d = leaf.detach() - case["lowf"][0]
            g_rms = torch.sqrt(torch.mean(gm ** 2, dim=(0, 1), keepdim=True))
            d_rms = torch.sqrt(torch.mean(d ** 2, dim=(0, 1), keepdim=True))
            gm = gm + c["tether_weight"] * g_rms * d / (d_rms + 1e-20)
        with prec.switches(dev):
            grads = _grads(m[0], gm, p)
        out["loss"].append(float(loss.detach()))
        if e == c["lstart"] + 1:
            out["g1"] = _clone(grads)
        if c["step_cap"] > 0:
            _capped_step(p, opt, grads, c, case, prec, m.detach())
        else:
            opt.step(grads, c["lr"])
    out["w_end"] = _clone(p)
    return out


@torch.no_grad()
def _capped_step(p, opt, grads, c, case, prec, m_old):
    """Adam's step scaled so that the decoded model moves at most
    ``step_cap`` m/s RMS: with u the step and dm(s) the RMS of
    decode(w + s u) - m_old, s = min(1, cap / dm(1)), then s *= min(1,
    cap / dm(s)); Adam's moments advance unscaled."""
    old = _clone(p)
    opt.step(grads, c["lr"])
    upd = {k: p[k] - old[k] for k in p}

    def move(s):
        for k in p:
            p[k].copy_(old[k] + s * upd[k])
        return torch.sqrt(torch.mean((_elastic_model(p, case, prec)
                                      - m_old) ** 2))

    cap = c["step_cap"]
    s = torch.clamp(cap / (move(1.0) + 1e-20), max=1.0)
    s = s * torch.clamp(cap / (move(s) + 1e-20), max=1.0)
    for k in p:
        p[k].copy_(old[k] + s * upd[k])


@torch.no_grad()
def holdout_loss(case: dict, weights: dict, fc: float,
                 precision: str = "fp32", fault=None) -> float:
    """The held-out shots' misfit at ``weights``: the decode, the forward
    of the held-out shots at the band ``fc``, trace-normalized L1 of vx
    and vz (each a mean), summed.  ``fault="half_shots"`` takes every
    other held-out shot only."""
    g, dev = case["grid"], case["device"]
    m = _elastic_model(weights, case, generator.Precision(precision))[0]
    hold = case["hold"][::2] if fault == "half_shots" else case["hold"]
    wav_fc = elastic.lowpass(case["wavelet"], fc, g["dt"], -1)
    rho = torch.as_tensor(case["models"]["start"]["rho"], device=dev)
    px, pz = elastic.simulate(m[..., 0], m[..., 1], rho, wav_fc,
                              _subset(case["geom"], hold), g)
    ovx, ovz = case["obs_full"]
    h = hold.to(dev)
    ox = elastic.lowpass(ovx[h], fc, g["dt"], 1)
    oz = elastic.lowpass(ovz[h], fc, g["dt"], 1)
    tn = elastic.trace_normalize
    return float(torch.mean(torch.abs(tn(px) - tn(ox)))
                 + torch.mean(torch.abs(tn(pz) - tn(oz))))


def _deterministic():
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def anchor(case: dict, precision: str = "fp32") -> dict | None:
    """The elastic recipes' observed data and anchor epochs from the seed
    (:func:`elastic_anchor`); None for a recipe without them."""
    if case["config"]["physics"] == "acoustic" or not case["config"]["lstart"]:
        return None
    _deterministic()
    return elastic_anchor(case, generator.Precision(precision))


def run(case: dict, steps: int, precision: str = "fp32", fault=None,
        from_state=None, anchor=None) -> dict:
    """The reference's first ``steps`` physics steps of ``case`` (built by
    the harness from the seed: config, grid, geometry, wavelet, models,
    weights, architecture, device, the elastic draws), after the anchor
    epochs (``anchor``: :func:`anchor`'s result, run here when not
    given).  With ``from_state`` (weights, Adam moments and step count)
    the elastic physics steps start from that state in place of the
    anchor's."""
    prec = generator.Precision(precision)
    _deterministic()
    if case["config"]["physics"] == "acoustic":
        return acoustic_run(case, steps, prec, fault)
    return elastic_run(case, steps, prec, fault, from_state, anchor)


def move(obj, device):
    """``obj`` (tensors in dicts, lists and tuples) on ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: move(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(move(v, device) for v in obj)
    return obj


def release() -> None:
    """Drop the captured CUDA graphs (and their memory) of the reference's
    time loops."""
    acoustic.SCAN.graphs.clear()
    elastic.SCAN.graphs.clear()


def shift_one(traces):
    """``traces`` [shots, nt, receivers] one time step late (a planted
    fault of the observed data)."""
    out = torch.zeros_like(traces)
    out[:, 1:] = traces[:, :-1]
    return out


def leaf_gaps(a: dict, b: dict, keep=None) -> dict:
    """Per leaf |norm(a) - norm(b)| over the larger of norm(b) and the
    median leaf's norm(b) (the reference ``b``)."""
    nb = {k: float(torch.linalg.vector_norm(v.double())) for k, v in b.items()}
    med = sorted(nb.values())[len(nb) // 2]
    out = {}
    for k, v in a.items():
        if keep is not None and k not in keep:
            continue
        na = float(torch.linalg.vector_norm(v.double()))
        out[k] = abs(na - nb[k]) / max(nb[k], med, 1e-300)
    return out


def still_leaves(g1: dict, share: float = 1e-3) -> set:
    """Leaves whose reference gradient norm is under ``share`` of the
    median leaf's: moved by Adam's rounding alone, left out of the
    change's comparison."""
    n = {k: float(torch.linalg.vector_norm(v.double())) for k, v in g1.items()}
    med = sorted(n.values())[len(n) // 2]
    return {k for k, v in n.items() if v < share * med}


def worst(gaps: dict):
    """(largest gap, its leaf)."""
    if not gaps:
        return 0.0, None
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


def numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers of a program run ``prog`` against the
    reference ``ref`` (same keys as :func:`run`'s result, the program's
    first gradient worked out from its Adam state): the relative gap of
    each physics step's loss and of the model MSE of the first decode,
    and by the worst leaf the gaps of the first physics gradient's norm,
    of the weights' change over the compared steps (from where the
    reference's physics steps started) and over the anchor epochs."""
    out = {f"loss{k + 1}": rel(a, b)
           for k, (a, b) in enumerate(zip(prog["loss"], ref["loss"]))}
    out["mse1"] = rel(prog["mse1"], ref["mse1"])
    out["grad"] = worst(leaf_gaps(prog["g1"], ref["g1"]))[0]
    moving = set(ref["g1"]) - still_leaves(ref["g1"])
    base = ref.get("w_anchor_from", ref.get("w_anchor", ref["w0"]))
    pbase = prog.get("w_anchor_from", prog.get("w_anchor", prog["w0"]))
    out["change"] = worst(leaf_gaps(
        {k: prog["w_end"][k] - pbase[k] for k in moving},
        {k: ref["w_end"][k] - base[k] for k in moving}))[0]
    if "w_anchor" in ref:
        out["anchor"] = worst(leaf_gaps(
            {k: prog["w_anchor"][k] - prog["w0"][k] for k in moving},
            {k: ref["w_anchor"][k] - ref["w0"][k] for k in moving}))[0]
    return out


def obs_gap(prog_obs, ref_obs) -> float:
    """Largest |difference| of the observed traces over the reference's
    largest |amplitude|."""
    pairs = (zip(prog_obs, ref_obs) if isinstance(ref_obs, tuple)
             else [(prog_obs, ref_obs)])
    return max(float(torch.amax(torch.abs(a.to(b.device) - b))
                     / torch.amax(torch.abs(b))) for a, b in pairs)
