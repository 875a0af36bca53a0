"""The inputs of a cell, made from the run's seed and handed alike to the
program and to the plain reference: the Marmousi-like true model and its
smooth starting model (numpy), the source wavelet, the acquisition, the
generator's weights (on the device) and the elastic recipes' shot draws.

The models follow the repository's synthetic Marmousi-like recipe (8
random dipping layers under 26 water rows, a fault, a fast wedge); the
published Marmousi SEG-Y is not in the repository.  This file is a
frozen copy of that recipe: the program's own copy may change without
changing what the benchmark runs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SEED_MASK = (1 << 63) - 1


def seed_of(seed: int) -> int:
    """The run's seed as a non-negative 63-bit integer (numpy's and
    torch's generators take any such)."""
    return int(seed) & SEED_MASK


def layered_model(nz: int, nx: int, *, water_rows: int, seed: int,
                  n_layers: int = 8, v_top: float = 1500.0,
                  v_bottom: float = 4000.0) -> np.ndarray:
    """Random layered velocity model with lateral undulation."""
    rng = np.random.default_rng(seed)
    depths = np.sort(rng.uniform(water_rows, nz, n_layers))
    vels = np.linspace(v_top if water_rows == 0 else 1600.0, v_bottom,
                       n_layers + 1)
    x = np.arange(nx)
    model = np.full((nz, nx), vels[0], np.float32)
    for i, d in enumerate(depths):
        und = d + 5.0 * np.sin(2 * np.pi * x / nx * rng.integers(1, 4)
                               + rng.uniform(0, 2 * np.pi))
        mask = np.arange(nz)[:, None] >= und[None, :]
        model[mask] = vels[i + 1]
    if water_rows > 0:
        model[:water_rows] = 1500.0
    return model


def marmousi_like(nz: int, nx: int, *, seed: int,
                  water_rows: int) -> np.ndarray:
    """Water, dipping layers, a fault and a high-velocity wedge, clipped
    to [1500, 4700] m/s."""
    m = layered_model(nz, nx, water_rows=water_rows, seed=seed)
    f0 = int(nx * 0.45)
    shift = ((np.arange(nx) - f0) * 0.15).astype(int)
    for j in range(nx):
        if shift[j] > 0:
            m[:, j] = np.roll(m[:, j], min(shift[j], 10))
    m[:water_rows] = 1500.0
    zc, xc = int(nz * 0.6), int(nx * 0.55)
    z, x = np.mgrid[0:nz, 0:nx]
    m[(np.abs(z - zc) < 12) & (np.abs(x - xc) < 30)] += 250.0
    return np.clip(m, 1500.0, 4700.0).astype(np.float32)


def smooth(m: np.ndarray, iters: int = 40,
           preserve_rows: int = 0) -> np.ndarray:
    """The low-frequency starting model: 40 binomial passes per axis,
    the top ``preserve_rows`` rows kept."""
    s = m.astype(np.float32).copy()
    for _ in range(iters):
        s[1:-1, :] = 0.25 * s[2:, :] + 0.5 * s[1:-1, :] + 0.25 * s[:-2, :]
        s[:, 1:-1] = 0.25 * s[:, 2:] + 0.5 * s[:, 1:-1] + 0.25 * s[:, :-2]
    if preserve_rows > 0:
        s[:preserve_rows] = m[:preserve_rows]
    return s


def elastic_triple(vp: np.ndarray, *, water_rows: int, vpvs: float = 1.8):
    """(vp, vs, rho): vs = vp / 1.8, Gardner density, water rows fluid."""
    vs = (vp / vpvs).astype(np.float32)
    rho = (310.0 * vp ** 0.25).astype(np.float32)
    if water_rows > 0:
        vs[:water_rows] = 0.0
        rho[:water_rows] = 1000.0
    return vp.astype(np.float32), vs, rho


def ricker(freq: float, nt: int, dt: float, device="cpu") -> torch.Tensor:
    """Ricker wavelet [nt] in float32, peak at 1/freq."""
    t = torch.arange(nt, dtype=torch.float32, device=device) * dt - 1.0 / freq
    a = (math.pi * freq * t) ** 2
    return (1.0 - 2.0 * a) * torch.exp(-a)


def surface_line(num_shots: int, num_receivers: int, nx: int) -> dict:
    """Sources evenly along the surface row, one receiver spread on it."""
    src_x = np.round(np.linspace(0, nx - 1, num_shots)).astype(np.int64)
    rx = (np.arange(num_receivers) * (nx / num_receivers)).astype(np.int64)
    return {"src_z": np.zeros(num_shots, np.int64), "src_x": src_x,
            "rcv_z": np.zeros((num_shots, num_receivers), np.int64),
            "rcv_x": np.tile(rx, (num_shots, 1))}


def seabed_line(num_shots: int, num_receivers: int, nx: int, nz: int, *,
                row: int, src_x0: int = 2) -> dict:
    """Sources and receivers on the row below the water column."""
    src_x = np.round(np.linspace(src_x0, nx - 1 - src_x0,
                                 num_shots)).astype(np.int64)
    rx = np.round(np.linspace(1, nx - 2, num_receivers)).astype(np.int64)
    r = min(row, nz - 2)
    return {"src_z": np.full(num_shots, r, np.int64), "src_x": src_x,
            "rcv_z": np.full((num_shots, num_receivers), r, np.int64),
            "rcv_x": np.tile(rx, (num_shots, 1))}


def acquisition(size: dict) -> dict:
    """The configuration's acquisition, by its ``acquisition`` key."""
    if size["acquisition"] == "surface_line":
        return surface_line(size["num_shots"], size["num_receivers"],
                            size["nx"])
    return seabed_line(size["num_shots"], size["num_receivers"], size["nx"],
                       size["nz"], row=size["water_rows"] + 1)


def models(size: dict, seed: int) -> dict:
    """The true and starting models of a configuration, numpy float32:
    {"true": {field: [nz, nx]}, "start": {...}}."""
    vp = marmousi_like(size["nz"], size["nx"], seed=seed,
                       water_rows=size["water_rows"])
    if size["physics"] == "acoustic":
        true = {"vp": vp}
    else:
        true = dict(zip(("vp", "vs", "rho"),
                        elastic_triple(vp, water_rows=size["water_rows"])))
    start = {k: smooth(v, preserve_rows=size["water_rows"])
             for k, v in true.items()}
    return {"true": true, "start": start}


def holdout_split(n_shots: int, holdout: int):
    """(held-out shots, training pool) as int64 tensors: ``min(holdout,
    n_shots - 1)`` evenly spaced interior shots held out (numpy rounds
    half to even: 35 shots hold out 8, 17 and 26), the rest the pool."""
    if holdout <= 0:
        return None, torch.arange(n_shots)
    k = min(holdout, max(n_shots - 1, 1))
    hold = np.unique(np.round(np.linspace(0, n_shots - 1, k + 2)[1:-1])
                     .astype(np.int64))
    return (torch.as_tensor(hold),
            torch.as_tensor(np.setdiff1d(np.arange(n_shots), hold)))


def shot_draws(seed: int, epochs: int, pool: torch.Tensor,
               nsub: int) -> list:
    """The elastic recipes' shot subsets of epochs 1..``epochs``: each
    epoch the pool's shots at the first ``nsub`` of a permutation of the
    pool, from a CPU ``torch.Generator`` seeded ``seed + 7`` (the draw the
    elastic engine documents)."""
    gen = torch.Generator().manual_seed(seed + 7)
    return [pool[torch.randperm(len(pool), generator=gen)[:nsub]]
            for _ in range(epochs)]


def weights(spec: list, seed: int, device) -> dict:
    """The generator's weights by name, from ``spec`` [(name, shape, kind,
    fan_in)], made on ``device`` in one draw: every kernel a slice of one
    truncated normal (on [-2, 2] std units) scaled to variance 1/fan_in
    (lecun normal), biases 0, norm scales 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = sum(math.prod(shape) for _, shape, kind, _ in spec if kind == "kernel")
    flat = torch.empty(n, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out, at = {}, 0
    for name, shape, kind, fan_in in spec:
        if kind == "kernel":
            k = math.prod(shape)
            out[name] = (flat[at: at + k].reshape(shape)
                         * (math.sqrt(1.0 / fan_in) / 0.87962566103423978))
            at += k
        elif kind == "scale":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
