"""Synthetic acoustic and elastic workloads (port of
``physicsbasedfwi2_tpu/data/synthetic.py``).

The velocity models are numpy (copied as they are, so both packages
make the same model from a seed); the observed gathers come from
:func:`simulate_acoustic` (or, with ``backend="pallas"``, kernel B5
:func:`acoustic_forward_pallas`) / :func:`simulate_elastic` on the
requested device, by default the first CUDA card.  The ``*_from_disk``
builders read the reference's npy contracts (``npy_datasets``) instead,
and ``write_npy_tree``/``write_elastic_npy_tree`` write a workload out
in them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from physicsbasedfwi2_tpu_torch.device import default_device
from physicsbasedfwi2_tpu_torch.geo import (
    Grid2D, check_cfl, elastic_line, ricker, seabed_rows, surface_line,
)
from physicsbasedfwi2_tpu_torch.geo.acquisition import Acquisition
from physicsbasedfwi2_tpu_torch.ops import (
    AcousticConfig, simulate_acoustic, trace_normalize,
)
from physicsbasedfwi2_tpu_torch.ops.elastic import (
    ElasticConfig, simulate_elastic,
)
from physicsbasedfwi2_tpu_torch.ops.kernels import acoustic_forward_pallas


def make_layered_model(nz: int, nx: int, *, v_top=1500.0, v_bottom=4000.0,
                       water_rows: int = 0, seed: int = 0,
                       n_layers: int = 8) -> np.ndarray:
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


def make_marmousi_like(nz: int = 151, nx: int = 200, *, seed: int = 0,
                       water_rows: int = 26) -> np.ndarray:
    """Marmousi-flavoured model: water, dipping layers, a fault and a
    high-velocity wedge."""
    m = make_layered_model(nz, nx, water_rows=water_rows, seed=seed)
    # dipping fault: shift columns progressively
    f0 = int(nx * 0.45)
    shift = ((np.arange(nx) - f0) * 0.15).astype(int)
    for j in range(nx):
        if shift[j] > 0:
            m[:, j] = np.roll(m[:, j], min(shift[j], 10))
    m[:water_rows] = 1500.0
    # wedge anomaly
    zc, xc = int(nz * 0.6), int(nx * 0.55)
    z, x = np.mgrid[0:nz, 0:nx]
    wedge = (np.abs(z - zc) < 12) & (np.abs(x - xc) < 30)
    m[wedge] += 250.0
    return np.clip(m, 1500.0, 4700.0).astype(np.float32)


def smooth_model(m: np.ndarray, iters: int = 40,
                 preserve_rows: int = 0) -> np.ndarray:
    """Heavy smoothing -> the low-frequency starting model."""
    s = m.astype(np.float32).copy()
    for _ in range(iters):
        s[1:-1, :] = 0.25 * s[2:, :] + 0.5 * s[1:-1, :] + 0.25 * s[:-2, :]
        s[:, 1:-1] = 0.25 * s[:, 2:] + 0.5 * s[:, 1:-1] + 0.25 * s[:, :-2]
    if preserve_rows > 0:
        s[:preserve_rows] = m[:preserve_rows]
    return s


def make_elastic_model(vp: np.ndarray, *, vpvs: float = 1.8,
                       water_rows: int = 0):
    """(vp, vs, rho) from vp via vp/vs ratio and Gardner density."""
    vs = (vp / vpvs).astype(np.float32)
    rho = (310.0 * vp ** 0.25).astype(np.float32)  # Gardner
    if water_rows > 0:
        vs[:water_rows] = 0.0
        rho[:water_rows] = 1000.0
    return vp.astype(np.float32), vs, rho


@dataclasses.dataclass
class SyntheticAcousticWorkload:
    """In-memory equivalent of the unalignedVelABCD2 npy tree:
    A = observed gathers, B = true model, C = smooth start model.
    Tensors live on one device; ``acq`` stays numpy."""

    grid: Grid2D
    cfg: AcousticConfig
    acq: Acquisition
    wavelet: torch.Tensor
    vp_true: torch.Tensor     # B
    vp_start: torch.Tensor    # C
    obs: torch.Tensor         # A  [ns, nt, nr]
    obs_norm: torch.Tensor
    from_disk: bool = False   # True: obs is real stored data, not
                              # regenerable by our operators

    @classmethod
    def build(cls, *, nz=151, nx=200, dx=10.0, nt=4001, dt=0.001,
              pml_width=20, freq=8.0, num_shots=18, num_receivers=200,
              seed=0, water_rows=26, chunk=64, backend="xla",
              device: torch.device | str | None = None):
        """``backend="pallas"`` makes the observed data with kernel B5
        (its plain version on the CPU), any other value with
        :func:`simulate_acoustic`.  ``device=None`` is
        :func:`default_device` (the card; raises without one)."""
        if device is None:
            device = default_device()
        grid = Grid2D(nz=nz, nx=nx, dx=dx, nt=nt, dt=dt,
                      pml_width=pml_width)
        cfg = AcousticConfig(grid=grid, chunk=chunk, vmax_pml=5000.0)
        wav = ricker(freq, nt, dt, device=device)
        acq = surface_line(num_shots, num_receivers, nx,
                           src_depth=0, rcv_depth=0)
        vp_np = make_marmousi_like(nz, nx, seed=seed, water_rows=water_rows)
        check_cfl(float(vp_np.max()), grid)
        vp_true = torch.as_tensor(vp_np, device=device)
        vp_start = torch.as_tensor(
            smooth_model(vp_np, preserve_rows=water_rows), device=device)
        wl = cls(grid=grid, cfg=cfg, acq=acq, wavelet=wav, vp_true=vp_true,
                 vp_start=vp_start, obs=None, obs_norm=None)
        sim = (acoustic_forward_pallas if backend == "pallas"
               else simulate_acoustic)
        with torch.no_grad():
            wl.obs = sim(vp_true, wav, *wl.geom, cfg)
        wl.obs_norm = trace_normalize(wl.obs)
        return wl

    @property
    def device(self) -> torch.device:
        return self.vp_true.device

    @property
    def geom(self):
        """(src_z, src_x, rcv_z, rcv_x) as int32 tensors on the
        workload's device."""
        return tuple(torch.as_tensor(a, dtype=torch.int32,
                                     device=self.device)
                     for a in (self.acq.src_z, self.acq.src_x,
                               self.acq.rcv_z, self.acq.rcv_x))


@dataclasses.dataclass
class SyntheticElasticWorkload:
    """In-memory equivalent of unalignedVelABCDEl: A/D = vx/vz
    gathers, B = (vp, vs, rho) true, C = smooth low-frequency start.
    Tensors live on one device; ``acq`` stays numpy."""

    grid: Grid2D
    cfg: ElasticConfig
    acq: Acquisition
    wavelet: torch.Tensor
    true: dict               # {"vp","vs","rho"}
    start: dict
    obs_vx: torch.Tensor
    obs_vz: torch.Tensor
    from_disk: bool = False

    @classmethod
    def build(cls, *, nz=100, nx=300, dx=20.0, nt=1667, dt=0.0015,
              pml_width=20, freq=10.0, num_shots=35, num_receivers=298,
              seed=0, water_rows=26, chunk=64, free_surface=True,
              src_depth_row=None, rcv_depth_row=None,
              rcv_follow_seabed=False,
              device: torch.device | str | None = None):
        """src_depth_row / rcv_depth_row: explicit acquisition rows
        (default water_rows + 1, the just-below-seabed line);
        rcv_follow_seabed: per-column receiver depths from the water
        bottom.  ``device=None`` is :func:`default_device` (the card;
        raises without one)."""
        if device is None:
            device = default_device()
        grid = Grid2D(nz=nz, nx=nx, dx=dx, nt=nt, dt=dt,
                      pml_width=pml_width, free_surface=free_surface)
        cfg = ElasticConfig(grid=grid, chunk=chunk, vmax_pml=5000.0)
        wav = ricker(freq, nt, dt, device=device)
        vp = make_marmousi_like(nz, nx, seed=seed, water_rows=water_rows)
        check_cfl(float(vp.max()), grid)
        vp_t, vs_t, rho_t = make_elastic_model(vp, water_rows=water_rows)
        vp_s = smooth_model(vp_t, preserve_rows=water_rows)
        vs_s = smooth_model(vs_t, preserve_rows=water_rows)
        rho_s = smooth_model(rho_t, preserve_rows=water_rows)
        src_row = (src_depth_row if src_depth_row is not None
                   else water_rows + 1)
        rcv_row = (rcv_depth_row if rcv_depth_row is not None
                   else water_rows + 1)
        acq = elastic_line(
            num_shots, num_receivers, nx, nz, src_row=src_row,
            rcv_row=rcv_row,
            rcv_rows_per_col=(seabed_rows(vp_t)
                              if rcv_follow_seabed else None))

        def dev(a):
            return torch.as_tensor(a, device=device)

        wl = cls(grid=grid, cfg=cfg, acq=acq, wavelet=wav,
                 true={"vp": dev(vp_t), "vs": dev(vs_t), "rho": dev(rho_t)},
                 start={"vp": dev(vp_s), "vs": dev(vs_s),
                        "rho": dev(rho_s)},
                 obs_vx=None, obs_vz=None)
        with torch.no_grad():
            wl.obs_vx, wl.obs_vz = simulate_elastic(
                wl.true["vp"], wl.true["vs"], wl.true["rho"], wav, *wl.geom,
                cfg)
        return wl

    @property
    def device(self) -> torch.device:
        return self.true["vp"].device

    @property
    def geom(self):
        """(src_z, src_x, rcv_z, rcv_x) as int32 tensors on the
        workload's device."""
        return tuple(torch.as_tensor(a, dtype=torch.int32,
                                     device=self.device)
                     for a in (self.acq.src_z, self.acq.src_x,
                               self.acq.rcv_z, self.acq.rcv_x))


def acoustic_workload_from_disk(dataroot: str, *, nz, nx, dx, nt, dt,
                                pml_width=20, freq=8.0, num_shots=None,
                                num_receivers=None, chunk=64,
                                phase: str = "train",
                                wavelet_from_data: bool = False,
                                device: torch.device | str | None = None):
    """Build an acoustic workload from the reference's on-disk npy
    contract (trainA = gathers [ns, nt, nr], trainB = true model,
    trainC = low-frequency start model) so datasets prepared for the
    reference train unchanged here; the tensors on ``device`` (the first
    CUDA card by default).

    wavelet_from_data: take the per-shot source wavelets from trainD
    (the AutoWav capability, networks.py:13163-13165:
    ``source_amplitudes_true = swapaxes(wav, 0, 2)`` from the data
    dict) instead of a synthetic Ricker."""
    from physicsbasedfwi2_tpu_torch.data.npy_datasets import NpyDictDataset
    if device is None:
        device = default_device()
    ds = NpyDictDataset(dataroot, "unalignedVelABCD2", phase=phase)
    item = ds[0]

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    obs = dev(item["A"])
    vp_true = dev(item["B"]).reshape(nz, nx)
    vp_start = dev(item.get("C", item["B"])).reshape(nz, nx)
    ns, nt_d, nr = obs.shape
    if num_shots is None:
        num_shots = ns
    if num_receivers is None:
        num_receivers = nr
    assert nt_d == nt, f"data nt {nt_d} != config nt {nt}"
    grid = Grid2D(nz=nz, nx=nx, dx=dx, nt=nt, dt=dt,
                  pml_width=pml_width)
    cfg = AcousticConfig(grid=grid, chunk=chunk, vmax_pml=5000.0)
    if wavelet_from_data and "D" in item:
        wav = dev(item["D"]).reshape(num_shots, nt)
    else:
        wav = ricker(freq, nt, dt, device=device)
    acq = surface_line(num_shots, num_receivers, nx, src_depth=0,
                       rcv_depth=0)
    return SyntheticAcousticWorkload(
        grid=grid, cfg=cfg, acq=acq, wavelet=wav, vp_true=vp_true,
        vp_start=vp_start, obs=obs, obs_norm=trace_normalize(obs),
        from_disk=True)


def latent_workload_from_disk(dataroot: str, *, nz, nx, dx, nt, dt,
                              pml_width=20, freq=15.0, num_shots=None,
                              num_receivers=None, chunk=64,
                              phase: str = "train", sample: int = 0,
                              device: torch.device | str | None = None):
    """Acoustic workload from the reference's Latent2 contract
    (unalignedVelLatent2_dataset.py: trainA = shot gathers, scaled x10
    by the mode; trainB = velocity model; the latent-inversion workload
    of VaeLatent2NoPhy_model.py:395-560 — 10 shots, nt=800, dt=1.5 ms,
    15 Hz).  ``sample`` picks one of the many stored samples (the
    reference ran batch 64 over them; latent inversion here optimizes
    one sample's latent at a time).  Tensors on ``device`` (the first
    CUDA card by default)."""
    from physicsbasedfwi2_tpu_torch.data.npy_datasets import NpyDictDataset
    if device is None:
        device = default_device()
    ds = NpyDictDataset(dataroot, "unalignedVelLatent2", phase=phase)
    item = ds[sample]
    obs = torch.as_tensor(item["A"], dtype=torch.float32, device=device)
    vp_true = torch.as_tensor(item["B"], dtype=torch.float32,
                              device=device).reshape(nz, nx)
    ns, nt_d, nr = obs.shape
    num_shots = num_shots or ns
    num_receivers = num_receivers or nr
    assert nt_d == nt, f"data nt {nt_d} != config nt {nt}"
    grid = Grid2D(nz=nz, nx=nx, dx=dx, nt=nt, dt=dt,
                  pml_width=pml_width)
    cfg = AcousticConfig(grid=grid, chunk=chunk, vmax_pml=5000.0)
    wav = ricker(freq, nt, dt, device=device)
    acq = surface_line(num_shots, num_receivers, nx, src_depth=0,
                       rcv_depth=0)
    return SyntheticAcousticWorkload(
        grid=grid, cfg=cfg, acq=acq, wavelet=wav, vp_true=vp_true,
        vp_start=vp_true, obs=obs, obs_norm=trace_normalize(obs),
        from_disk=True)


def elastic_workload_from_disk(dataroot: str, *, nz, nx, dx, nt, dt,
                               pml_width=20, freq=10.0,
                               free_surface=True, chunk=64,
                               num_shots=None, num_receivers=None,
                               water_rows=26, phase: str = "train",
                               src_depth_row=None, rcv_depth_row=None,
                               rcv_follow_seabed=False,
                               device: torch.device | str | None = None):
    """Elastic workload from the unalignedVelABCDEl contract
    (A = vx gathers, B = [Vp;Vs;Rho]/100, C = low-freq triple /100,
    D = vz gathers — the /100 storage units are undone by the dataset
    mode's scale, data/unalignedVelABCDEl_dataset.py:84-87); tensors on
    ``device`` (the first CUDA card by default).

    trainB is OPTIONAL: field data (the AutoRealData workload, SU
    gathers ingested by ``prep --su-obs``) has no ground-truth
    model — the starting model (trainC) then doubles as the metric
    reference, so reported "model MSE" measures distance from the
    start, not inversion quality."""
    from physicsbasedfwi2_tpu_torch.data.npy_datasets import NpyDictDataset
    if device is None:
        device = default_device()
    ds = NpyDictDataset(dataroot, "unalignedVelABCDEl", phase=phase)
    item = ds[0]

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    ovx = dev(item["A"])
    ovz = dev(item["D"])
    c = item["C"].reshape(3, nz, nx)
    b = item["B"].reshape(3, nz, nx) if "B" in item else c
    ns, nt_d, nr = ovx.shape
    assert nt_d == nt, f"data nt {nt_d} != config nt {nt}"
    grid = Grid2D(nz=nz, nx=nx, dx=dx, nt=nt, dt=dt,
                  pml_width=pml_width, free_surface=free_surface)
    cfg = ElasticConfig(grid=grid, chunk=chunk, vmax_pml=5000.0)
    wav = ricker(freq, nt, dt, device=device)
    num_shots = num_shots or ns
    num_receivers = num_receivers or nr
    src_row = (src_depth_row if src_depth_row is not None
               else water_rows + 1)
    rcv_row = (rcv_depth_row if rcv_depth_row is not None
               else water_rows + 1)
    acq = elastic_line(
        num_shots, num_receivers, nx, nz, src_row=src_row,
        rcv_row=rcv_row,
        rcv_rows_per_col=(seabed_rows(b[0]) if rcv_follow_seabed
                          else None))
    return SyntheticElasticWorkload(
        grid=grid, cfg=cfg, acq=acq, wavelet=wav,
        true={"vp": dev(b[0]), "vs": dev(b[1]), "rho": dev(b[2])},
        start={"vp": dev(c[0]), "vs": dev(c[1]), "rho": dev(c[2])},
        obs_vx=ovx, obs_vz=ovz, from_disk=True)


def write_npy_tree(root: str, workload: SyntheticAcousticWorkload,
                   *, phase: str = "train",
                   write_wavelets: bool = False):
    """Materialize the reference's on-disk contract
    (<root>/<phase>A/0.npy etc.) from a workload.  write_wavelets adds
    <phase>D = per-shot source wavelets [ns, nt] (the AutoWav trainD
    contract, networks.py:13163)."""
    import os
    entries = [("A", workload.obs), ("B", workload.vp_true),
               ("C", workload.vp_start)]
    if write_wavelets:
        wav = workload.wavelet
        if wav.ndim == 1:
            wav = wav[None].expand(len(workload.acq.src_z), -1)
        entries.append(("D", wav))
    for letter, arr in entries:
        d = os.path.join(root, phase + letter)
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, "0.npy"), arr.cpu().numpy())


def write_elastic_npy_tree(root: str, wl: SyntheticElasticWorkload,
                           *, phase: str = "train"):
    """Materialize the elastic contract (stored /100, bottom-up order
    NOT applied — row 0 = surface as the loaders expect)."""
    import os

    def triple(fields):
        return np.stack([fields[k].cpu().numpy()
                         for k in ("vp", "vs", "rho")]) / 100.0

    for letter, arr in (("A", wl.obs_vx.cpu().numpy()), ("B", triple(wl.true)),
                        ("C", triple(wl.start)),
                        ("D", wl.obs_vz.cpu().numpy())):
        d = os.path.join(root, phase + letter)
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, "0.npy"), arr)
