"""Shared helpers for the PyTorch-port parity tests (not collected).

Every parity test feeds the same numpy inputs, made from a seed, to a
JAX function and to its port, and compares the outputs as numpy.
"""

from __future__ import annotations

import contextlib
import os
import signal

import numpy as np
import torch

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def t(a, dtype=None) -> torch.Tensor:
    """numpy / JAX array -> CPU tensor (a copy)."""
    out = torch.tensor(np.asarray(a))
    return out if dtype is None else out.to(dtype)


def n(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def rel_max(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    got, ref = n(got), n(ref)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))


def rel_l2(got, ref) -> float:
    got, ref = n(got), n(ref)
    return float(np.linalg.norm(got - ref) / (np.linalg.norm(ref) + 1e-30))


@contextlib.contextmanager
def one_rank_mesh(tmp_path):
    """A mesh of this process alone: a gloo process group on a
    ``file://`` store under ``tmp_path``, destroyed on exit."""
    import torch.distributed as dist
    from physicsbasedfwi2_tpu_torch.parallel import make_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def deadline(seconds: float):
    """Raise ``TimeoutError`` in the main thread if the block runs past
    ``seconds`` (SIGALRM: the on-card tests' own time limit, where no
    timeout plugin is installed)."""
    def expire(signum, frame):
        raise TimeoutError(f"past its {seconds:g} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def golden(name: str):
    return np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))


def acoustic_case():
    """test_golden's ``_acoustic_case`` as numpy: (grid kwargs, cfg
    kwargs, wavelet args, vp, geometry)."""
    grid = dict(nz=36, nx=44, dx=10.0, nt=180, dt=0.002, pml_width=12)
    cfg = dict(chunk=20, vmax_pml=2500.0)
    geom = (np.array([3, 3], np.int32), np.array([10, 30], np.int32),
            np.full((2, 8), 3, np.int32),
            np.tile(np.arange(8, dtype=np.int32) * 5 + 2, (2, 1)))
    vp = np.full((36, 44), 1700.0, np.float32)
    vp[18:, :] = 2100.0
    return grid, cfg, (10.0, grid["nt"], grid["dt"]), vp, geom


def jax_acoustic(grid, cfg):
    from physicsbasedfwi2_tpu.geo import Grid2D
    from physicsbasedfwi2_tpu.ops import AcousticConfig
    return AcousticConfig(grid=Grid2D(**grid), **cfg)


def torch_acoustic(grid, cfg):
    from physicsbasedfwi2_tpu_torch.geo import Grid2D
    from physicsbasedfwi2_tpu_torch.ops import AcousticConfig
    return AcousticConfig(grid=Grid2D(**grid), **cfg)


def port_workload(jwl):
    """The port's SyntheticAcousticWorkload holding the same arrays as
    a JAX one (CPU tensors)."""
    from physicsbasedfwi2_tpu_torch.data.synthetic import (
        SyntheticAcousticWorkload)
    from physicsbasedfwi2_tpu_torch.geo.acquisition import Acquisition
    g = jwl.grid
    grid = dict(nz=g.nz, nx=g.nx, dx=g.dx, nt=g.nt, dt=g.dt,
                pml_width=g.pml_width, free_surface=g.free_surface)
    cfg = torch_acoustic(grid, dict(chunk=jwl.cfg.chunk,
                                    vmax_pml=jwl.cfg.vmax_pml))
    acq = Acquisition(*(np.asarray(a) for a in (
        jwl.acq.src_z, jwl.acq.src_x, jwl.acq.rcv_z, jwl.acq.rcv_x)))
    return SyntheticAcousticWorkload(
        grid=cfg.grid, cfg=cfg, acq=acq, wavelet=t(jwl.wavelet),
        vp_true=t(jwl.vp_true), vp_start=t(jwl.vp_start), obs=t(jwl.obs),
        obs_norm=t(jwl.obs_norm))


def elastic_case(free_surface: bool = True):
    """The JAX package's fused-elastic test case (tests/test_elastic.py,
    ``test_fused_elastic_kernel_matches_autodiff_interpret``) as numpy:
    (grid kwargs, cfg kwargs, wavelet args, (vp, vs, rho), geometry);
    ``free_surface=False`` absorbs at the top as well."""
    from physicsbasedfwi2_tpu_torch.data.synthetic import (
        make_elastic_model, make_marmousi_like)
    nz, nx, nt = 36, 48, 64
    grid = dict(nz=nz, nx=nx, dx=15.0, nt=nt, dt=0.0015, pml_width=8,
                free_surface=free_surface)
    cfg = dict(chunk=16, vmax_pml=4000.0)
    vp = make_marmousi_like(nz, nx, seed=0, water_rows=4)
    ns, nr = 2, 10
    geom = (np.array([5, 5], np.int32), np.array([10, 30], np.int32),
            np.full((ns, nr), 5, np.int32),
            np.tile(np.linspace(3, nx - 4, nr, dtype=np.int32), (ns, 1)))
    return (grid, cfg, (12.0, nt, 0.0015),
            make_elastic_model(vp, water_rows=4), geom)


def jax_elastic(grid, cfg):
    from physicsbasedfwi2_tpu.geo import Grid2D
    from physicsbasedfwi2_tpu.ops import ElasticConfig
    return ElasticConfig(grid=Grid2D(**grid), **cfg)


def torch_elastic(grid, cfg):
    from physicsbasedfwi2_tpu_torch.geo import Grid2D
    from physicsbasedfwi2_tpu_torch.ops.elastic import ElasticConfig
    return ElasticConfig(grid=Grid2D(**grid), **cfg)


def port_elastic_workload(jwl):
    """The port's SyntheticElasticWorkload holding the same arrays as a
    JAX one (CPU tensors)."""
    from physicsbasedfwi2_tpu_torch.data.synthetic import (
        SyntheticElasticWorkload)
    from physicsbasedfwi2_tpu_torch.geo.acquisition import Acquisition
    g = jwl.grid
    grid = dict(nz=g.nz, nx=g.nx, dx=g.dx, nt=g.nt, dt=g.dt,
                pml_width=g.pml_width, free_surface=g.free_surface)
    cfg = torch_elastic(grid, dict(chunk=jwl.cfg.chunk,
                                   vmax_pml=jwl.cfg.vmax_pml))
    acq = Acquisition(*(np.asarray(a) for a in (
        jwl.acq.src_z, jwl.acq.src_x, jwl.acq.rcv_z, jwl.acq.rcv_x)))
    return SyntheticElasticWorkload(
        grid=cfg.grid, cfg=cfg, acq=acq, wavelet=t(jwl.wavelet),
        true={k: t(v) for k, v in jwl.true.items()},
        start={k: t(v) for k, v in jwl.start.items()},
        obs_vx=t(jwl.obs_vx), obs_vz=t(jwl.obs_vz))
