"""Multi-rank dry run: one sharded FWI step of each parallel layout
(port of ``physicsbasedfwi2_tpu/parallel/dryrun.py``), and the spawner
that starts ranks.

``python -m physicsbasedfwi2_tpu_torch.parallel.dryrun N [--device cpu]
[--backend gloo]`` starts N ranks on this host and runs, on every rank,
:func:`run` (one training step of a generator through the shot-sharded
physics gradient), :func:`run_mesh2d` (a {sample, shot} mesh gradient),
:func:`run_domain_decomp` (a halo-exchange forward) and
:func:`run_elastic_engine` (one ``ElasticDIPEngine`` step under a mesh),
at the JAX package's sizes.  On the card rank r takes
``cuda:{r % device_count}`` and the backend is NCCL, which takes one
rank a card: with more ranks than cards name ``--backend gloo``.
``--device cpu`` runs on gloo on the host.  The parallel layout replaces
the reference's Ray per-shot GPU fan-out (Auto_model.py:69-199) and
DENISE's MPI ranks (networks.py:7709-7710).
"""

from __future__ import annotations

import argparse
import math
import os
import shutil
import tempfile

import torch
import torch.distributed as dist


def spawn(fn, world: int, *args, device: str = "cuda",
          backend: str | None = None, store_dir=None) -> None:
    """Run ``fn(*args)`` on ``world`` new processes, the ranks of a new
    process group on a ``file://`` store under ``store_dir`` (default: a
    new temporary directory, removed after).  ``backend`` defaults to
    NCCL on the card and gloo on the CPU; it is the caller's choice and
    never changes after a failure.  ``fn`` must be importable by name (a
    module-level function).  Raises when a rank fails."""
    import torch.multiprocessing as mp
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"NCCL takes one rank a card: {world} ranks, "
                         f"{torch.cuda.device_count()} card(s); pass "
                         f"backend='gloo'")
    own = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="pbfwi_store_") if own else store_dir
    init = os.path.join(str(store_dir), f"store_{os.getpid()}_{world}")
    try:
        mp.spawn(_rank_main, args=(fn, world, device, backend, init, args),
                 nprocs=world, join=True)
    finally:
        if own:
            shutil.rmtree(store_dir, ignore_errors=True)
        elif os.path.exists(init):
            os.remove(init)


def _rank_main(rank, fn, world, device, backend, init, args):
    if device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    os.environ["LOCAL_RANK"] = str(rank)  # the ranks share this host
    dist.init_process_group(backend, init_method=f"file://{init}",
                            rank=rank, world_size=world)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def _acoustic_case(n_shots: int, device, nz=32, nx=48, nt=128, nr=24):
    from physicsbasedfwi2_tpu_torch.geo import Grid2D, ricker, surface_line
    from physicsbasedfwi2_tpu_torch.ops import AcousticConfig
    grid = Grid2D(nz=nz, nx=nx, dx=10.0, nt=nt, dt=0.002, pml_width=12)
    cfg = AcousticConfig(grid=grid, chunk=32, vmax_pml=3000.0)
    acq = surface_line(n_shots, nr, nx, src_depth=2, rcv_depth=2)
    geom = tuple(torch.as_tensor(a, device=device) for a in
                 (acq.src_z, acq.src_x, acq.rcv_z, acq.rcv_x))
    return cfg, ricker(10.0, nt, 0.002, device=device), geom


def run(n_devices: int, *, device=None) -> float:
    """One sharded training step: the generator replicated on every rank
    (its weights broadcast from rank 0), 2 shots a rank through
    :func:`shot_sharded_acoustic_gradient`, and one Adam step.  Returns
    the (finite) loss."""
    from physicsbasedfwi2_tpu_torch.engine.engines import _PhysicsLoss
    from physicsbasedfwi2_tpu_torch.models import (
        AutoEncoderNet, apply_velocity_output, pack_output)
    from physicsbasedfwi2_tpu_torch.ops import (
        simulate_acoustic, trace_normalize)
    from physicsbasedfwi2_tpu_torch.parallel import (
        broadcast_module, make_mesh, shot_sharded_acoustic_gradient)
    mesh = make_mesh(n_devices, device=device)
    dev = mesh.device
    ns, nz, nx, nt = 2 * n_devices, 32, 48, 128
    cfg, wav, geom = _acoustic_case(ns, dev)
    vp_true = torch.full((nz, nx), 1800.0, device=dev)
    vp_true[16:] = 2200.0
    with torch.no_grad():
        obs = simulate_acoustic(vp_true, wav, *geom, cfg)
    obs_norm = trace_normalize(obs)
    shots_in = obs.permute(1, 2, 0)[None].contiguous()
    net = AutoEncoderNet((nz, nx), (nt, obs.shape[2], ns), latent_dim=8,
                         filters=(4, 8, 16),
                         generator=torch.Generator().manual_seed(0)).to(dev)
    broadcast_module(net, mesh)
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    f01 = pack_output(net(shots_in)).field
    vp = apply_velocity_output(f01, vp_true[None, :, :, None])[0, :, :, 0]
    loss = _PhysicsLoss.apply(vp, lambda v: shot_sharded_acoustic_gradient(
        mesh, v, obs_norm, wav, *geom, cfg, misfit="l2"))
    opt.zero_grad()
    loss.backward()
    opt.step()
    loss = float(loss.detach())
    assert math.isfinite(loss), f"non-finite loss {loss}"
    return loss


def run_mesh2d(n_devices: int, *, device=None) -> float:
    """One gradient on a 2-D {sample, shot} mesh: the reference's
    batch_size and Ray per-sample fan-out (Auto_model.py:185-199)."""
    from physicsbasedfwi2_tpu_torch.ops import (
        simulate_acoustic, trace_normalize)
    from physicsbasedfwi2_tpu_torch.parallel import (
        all_gather, make_mesh2d, sample_shot_sharded_acoustic_gradient)
    n_sample = min(2, n_devices)
    n_shot = max(1, n_devices // n_sample)
    mesh = make_mesh2d(n_sample, n_shot, device=device)
    dev = mesh.device
    nz, nx = 32, 48
    cfg, wav, geom = _acoustic_case(2 * n_shot, dev)
    vps_true = torch.full((n_sample, nz, nx), 1800.0, device=dev)
    for i in range(n_sample):
        vps_true[i, 14 + 4 * i:] = 2200.0
    with torch.no_grad():
        obs = torch.stack([simulate_acoustic(v, wav, *geom, cfg)
                           for v in vps_true])
    obs_norm = trace_normalize(obs)
    vps0 = torch.full((n_sample, nz, nx), 1900.0, device=dev)
    loss, g = sample_shot_sharded_acoustic_gradient(
        mesh, vps0, obs_norm, wav, *geom, cfg, misfit="l2")
    g = all_gather(g, mesh, "sample")
    loss = float(loss.detach())
    assert math.isfinite(loss) and bool(torch.isfinite(g).all())
    assert g.shape == vps0.shape
    return loss


def run_domain_decomp(n_devices: int, *, device=None) -> float:
    """One forward on a laterally sharded grid with a halo exchange
    every step (parallel/halo.py): the DENISE domain decomposition
    (networks.py:7709-7710).  Returns the traces' energy."""
    from physicsbasedfwi2_tpu_torch.geo import Grid2D, ricker
    from physicsbasedfwi2_tpu_torch.ops import AcousticConfig
    from physicsbasedfwi2_tpu_torch.parallel import (
        make_mesh, simulate_acoustic_dd)
    mesh = make_mesh(n_devices, device=device)
    dev = mesh.device
    # the padded width (nx + 2 * pml) divides by the mesh
    nz, nx, nt = 32, max(24 * n_devices - 16, 32), 96
    grid = Grid2D(nz=nz, nx=nx, dx=10.0, nt=nt, dt=0.002, pml_width=8)
    cfg = AcousticConfig(grid=grid, chunk=32, vmax_pml=3000.0)
    wav = ricker(10.0, nt, 0.002, device=dev)
    i32 = torch.int32
    sz = torch.tensor([2], dtype=i32, device=dev)
    sx = torch.tensor([nx // 2], dtype=i32, device=dev)
    rz = torch.full((1, 8), 2, dtype=i32, device=dev)
    rx = torch.arange(4, nx - 4, (nx - 8) // 8, dtype=i32,
                      device=dev)[None, :8]
    vp = torch.full((nz, nx), 1800.0, device=dev)
    rec = simulate_acoustic_dd(vp, wav, sz, sx, rz, rx, cfg, mesh)
    s = float(torch.sum(rec ** 2))
    assert math.isfinite(s) and s > 0
    return s


def run_elastic_engine(n_devices: int, *, device=None,
                       save_dir: str | None = None) -> float:
    """One ``ElasticDIPEngine`` step with its shot subset fanned out over
    the mesh (DENISE's 30-rank gradient call, networks.py:7709-7710):
    the generator must move."""
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.engines import ElasticDIPEngine
    from physicsbasedfwi2_tpu_torch.parallel import make_mesh
    mesh = make_mesh(n_devices, device=device)
    cfg = get_workload(
        "marmousi_elastic", nz=24, nx=32, nt=120, dt=0.0015,
        num_shots=n_devices, shots_per_iter=n_devices, num_receivers=12,
        filters=(4, 8), chunk=20, water_rows=4, pml_width=8, lstart=0,
        freq=12.0, freq_stages=(),
        # the registered grad_taper_rows=27 would zero every row of this
        # 24-row grid, a no-op step that could not catch a broken
        # reduction; taper only the 4 water rows
        grad_taper_rows=4).replace(
            name="dryrun_elastic",
            save_dir=save_dir or os.path.join(tempfile.gettempdir(),
                                              "dryrun_el"))
    eng = ElasticDIPEngine(cfg, mesh=mesh, device=mesh.device)
    p0 = next(eng.net.parameters()).detach().clone()
    loss = eng.optimize_parameters(1)["loss_D_MSE"]
    assert math.isfinite(loss), f"non-finite elastic loss {loss}"
    # a reduction that zeroed the gradient would still print a finite
    # loss
    moved = float((next(eng.net.parameters()).detach() - p0).abs().max())
    assert moved > 0, "the sharded elastic step did not update the generator"
    return loss


def _dryrun_rank(n: int, device: str) -> None:
    dev = None if device == "cuda" else device
    lines = [
        f"one sharded FWI train step OK, loss={run(n, device=dev):.6e}",
        f"{{sample, shot}} 2D-mesh gradient OK, "
        f"loss={run_mesh2d(n, device=dev):.6e}",
        f"domain-decomposed forward (halo exchange) OK, "
        f"energy={run_domain_decomp(n, device=dev):.6e}",
        f"sharded elastic engine step OK, "
        f"loss={run_elastic_engine(n, device=dev):.6e}"]
    if dist.get_rank() == 0:
        for line in lines:
            print(f"dryrun_multichip({n}): {line}", flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m physicsbasedfwi2_tpu_torch.parallel.dryrun",
        description="one sharded step of each parallel layout on N ranks")
    p.add_argument("n", nargs="?", type=int, default=8,
                   help="ranks (default 8)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (rank r on card r %% count) or cpu (gloo)")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="default: nccl on the card, gloo on the cpu")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card is visible; pass --device cpu")
    spawn(_dryrun_rank, args.n, args.n, args.device, device=args.device,
          backend=args.backend)


if __name__ == "__main__":
    main()
