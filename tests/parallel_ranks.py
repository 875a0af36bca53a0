"""The rank side of the multi-rank tests (not collected).

:func:`run_check` runs on every rank of a process group that
``parallel.dryrun.spawn`` made: it reads its inputs from an npz, runs
one function of ``parallel/`` (or an engine under a mesh) on a mesh of
the whole group, and writes this rank's outputs to
``<out_dir>/rank<r>.npz``.  The tests hold them to a reference: the JAX
package's sharded function (or engine) at the same mesh size on the
same inputs, or the engine without a mesh.  Scalars and configs travel
as Python literals (``repr`` of a dict) in 0-d string arrays.

The spawned ranks import this module by name (``spawn`` hands them the
test process's ``sys.path``), so it imports the port and nothing of JAX.
"""

from __future__ import annotations

import ast
import os

import numpy as np
import torch
import torch.distributed as dist


def _lit(z, key):
    return ast.literal_eval(str(z[key]))


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=device)


def _acoustic_cfg(z):
    from physicsbasedfwi2_tpu_torch.geo import Grid2D
    from physicsbasedfwi2_tpu_torch.ops import AcousticConfig
    return AcousticConfig(grid=Grid2D(**_lit(z, "grid")), **_lit(z, "cfg"))


def _geom(z, dev):
    return tuple(_t(z[k], dev) for k in ("src_z", "src_x", "rcv_z", "rcv_x"))


def _acoustic(z, device):
    from physicsbasedfwi2_tpu_torch.parallel import (
        make_mesh, shot_sharded_acoustic_gradient)
    mesh = make_mesh(device=device)
    dev = mesh.device
    loss, g = shot_sharded_acoustic_gradient(
        mesh, _t(z["vp"], dev), _t(z["obs_norm"], dev), _t(z["wav"], dev),
        *_geom(z, dev), _acoustic_cfg(z), misfit=str(z["misfit"]),
        shot_mask=_t(z["mask"], dev) if "mask" in z else None,
        direct=_t(z["direct"], dev) if "direct" in z else None)
    return {"loss": loss, "grad": g}


def _sample_shot(z, device):
    from physicsbasedfwi2_tpu_torch.parallel import (
        all_gather, make_mesh2d, sample_shot_sharded_acoustic_gradient)
    mesh = make_mesh2d(*_lit(z, "mesh"), device=device)
    dev = mesh.device
    loss, g = sample_shot_sharded_acoustic_gradient(
        mesh, _t(z["vps"], dev), _t(z["obs_norm"], dev), _t(z["wav"], dev),
        *_geom(z, dev), _acoustic_cfg(z), misfit=str(z["misfit"]),
        direct=_t(z["direct"], dev) if "direct" in z else None)
    return {"loss": loss, "grad": all_gather(g, mesh, "sample")}


def _elastic(z, device):
    from physicsbasedfwi2_tpu_torch.geo import Grid2D
    from physicsbasedfwi2_tpu_torch.ops.elastic import ElasticConfig
    from physicsbasedfwi2_tpu_torch.parallel import (
        make_mesh, shot_sharded_elastic_gradient)
    mesh = make_mesh(device=device)
    dev = mesh.device
    cfg = ElasticConfig(grid=Grid2D(**_lit(z, "grid")), **_lit(z, "cfg"))
    loss, grads = shot_sharded_elastic_gradient(
        mesh, *(_t(z[k], dev) for k in ("vp", "vs", "rho", "obs_vx",
                                        "obs_vz", "wav")),
        *_geom(z, dev), cfg, wrt=("vp", "vs"))
    return {"loss": loss, "grad_vp": grads["vp"], "grad_vs": grads["vs"]}


def _fused(z, device):
    from physicsbasedfwi2_tpu_torch.parallel import (
        make_mesh, shot_sharded_fused_acoustic_gradient)
    mesh = make_mesh(device=device)
    dev = mesh.device
    loss, g = shot_sharded_fused_acoustic_gradient(
        mesh, _t(z["vp"], dev), _t(z["wav"], dev), *_geom(z, dev),
        _acoustic_cfg(z), _t(z["obs_rows"], dev), _t(z["dir_rows"], dev),
        KC=int(z["KC"]))
    return {"loss": loss, "grad": g}


def _halo(z, device):
    from physicsbasedfwi2_tpu_torch.parallel import (
        make_mesh, simulate_acoustic_dd)
    mesh = make_mesh(device=device)
    dev = mesh.device
    rec = simulate_acoustic_dd(_t(z["vp"], dev), _t(z["wav"], dev),
                               *_geom(z, dev), _acoustic_cfg(z), mesh)
    return {"rec": rec}


def _halo_grad(z, device):
    """The halo decomposition's value and gradient: the loss ``sum(rec *
    w)`` (every rank the same) and, after its backward, dJ/dvp and
    dJ/dwavelet, which every rank must hold whole."""
    from physicsbasedfwi2_tpu_torch.parallel import (
        make_mesh, simulate_acoustic_dd)
    mesh = make_mesh(device=device)
    dev = mesh.device
    vp = _t(z["vp"], dev).requires_grad_()
    wav = _t(z["wav"], dev).requires_grad_()
    rec = simulate_acoustic_dd(vp, wav, *_geom(z, dev), _acoustic_cfg(z),
                               mesh)
    loss = (rec * _t(z["w"], dev)).sum()
    loss.backward()
    return {"rec": rec, "loss": loss, "grad_vp": vp.grad,
            "grad_wav": wav.grad}


def _surface(z, device):
    """The misfit surface of a velocity model ``params = {"vp": ...}``
    along the given directions: the trace-normalized L2 of
    :func:`simulate_acoustic` against ``obs_norm``."""
    from physicsbasedfwi2_tpu_torch.landscape import loss_surface_2d_sharded
    from physicsbasedfwi2_tpu_torch.ops import (
        simulate_acoustic, trace_normalize)
    from physicsbasedfwi2_tpu_torch.parallel import make_mesh
    mesh = make_mesh(device=device)
    dev = mesh.device
    cfg, wav, geom = _acoustic_cfg(z), _t(z["wav"], dev), _geom(z, dev)

    def loss_fn(p, data):
        pred = trace_normalize(simulate_acoustic(p["vp"], wav, *geom, cfg))
        return torch.mean((pred - data) ** 2)

    surf, _, _ = loss_surface_2d_sharded(
        loss_fn, {"vp": _t(z["vp"], dev)}, mesh, d1={"vp": _t(z["d1"], dev)},
        d2={"vp": _t(z["d2"], dev)}, xs=z["xs"], ys=z["ys"],
        data=_t(z["obs_norm"], dev))
    return {"losses": surf}


def engine_step(engine, epochs: int = 1) -> dict:
    """``epochs`` steps of ``engine`` from epoch 1: each step's record
    (``loss_*`` as ``rec<i>_<key>``), then the generator's weights and
    last gradients as flat float64 vectors (``weights``, ``grads``) in
    the order of ``names`` (``net.named_parameters()``)."""
    out = {}
    for e in range(1, epochs + 1):
        rec = engine.optimize_parameters(e)
        out.update({f"rec{e}_{k}": v for k, v in rec.items()
                    if k.startswith("loss")})
    names, params = zip(*engine.net.named_parameters())
    out["names"] = np.array(names)
    out["weights"] = torch.cat([p.detach().flatten().double().cpu()
                                for p in params])
    out["grads"] = torch.cat([p.grad.flatten().double().cpu()
                              for p in params])
    return out


def _engine(z, device):
    """One step of the engine that ``cfg.engine`` names, built from the
    workload ``z["workload"]`` with the overrides ``z["overrides"]``, on
    a mesh of the whole group (a {sample, shot} mesh of ``z["mesh"]`` for
    the multi-sample engine).  With ``z["payload"]``, the path of a
    ``torch.save``d (workload, state dict) pair, the engine takes that
    workload and those weights."""
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.engines import create_engine
    from physicsbasedfwi2_tpu_torch.parallel import make_mesh, make_mesh2d
    cfg = get_workload(str(z["workload"]), **_lit(z, "overrides"))
    mesh = (make_mesh2d(*_lit(z, "mesh"), device=device) if "mesh" in z
            else make_mesh(device=device))
    if "payload" in z:
        wl, state = torch.load(str(z["payload"]), weights_only=False)
        eng = create_engine(cfg, workload=wl, mesh=mesh)
        eng.net.load_state_dict(state)
    else:
        eng = create_engine(cfg, mesh=mesh)
    return {"physics_path": np.array(eng.physics_path),
            "device": np.array(str(eng.device)), **engine_step(eng)}


def _train(z, device):
    """``train()`` of the engine of :func:`_engine`'s inputs for
    ``z["epochs"]`` epochs on a mesh of the whole group: the history's
    losses, and the files each rank finds under the run's directory."""
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.engines import create_engine
    from physicsbasedfwi2_tpu_torch.engine.train import train
    from physicsbasedfwi2_tpu_torch.parallel import make_mesh
    cfg = get_workload(str(z["workload"]), **_lit(z, "overrides"))
    eng = create_engine(cfg, mesh=make_mesh(device=device))
    _, hist = train(cfg, engine=eng, epochs=int(z["epochs"]), quiet=True)
    run_dir = os.path.join(cfg.save_dir, cfg.name)
    dist.barrier()
    return {"losses": np.array([r["loss_D"] for r in hist]),
            "files": np.array(sorted(os.listdir(run_dir)))}


_CHECKS = {"acoustic": _acoustic, "sample_shot": _sample_shot,
           "elastic": _elastic, "fused": _fused, "halo": _halo,
           "halo_grad": _halo_grad,
           "surface": _surface, "engine": _engine, "train": _train}


def run_check(name: str, in_path: str, out_dir: str,
              device: str = "cpu") -> None:
    """On every rank: the check ``name`` on the npz ``in_path``; this
    rank's outputs to ``out_dir/rank<r>.npz`` (tensors as numpy)."""
    with np.load(in_path) as f:
        z = {k: f[k] for k in f.files}
    out = _CHECKS[name](z, device)
    arrays = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v)) for k, v in out.items()}
    np.savez(os.path.join(out_dir, f"rank{dist.get_rank()}.npz"), **arrays)
