"""Shot-sharded FWI gradients (port of
``physicsbasedfwi2_tpu/parallel/shard.py``).

The model is replicated, and every rank holds the whole acquisition (each
builds the same workload).  Each rank takes its contiguous block of the
shot axis, in the block order of JAX's ``P("shot")``, runs the
propagator, kernel or misfit on it, and one all-reduce of the detached
loss and gradient replaces ``psum``/``pmean``.  The shot axis must
divide by the mesh axis, as ``shard_map`` requires: pad it first
(:func:`pad_shots_to_multiple`, :func:`pad_shots_for_fused`).
"""

from __future__ import annotations

import torch

from physicsbasedfwi2_tpu_torch.ops.acoustic import (
    AcousticConfig, acoustic_gradient,
)
from physicsbasedfwi2_tpu_torch.ops.elastic import (
    ElasticConfig, simulate_elastic,
)
from physicsbasedfwi2_tpu_torch.parallel.mesh import Mesh, all_reduce


def shot_block(mesh: Mesh, axis: str, n: int) -> slice:
    """This rank's block of an axis of ``n`` along the mesh's ``axis``."""
    k = mesh.shape[axis]
    if n % k:
        raise ValueError(f"an axis of {n} does not divide by the mesh's "
                         f"{axis!r} axis ({k}): pad it first")
    b = n // k
    i = mesh.coords[axis]
    return slice(i * b, (i + 1) * b)


def pad_shots_to_multiple(arrays, n: int, pad_value=0):
    """Pad the leading (shot) axis of each tensor to a multiple of n.

    Returns (padded tensors, mask) where mask [padded ns] is 1.0 for the
    real shots (float32)."""
    ns = arrays[0].shape[0]
    pad = -(-ns // n) * n - ns
    out = [torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), pad_value)])
           for a in arrays]
    mask = torch.arange(ns + pad, device=arrays[0].device) < ns
    return out, mask.to(torch.float32)


def _abs(r: torch.Tensor) -> torch.Tensor:
    """|r| with the derivative 1 at 0, as ``jnp.abs`` differentiates."""
    return torch.where(r >= 0, r, -r)


def _normalized_residual(pred, obs, direct):
    """Direct wave removed, trace-normalized prediction minus ``obs``."""
    pred = pred - direct
    m = torch.amax(torch.abs(pred), dim=1, keepdim=True)
    return pred / (m + 1e-10) - obs


def shot_sharded_acoustic_gradient(mesh: Mesh, vp, obs_norm, wavelet,
                                   src_z, src_x, rcv_z, rcv_x,
                                   cfg: AcousticConfig, *,
                                   misfit: str = "l2", shot_mask=None,
                                   axis: str = "shot", direct=None):
    """(loss, dJ/dvp) with the shots sharded over ``axis``: autograd
    through :func:`simulate_acoustic` on this rank's shots, then one sum
    all-reduce, over the masked count.

    obs_norm: [ns, nt, nr] trace-normalized observed data.
    shot_mask: optional [ns] 0/1 weights (for padded shots).
    direct: optional [ns, nt, nr] direct-wave traces subtracted from the
        prediction before the normalization (networks.py:5467).
    ``wavelet`` is [nt], or [ns, nt] per shot."""
    ns, nt, nr = obs_norm.shape
    if shot_mask is None:
        shot_mask = torch.ones(ns, device=obs_norm.device)
    denom = torch.sum(shot_mask) * nt * nr
    blk = shot_block(mesh, axis, ns)
    wav = wavelet[blk] if wavelet.ndim == 2 else wavelet
    obs, mask = obs_norm[blk], shot_mask[blk][:, None, None]
    dirw = direct[blk] if direct is not None else torch.zeros_like(obs)

    def local_loss(pred):
        r = _normalized_residual(pred, obs, dirw)
        return torch.sum((_abs(r) if misfit == "l1" else r * r) * mask)

    loss, g = acoustic_gradient(vp, local_loss, wav, src_z[blk], src_x[blk],
                                rcv_z[blk], rcv_x[blk], cfg)
    return (all_reduce(loss, mesh, axis) / denom,
            all_reduce(g, mesh, axis) / denom)


def sample_shot_sharded_acoustic_gradient(
        mesh: Mesh, vps, obs_norm, wavelet, src_z, src_x, rcv_z, rcv_x,
        cfg: AcousticConfig, *, misfit: str = "l2",
        sample_axis: str = "sample", shot_axis: str = "shot", direct=None):
    """(loss, dJ/dvps block) over a 2-D {sample, shot} mesh: the
    reference's per-sample fan-out (Auto_model.py:185-199) composed with
    shot parallelism.

    vps: [B, nz, nx], one model per sample; obs_norm: [B, ns, nt, nr];
    direct: optional [ns, nt, nr] (the same for every sample).  The
    geometry is shared by the samples.  Returns the mean misfit over all
    samples and shots (summed over the whole mesh) and this rank's
    samples' gradients [B / n_sample, nz, nx] (summed over the shot
    axis): gather them over ``sample_axis`` for the whole batch."""
    B, ns, nt, nr = obs_norm.shape
    sb = shot_block(mesh, sample_axis, B)
    tb = shot_block(mesh, shot_axis, ns)
    dirw = (direct[tb] if direct is not None
            else torch.zeros_like(obs_norm[0, tb]))
    wav = wavelet[tb] if wavelet.ndim == 2 else wavelet
    geom = (src_z[tb], src_x[tb], rcv_z[tb], rcv_x[tb])
    loss = torch.zeros((), device=vps.device)
    grads = []
    for vp, obs in zip(vps[sb], obs_norm[sb, tb]):
        def local_loss(pred, obs=obs):
            r = _normalized_residual(pred, obs, dirw)
            return torch.sum(_abs(r) if misfit == "l1" else r * r)

        loss_s, g = acoustic_gradient(vp, local_loss, wav, *geom, cfg)
        loss = loss + loss_s
        grads.append(g)
    denom = B * ns * nt * nr
    return (all_reduce(loss, mesh) / denom,
            all_reduce(torch.stack(grads), mesh, shot_axis) / denom)


def pad_shots_for_fused(wavelet, src_z, src_x, rcv_z, rcv_x, obs_rows,
                        dir_rows, n: int):
    """Pad kernel B2's operands so that the shot axis divides by ``n``:
    a zero wavelet and zero observed and direct rows for the pad shots (a
    zero source predicts zero, which the kernel's trace normalization
    maps to 0, so a pad shot adds exactly zero loss and gradient); the
    geometry repeats shot 0.  Returns (padded tuple, ns_real, ns_pad)."""
    ns = int(src_z.shape[0])
    ns_pad = -(-ns // n) * n
    pad = ns_pad - ns
    if wavelet.ndim == 1:
        wavelet = wavelet[None].expand(ns, -1)
    if pad:
        def zeros(a):
            return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])

        def first(a):
            return torch.cat([a, a[:1].expand((pad,) + tuple(a.shape[1:]))])

        wavelet, obs_rows, dir_rows = map(zeros, (wavelet, obs_rows,
                                                  dir_rows))
        src_z, src_x, rcv_z, rcv_x = map(first, (src_z, src_x, rcv_z,
                                                 rcv_x))
    return (wavelet.contiguous(), src_z, src_x, rcv_z, rcv_x, obs_rows,
            dir_rows), ns, ns_pad


def shot_sharded_fused_acoustic_gradient(
        mesh: Mesh, vp, wavelet, src_z, src_x, rcv_z, rcv_x,
        cfg: AcousticConfig, obs_rows, dir_rows, *, axis: str = "shot",
        KC: int = 32):
    """(loss, dJ/dvp) of the fused trace-normalized L1 kernel B2
    (``ops/fwi_fused.py``: the kernel on a CUDA tensor, its plain version
    on the CPU) on this rank's shots, then a mean all-reduce.

    The operands must be padded to a multiple of the axis
    (:func:`pad_shots_for_fused`); each call normalizes by its own padded
    shot count, so multiply the pair by ns_pad / ns_real."""
    from physicsbasedfwi2_tpu_torch.ops.fwi_fused import fwi_l1_loss_grad
    blk = shot_block(mesh, axis, int(src_z.shape[0]))
    wav = wavelet[blk] if wavelet.ndim == 2 else wavelet
    loss, g = fwi_l1_loss_grad(vp, wav, src_z[blk], src_x[blk], rcv_z[blk],
                               rcv_x[blk], cfg, obs_rows[blk], dir_rows[blk],
                               KC=KC)
    return (all_reduce(loss, mesh, axis, mean=True),
            all_reduce(g, mesh, axis, mean=True))


def shot_sharded_elastic_gradient(mesh: Mesh, vp, vs, rho, obs_vx, obs_vz,
                                  wavelet, src_z, src_x, rcv_z, rcv_x,
                                  cfg: ElasticConfig, *, shot_mask=None,
                                  axis: str = "shot", wrt=("vp", "vs")):
    """(loss, {name: gradient}) of the raw L2 misfit of both components
    with the shots sharded: autograd through the split-PML
    :func:`simulate_elastic` on this rank's shots, then a sum
    all-reduce, over the masked count."""
    ns, nt, nr = obs_vx.shape
    if shot_mask is None:
        shot_mask = torch.ones(ns, device=obs_vx.device)
    denom = torch.sum(shot_mask) * nt * nr * 2
    blk = shot_block(mesh, axis, ns)
    wav = wavelet[blk] if wavelet.ndim == 2 else wavelet
    mask = shot_mask[blk][:, None, None]
    names = [k for k in ("vp", "vs", "rho") if k in wrt]
    with torch.enable_grad():
        fields = {k: v.detach().requires_grad_(k in names)
                  for k, v in (("vp", vp), ("vs", vs), ("rho", rho))}
        pvx, pvz = simulate_elastic(
            fields["vp"], fields["vs"], fields["rho"], wav, src_z[blk],
            src_x[blk], rcv_z[blk], rcv_x[blk], cfg)
        r = (pvx - obs_vx[blk]) ** 2 + (pvz - obs_vz[blk]) ** 2
        loss = torch.sum(r * mask)
        gs = torch.autograd.grad(loss, [fields[k] for k in names])
    return (all_reduce(loss, mesh, axis) / denom,
            {k: all_reduce(g, mesh, axis) / denom for k, g in zip(names, gs)})
