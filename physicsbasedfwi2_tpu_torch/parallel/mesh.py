"""The rank mesh and its collectives (port of
``physicsbasedfwi2_tpu/parallel/mesh.py``).

JAX's ``shard_map`` is one controller over a device mesh; here every rank
is a process of its own, in a ``torch.distributed`` process group that
the caller made (``torchrun``, :func:`parallel.dryrun.spawn`).  A
:class:`Mesh` lays the group's ranks out on named axes as JAX's ``Mesh``
lays out devices, with one process group per axis: the ranks that share
this rank's coordinates on every other axis.

The collectives below take a mesh and an axis and return new tensors;
:func:`exchange`, :func:`gather_replicated` and :func:`shard_replicated`
are differentiable (the halo decomposition's gradient), the others
detach.
On the ``gloo`` backend a CUDA tensor goes through the host (a copy to
the CPU, the collective, a copy back): gloo's point-to-point operations
take CPU tensors only, and the same rule for every collective keeps the
path one.  NCCL takes the tensor where it is.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from physicsbasedfwi2_tpu_torch.device import default_device


class Mesh:
    """This rank's place in a mesh of ranks.

    ``shape`` maps each axis name to its size, in axis order (the
    engines read ``mesh.shape["shot"]`` as in the JAX package);
    ``coords`` maps each axis to this rank's index along it; ``groups``
    holds the process group of this rank's line along each axis and
    ``ranks`` its global ranks, in axis order; ``group`` is the whole
    mesh's group (None: the default group); ``device`` the rank's
    device."""

    def __init__(self, shape, rank, coords, groups, ranks, group, device):
        self.shape = dict(shape)
        self.rank = rank
        self.coords = dict(coords)
        self.groups = dict(groups)
        self.ranks = {k: list(v) for k, v in ranks.items()}
        self.group = group
        self.device = torch.device(device)

    @property
    def size(self) -> int:
        n = 1
        for k in self.shape.values():
            n *= k
        return n

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, rank={self.rank}, "
                f"coords={self.coords}, device={self.device})")


def _world() -> tuple[int, int]:
    if not dist.is_initialized():
        raise RuntimeError(
            "the mesh reads the default process group: call "
            "torch.distributed.init_process_group first (torchrun, or "
            "physicsbasedfwi2_tpu_torch.parallel.dryrun.spawn)")
    return dist.get_world_size(), dist.get_rank()


def _rank_device(device) -> torch.device:
    """The rank's device: ``device``, else the card of its local rank
    (``LOCAL_RANK``, else the global rank, modulo the cards visible),
    made current.  Without ``device`` and a visible card it raises, as
    :func:`default_device` does: the CPU only when the caller asks."""
    if device is None:
        device = default_device().type
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def _group(ranks: list[int], world: int):
    """The default group for every rank, else a new group (every rank of
    the default group must call this, in the same order)."""
    return None if len(ranks) == world else dist.new_group(ranks)


def make_mesh(n_devices: int | None = None, axis_name: str = "shot", *,
              device=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` ranks (all by default) on
    the FWI shot axis: the reference fans shots out over Ray GPUs and
    DENISE MPI ranks.  Raises when the world is smaller than
    ``n_devices``, or on a rank outside the mesh.  ``device`` is the
    rank's (default: its card, made current; raises without one)."""
    world, rank = _world()
    n = world if n_devices is None else int(n_devices)
    if world < n:
        raise ValueError(f"need {n} ranks, have {world}")
    ranks = list(range(n))
    group = _group(ranks, world)
    if rank >= n:
        raise ValueError(f"rank {rank} is outside a mesh of {n} ranks")
    return Mesh({axis_name: n}, rank, {axis_name: rank}, {axis_name: group},
                {axis_name: ranks}, group, _rank_device(device))


def make_mesh2d(n_sample: int, n_shot: int,
                axis_names=("sample", "shot"), *, device=None) -> Mesh:
    """A 2-D {sample, shot} mesh: the reference's per-sample fan-out
    (Auto_model.py:185-199) with shot parallelism on the inner axis.
    Rank r sits at (r // n_shot, r % n_shot), as JAX's
    ``devs[:need].reshape(n_sample, n_shot)`` lays devices out."""
    world, rank = _world()
    need = n_sample * n_shot
    if world < need:
        raise ValueError(f"need {need} devices, have {world}")
    group = _group(list(range(need)), world)
    outer, inner = axis_names
    # every rank makes every line's group, in one order
    cols = [[i * n_shot + j for i in range(n_sample)] for j in range(n_shot)]
    rows = [[i * n_shot + j for j in range(n_shot)] for i in range(n_sample)]
    col_groups = [_group(c, world) for c in cols]
    row_groups = [_group(r, world) for r in rows]
    if rank >= need:
        raise ValueError(f"rank {rank} is outside a mesh of {need} ranks")
    i, j = divmod(rank, n_shot)
    return Mesh({outer: n_sample, inner: n_shot}, rank, {outer: i, inner: j},
                {outer: col_groups[j], inner: row_groups[i]},
                {outer: cols[j], inner: rows[i]}, group,
                _rank_device(device))


def shot_axis_size(mesh: Mesh, axis_name: str = "shot") -> int:
    return mesh.shape[axis_name]


def _group_of(mesh: Mesh, axis):
    return mesh.group if axis is None else mesh.groups[axis]


def _axis_size(mesh: Mesh, axis) -> int:
    return mesh.size if axis is None else mesh.shape[axis]


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str | None = None, *,
               mean: bool = False) -> torch.Tensor:
    """The sum (or ``mean``) of ``t`` over ``axis`` (None: the whole
    mesh), as a new tensor on ``t``'s device: JAX's ``psum``/``pmean``.
    Every rank gets the same bits."""
    group = _group_of(mesh, axis)
    host = _via_host(t, group)
    buf = t.detach().to("cpu", copy=True) if host else t.detach().clone()
    dist.all_reduce(buf, group=group)
    out = buf.to(t.device) if host else buf
    return out / _axis_size(mesh, axis) if mean else out


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str | None = None,
               dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` along ``axis``, concatenated along ``dim`` in
    axis order: JAX's ``all_gather(..., tiled=True)``."""
    group = _group_of(mesh, axis)
    host = _via_host(t, group)
    src = t.detach().to("cpu") if host else t.detach()
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(_axis_size(mesh, axis))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(t.device)


def broadcast_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Overwrite ``t`` (in place) with the mesh's first rank's (global
    rank 0: every mesh starts there)."""
    host = _via_host(t, mesh.group)
    buf = t.detach().to("cpu", copy=True) if host else t.detach()
    dist.broadcast(buf, 0, group=mesh.group)
    if host:
        with torch.no_grad():
            t.copy_(buf)
    return t


def broadcast_module(module: torch.nn.Module, mesh: Mesh) -> None:
    """Give every rank the mesh's first rank's parameters and buffers,
    so that replicated weights start equal whatever the seed path."""
    for t in (*module.parameters(), *module.buffers()):
        broadcast_(t.data, mesh)


def _exchange(left: torch.Tensor, right: torch.Tensor, mesh: Mesh,
              axis: str) -> tuple[torch.Tensor, torch.Tensor]:
    i, n = mesh.coords[axis], mesh.shape[axis]
    ranks, group = mesh.ranks[axis], mesh.groups[axis]
    host = _via_host(left, group)
    stage = "cpu" if host else left.device
    sends = [s.detach().to(stage).contiguous() for s in (left, right)]
    from_prev = torch.zeros_like(sends[1])
    from_next = torch.zeros_like(sends[0])
    ops = []
    if i > 0:
        ops += [dist.P2POp(dist.isend, sends[0], ranks[i - 1], group),
                dist.P2POp(dist.irecv, from_prev, ranks[i - 1], group)]
    if i < n - 1:
        ops += [dist.P2POp(dist.isend, sends[1], ranks[i + 1], group),
                dist.P2POp(dist.irecv, from_next, ranks[i + 1], group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_prev.to(left.device), from_next.to(left.device)


class _Exchange(torch.autograd.Function):
    """The exchange, whose transpose is the same exchange of the
    cotangents: what this rank received from the previous rank was that
    rank's right strip, so the cotangent goes back to it as this rank's
    "left", and the previous rank's cotangent of its ``from_next`` comes
    back as the gradient of this rank's left strip (zeros at the ends:
    JAX's ``ppermute`` transpose)."""

    @staticmethod
    def forward(ctx, left, right, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _exchange(left, right, mesh, axis)

    @staticmethod
    def backward(ctx, g_prev, g_next):
        g_left, g_right = _exchange(g_prev, g_next, ctx.mesh, ctx.axis)
        return g_left, g_right, None, None


def exchange(left: torch.Tensor, right: torch.Tensor, mesh: Mesh,
             axis: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Send ``left`` to the previous rank along ``axis`` and ``right`` to
    the next; return (what the previous rank sent, what the next rank
    sent), zeros at the ends: JAX's two non-periodic ``ppermute``s.
    Differentiable: the backward runs the same exchange on the
    cotangents, so every rank of the axis must take part in it too."""
    return _Exchange.apply(left, right, mesh, axis)


class _GatherReplicated(torch.autograd.Function):
    """:func:`all_gather` whose backward takes this rank's block of the
    cotangent: right where every rank computes the same loss from the
    gathered tensor, so that the cotangent is replicated."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.block = (dim, mesh.coords[axis] * t.shape[dim], t.shape[dim])
        return all_gather(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        dim, lo, size = ctx.block
        return g.narrow(dim, lo, size), None, None, None


def gather_replicated(t: torch.Tensor, mesh: Mesh, axis: str,
                      dim: int = 0) -> torch.Tensor:
    """:func:`all_gather` along ``axis`` (``dim`` of ``t``), differentiable
    where every rank's loss of the result is the same: the gradient of
    ``t`` is this rank's block of the (replicated) cotangent."""
    return _GatherReplicated.apply(t, mesh, axis, dim)


class _ShardReplicated(torch.autograd.Function):
    """This rank's blocks of replicated tensors; the backward sums the
    blocks' cotangents, each placed in a zero tensor of its input's
    shape, over the axis in one all-reduce (JAX's transpose of an
    unmapped input), so every rank ends with the whole gradient."""

    @staticmethod
    def forward(ctx, mesh, axis, blocks, *tensors):
        ctx.mesh, ctx.axis, ctx.blocks = mesh, axis, blocks
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in tensors]
        return tuple(t.clone() if b is None else t.narrow(*b).clone()
                     for t, b in zip(tensors, blocks))

    @staticmethod
    def backward(ctx, *grads):
        full = []
        for g, b, (shape, dtype, device) in zip(grads, ctx.blocks,
                                                ctx.shapes):
            z = torch.zeros(shape, dtype=dtype, device=device)
            (z if b is None else z.narrow(*b)).copy_(g)
            full.append(z)
        flat = all_reduce(torch.cat([z.flatten() for z in full]), ctx.mesh,
                          ctx.axis)
        out = [part.view(z.shape) for part, z in
               zip(flat.split([z.numel() for z in full]), full)]
        return (None, None, None, *out)


def shard_replicated(mesh: Mesh, axis: str, blocks, *tensors):
    """Each of ``tensors`` (the same on every rank of ``axis``) cut to
    its block: ``blocks[i]`` is ``(dim, start, length)``, or None for the
    whole tensor.  Differentiable: every rank's gradient of each input
    is the sum over the axis of the ranks' block gradients, in one
    all-reduce in which every rank takes part (autograd hands an output
    without a cotangent to the backward as zeros)."""
    return _ShardReplicated.apply(mesh, axis, tuple(blocks), *tensors)
