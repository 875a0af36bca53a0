"""Inversion engines (port of ``physicsbasedfwi2_tpu/engine/engines.py``:
``EngineBase``, ``AcousticDIPEngine`` on its fused path, ``LrPolicy``,
``_make_optimizer`` and ``create_engine``).

The JAX engine injects the processed physics gradient into the
generator's autodiff with a ``jax.custom_vjp``; here that is
:class:`_PhysicsLoss`, a ``torch.autograd.Function`` whose forward runs
the fused loss+gradient (kernel B2 on CUDA, its plain version on CPU)
and whose backward returns the depth^2-weighted, water-masked,
``grad_scale``-scaled dJ/dvp.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from physicsbasedfwi2_tpu_torch.data.synthetic import (
    SyntheticAcousticWorkload,
)
from physicsbasedfwi2_tpu_torch.engine.config import ExperimentConfig
from physicsbasedfwi2_tpu_torch.models import (
    apply_generator, apply_velocity_output, define_generator,
)
from physicsbasedfwi2_tpu_torch.models.convert import (
    npz_from_state_dict, state_dict_from_npz,
)
from physicsbasedfwi2_tpu_torch.ops import trace_normalize
from physicsbasedfwi2_tpu_torch.ops.fwi_fused import (
    fwi_l1_loss_grad, scatter_rows,
)
from physicsbasedfwi2_tpu_torch.ops.gradproc import (
    depth_weighting, water_mask,
)
from physicsbasedfwi2_tpu_torch.ops.scalar2 import forward2
from physicsbasedfwi2_tpu_torch.optim.schedules import (
    PlateauController, make_scheduler,
)


def default_device() -> torch.device:
    """The first CUDA card when there is one, else the CPU."""
    return torch.device("cuda:0" if torch.cuda.is_available() else "cpu")


def _make_optimizer(cfg: ExperimentConfig, params):
    if cfg.optimizer == "adam":
        # the same update as optax.adam(lr, b1, b2=0.999, eps)
        return torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.beta1, 0.999),
                                eps=cfg.adam_eps)
    raise NotImplementedError(
        f"optimizer={cfg.optimizer!r} is not ported yet (ROADMAP Queue A, "
        "item 10)")


class LrPolicy:
    """Host-side lr controller: epoch-indexed schedules
    (linear/step/cosine) or the stateful plateau controller."""

    def __init__(self, cfg: ExperimentConfig):
        self.lr = cfg.lr
        self.sched = None
        self.plateau = None
        pol = (cfg.lr_policy or "constant").lower()
        if pol not in ("constant", "none", ""):
            s = make_scheduler(pol, lr=cfg.lr, n_epochs=cfg.n_epochs,
                               n_epochs_decay=cfg.n_epochs_decay)
            if isinstance(s, PlateauController):
                self.plateau = s
            else:
                self.sched = s

    def lr_for_epoch(self, epoch: int) -> float:
        if self.sched is not None:
            self.lr = float(self.sched(epoch))
        return self.lr

    def after_epoch(self, metric: float) -> float:
        if self.plateau is not None:
            self.lr = float(self.plateau.step(metric))
        return self.lr


def _log_path(name: str, physics: str, path: str, why: str = ""):
    """One line per engine build naming the selected physics path."""
    suffix = f" ({why})" if why else ""
    print(f"[{name}] {physics} physics path: {path}{suffix}")


class EngineBase:
    """Checkpoint plumbing shared by the engines."""

    cfg: ExperimentConfig
    net: torch.nn.Module

    def save_networks(self, tag: str | int):
        """Save the generator as ``<tag>_net_G.npz`` with the JAX
        package's keys (loads in either package; no pickle)."""
        os.makedirs(self._dir(), exist_ok=True)
        path = os.path.join(self._dir(), f"{tag}_net_G.npz")
        np.savez(path, **npz_from_state_dict(self.net.state_dict()))
        return path

    def load_networks(self, tag: str | int):
        """Restore weights saved by :meth:`save_networks` (by either
        package) into the engine's generator."""
        path = os.path.join(self._dir(), f"{tag}_net_G.npz")
        with np.load(path) as z:
            sd = state_dict_from_npz({k: z[k] for k in z.files})
        self.net.load_state_dict(sd)  # raises on a missing key or shape
        return path

    def _dir(self):
        return os.path.join(self.cfg.save_dir, self.cfg.name)


class _PhysicsLoss(torch.autograd.Function):
    """The engine's physics loss: forward runs ``value_and_grad(vp)``
    (loss and processed dJ/dvp from the fused path); backward scales
    the stored gradient by the incoming cotangent."""

    @staticmethod
    def forward(ctx, vp, value_and_grad):
        loss, grad = value_and_grad(vp.detach())
        ctx.save_for_backward(grad)
        return loss

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g * grad, None


class AcousticDIPEngine(EngineBase):
    """Generator-reparameterized acoustic FWI on the fused
    second-order path.

    ``device`` holds the generator, the workload and the physics; on
    CUDA the physics runs kernels B1/B2, on CPU their plain versions.
    """

    def __init__(self, cfg: ExperimentConfig, workload=None, mesh=None,
                 val_workload=None, *, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh (shot sharding) is not ported yet (ROADMAP Queue A, "
                "item 14)")
        if cfg.dataroot:
            raise NotImplementedError(
                "dataroot workloads are not ported yet (ROADMAP Queue A, "
                "item 12)")
        if cfg.wavelet_from_data:
            raise NotImplementedError(
                "wavelet_from_data (AutoWav) is not ported yet (ROADMAP "
                "Queue A, slice-1 leftovers)")
        if cfg.encoded_shots > 0:
            raise NotImplementedError(
                "encoded_shots is not ported yet (ROADMAP Queue A, item 11)")
        self.cfg = cfg
        if device is None:
            device = (workload.device if workload is not None
                      else default_device())
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        # (water_rows is not passed, as in the JAX engine: ROADMAP Queue C)
        self.wl = workload or SyntheticAcousticWorkload.build(
            nz=cfg.nz, nx=cfg.nx, dx=cfg.dx, nt=cfg.nt, dt=cfg.dt,
            pml_width=cfg.pml_width, freq=cfg.freq,
            num_shots=cfg.num_shots, num_receivers=cfg.num_receivers,
            seed=cfg.seed, chunk=cfg.chunk, device=self.device)
        if self.wl.device != self.device:
            raise ValueError(f"workload lives on {self.wl.device}, engine "
                             f"on {self.device}")
        acq = self.wl.acq
        single_row = bool((acq.rcv_z == acq.rcv_z[:, :1]).all())
        why = [w for cond, w in (
            (cfg.backend not in ("pallas", "auto"),
             f"backend={cfg.backend}"),
            (cfg.misfit != "l1", f"misfit={cfg.misfit}"),
            (not single_row, "multi-row receivers")) if cond]
        if why:
            raise NotImplementedError(
                "only the fused second-order path is ported ("
                + ", ".join(why) + "); the autodiff acoustic path waits "
                "in ROADMAP Queue A, slice-1 leftovers")
        self.physics_path = ("fused-cuda" if self.device.type == "cuda"
                             else "fused-plain")
        _log_path(cfg.name, "acoustic", self.physics_path)

        geom = self.wl.geom
        g = self.wl.cfg.grid
        if not self.wl.from_disk:
            # regenerate obs with the fused path's operator so the
            # misfit is zero at the true model
            self.wl.obs = forward2(self.wl.vp_true, self.wl.wavelet, *geom,
                                   self.wl.cfg)
            self.wl.obs_norm = trace_normalize(self.wl.obs)
        self._dir_rows = None
        if cfg.direct_wave:
            const = torch.full_like(self.wl.vp_true, cfg.water_vel)
            self._dir_rows = forward2(const, self.wl.wavelet, *geom,
                                      self.wl.cfg, return_rows=True)
            cols = geom[3].long() + g.pml_width
            dir_recs = torch.gather(self._dir_rows, 2,
                                    cols[:, None, :].expand(-1, g.nt, -1))
            if not self.wl.from_disk:
                # synthetic obs mirror the reference's storage convention:
                # the stored gathers lack the direct arrival
                self.wl.obs = self.wl.obs - dir_recs
                self.wl.obs_norm = trace_normalize(self.wl.obs)

        ns, nt, nr = self.wl.obs.shape
        self.net = define_generator(
            cfg.netG, out_shape=(cfg.nz, cfg.nx), in_shape=(nt, nr, ns),
            latent_dim=cfg.latent_dim, filters=cfg.filters,
            time_decimation=cfg.time_decimation, dropout=cfg.dropout,
            generator=torch.Generator().manual_seed(cfg.seed),
        ).to(self.device)
        # net input: [1, nt, nr, ns] (NHWC, as the JAX engine feeds it)
        self.shots_in = self.wl.obs.permute(1, 2, 0)[None].contiguous()
        self.true_b = self.wl.vp_true[None, :, :, None]
        self.val_wl = val_workload
        if self.val_wl is None and cfg.validate_on_twin:
            self.val_wl = SyntheticAcousticWorkload.build(
                nz=cfg.nz, nx=cfg.nx, dx=cfg.dx, nt=cfg.nt, dt=cfg.dt,
                pml_width=cfg.pml_width, freq=cfg.freq,
                num_shots=cfg.num_shots, num_receivers=cfg.num_receivers,
                seed=cfg.seed + 101, chunk=cfg.chunk, device=self.device)
        self.opt = _make_optimizer(cfg, self.net.parameters())
        self.lr_policy = LrPolicy(cfg) if cfg.optimizer == "adam" else None
        self._build_physics()

    def _build_physics(self):
        """Observed and direct rows in the fused kernel's layout, and
        the validation inputs."""
        cfg, wl = self.cfg, self.wl
        g = wl.cfg.grid
        self._obs_rows = scatter_rows(wl.obs_norm, wl.acq.rcv_x, nt=g.nt,
                                      nx=g.nx, pml_width=g.pml_width)
        if self._dir_rows is not None:
            pad_t = self._obs_rows.shape[1] - self._dir_rows.shape[1]
            self._dir_rows_pad = torch.nn.functional.pad(
                self._dir_rows, (0, 0, 0, pad_t)).contiguous()
        else:
            self._dir_rows_pad = torch.zeros_like(self._obs_rows)
        if self.val_wl is not None:
            # the twin's network input is its simulate_acoustic output,
            # without direct-wave removal (as in the JAX engine)
            self._val_in = self.val_wl.obs.permute(1, 2, 0)[None]
            self._val_true = self.val_wl.vp_true
        else:
            self._val_in, self._val_true = self.shots_in, self.wl.vp_true
        self._geom = wl.geom

    def physics_value_and_grad(self, vp: torch.Tensor):
        """(loss, processed dJ/dvp): fused loss+gradient, then depth^2
        weighting, the water mask and ``grad_scale``."""
        cfg, wl = self.cfg, self.wl
        loss, grad = fwi_l1_loss_grad(vp, wl.wavelet, *self._geom, wl.cfg,
                                      self._obs_rows, self._dir_rows_pad)
        grad = depth_weighting(grad, 2.0)
        grad = water_mask(grad, wl.vp_true, cfg.water_vel)
        return loss, grad * cfg.grad_scale

    def physics_loss(self, vp: torch.Tensor) -> torch.Tensor:
        """Differentiable physics loss of vp [nz, nx]."""
        return _PhysicsLoss.apply(vp, self.physics_value_and_grad)

    def _total_loss(self, use_physics: bool):
        cfg = self.cfg
        out = apply_generator(self.net, self.shots_in)
        vp = apply_velocity_output(out.field, self.true_b,
                                   water_vel=cfg.water_vel)[0, :, :, 0]
        model_mse = torch.mean((vp - self.wl.vp_true) ** 2)
        if use_physics:
            loss = self.physics_loss(vp)
        else:
            loss = torch.zeros((), device=self.device)
        if cfg.supervised_weight > 0:
            loss = loss + cfg.supervised_weight * model_mse
        elif cfg.lstart != 0 and not use_physics:
            # warmup phase trains on the model-MSE oracle
            loss = loss + model_mse
        return loss, model_mse

    def optimize_parameters(self, epoch: int, freq: float | None = None):
        """One iteration.  ``freq`` (frequency continuation) is not
        ported and raises."""
        if freq:
            raise NotImplementedError(
                "frequency continuation (_stage_phys_pd) is not ported yet "
                "(ROADMAP Queue A, slice-1 leftovers)")
        use_physics = epoch > self.cfg.lstart
        if self.lr_policy is not None:
            lr = self.lr_policy.lr_for_epoch(epoch)
            for group in self.opt.param_groups:
                group["lr"] = lr
        self.opt.zero_grad(set_to_none=True)
        loss, model_mse = self._total_loss(use_physics)
        loss.backward()
        self.opt.step()
        # one device sync for both scalars
        loss, model_mse = torch.stack([loss.detach(), model_mse.detach()]
                                      ).tolist()
        out = {"loss_D" if use_physics else "loss_M": loss,
               "loss_M_MSE": model_mse}
        if self.lr_policy is not None:
            out["lr"] = self.lr_policy.after_epoch(loss)
        return out

    @torch.no_grad()
    def test(self):
        """Validation on the held-out twin (training sample without
        one): returns ({"loss_V_MSE": mse}, vp as numpy)."""
        out = apply_generator(self.net, self._val_in)
        vp = apply_velocity_output(out.field, self._val_true[None, :, :, None],
                                   water_vel=self.cfg.water_vel)[0, :, :, 0]
        mse = torch.mean((vp - self._val_true) ** 2)
        return {"loss_V_MSE": float(mse)}, vp.cpu().numpy()


_ENGINES: dict[str, Any] = {
    "acoustic_dip": AcousticDIPEngine,
}


def create_engine(cfg: ExperimentConfig, **kw):
    """Factory by ``cfg.engine``."""
    if cfg.engine not in _ENGINES:
        raise NotImplementedError(
            f"engine {cfg.engine!r} is not ported yet (ROADMAP Queue A, "
            "items 9 and 11)")
    return _ENGINES[cfg.engine](cfg, **kw)
