"""Inversion engines (port of ``physicsbasedfwi2_tpu/engine/engines.py``:
``EngineBase``, ``AcousticDIPEngine`` on its fused and "xla" paths,
``ElasticDIPEngine`` on its fused, "fast" and "xla" paths with held-out
shots, the step cap, the drift guard's revert, illumination
preconditioning, gradient smoothing and MC dropout, Adam or L-BFGS in
both, SGLD or SGHMC in both, the VAE and flow generators' loss terms,
``LrPolicy``, ``_make_optimizer``, ``_evict_stale_stages`` and
``create_engine``).

The JAX engines inject the processed physics gradient into the
generator's autodiff with a ``jax.custom_vjp``; here that is
:class:`_PhysicsLoss`, a ``torch.autograd.Function`` whose forward runs
the physics loss+gradient (the fused kernel B2 or B3 on CUDA, their
plain versions on CPU, or autograd through ``simulate_acoustic``,
``simulate_elastic_fast`` or ``simulate_elastic``) and the engine's
gradient processing, and whose backward returns the processed gradient.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from physicsbasedfwi2_tpu_torch.data.synthetic import (
    SyntheticAcousticWorkload, SyntheticElasticWorkload,
)
from physicsbasedfwi2_tpu_torch.device import default_device
from physicsbasedfwi2_tpu_torch.engine.config import ExperimentConfig
from physicsbasedfwi2_tpu_torch.geo.filters import lowpass_filter_time
from physicsbasedfwi2_tpu_torch.models import (
    apply_elastic_output, apply_generator, apply_velocity_output,
    define_generator, kl_divergence, pack_output,
)
from physicsbasedfwi2_tpu_torch.models.convert import (
    npz_from_state_dict, state_dict_from_npz,
)
from physicsbasedfwi2_tpu_torch.ops import (
    acoustic_gradient, normalized_trace_misfit, simulate_acoustic,
    trace_normalize,
)
from physicsbasedfwi2_tpu_torch.ops.fwi_fused import (
    fwi_l1_loss_grad, scatter_rows,
)
from physicsbasedfwi2_tpu_torch.ops.elastic import simulate_elastic
from physicsbasedfwi2_tpu_torch.ops.elastic_fast import (
    elastic_illumination, simulate_elastic_fast,
)
from physicsbasedfwi2_tpu_torch.ops.elastic_fused import (
    fused_elastic_loss_grad, scatter_rows_el, simulate_elastic_ring,
)
from physicsbasedfwi2_tpu_torch.ops.gradproc import (
    depth_weighting, rescale_to_model, smooth_spatial, taper_top, water_mask,
)
from physicsbasedfwi2_tpu_torch.ops.scalar2 import forward2
from physicsbasedfwi2_tpu_torch.optim.lbfgs import lbfgs_wolfe
from physicsbasedfwi2_tpu_torch.optim.schedules import (
    PlateauController, make_scheduler,
)
from physicsbasedfwi2_tpu_torch.optim.sgmcmc import sghmc, sgld

# Offsets from cfg.seed of the engines' generators on the device, apart
# so that no two draw from one Philox stream: dropout masks (0), a VAE's
# latent noise (1), SG-MCMC noise (2).  The weights' generator (cfg.seed)
# and the elastic shot draw's (cfg.seed + 7) are on the CPU.
_LATENT_SEED, _SGMCMC_SEED = 1, 2


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _evict_stale_stages(cache: dict, fc: float) -> None:
    """Drop cached stage data for every stage but ``fc`` (stages
    advance monotonically and are never revisited).  Keys are either
    the stage float or ("pack", float)."""
    for k in [k for k in cache
              if (k[1] if isinstance(k, tuple) else k) != fc]:
        del cache[k]


def _call(net: torch.nn.Module, params, *inputs, generator=None):
    """``net(*inputs)``, with its parameters replaced by ``params`` (a
    dict by name, as ``named_parameters`` gives them) where given;
    dropout draws its masks from ``generator``, and without one the net
    is deterministic."""
    kw = {"deterministic": generator is None, "generator": generator}
    if params is None:
        return net(*inputs, **kw)
    return torch.func.functional_call(net, params, inputs, kw)


def _dropout_generator(cfg: ExperimentConfig, device):
    """The engine's dropout generator: a ``torch.Generator`` on
    ``device`` seeded from ``cfg.seed``, apart from the generators of the
    weights and the shot draw (None without dropout)."""
    if cfg.dropout <= 0:
        return None
    return torch.Generator(device=device).manual_seed(cfg.seed)


def _latent_generator(cfg: ExperimentConfig, device, is_vae: bool):
    """A VAE engine's latent-noise generator on ``device`` (None for
    other generators): every training decode samples its latent from it.
    The JAX engine draws the noise from each step's key, so the two
    packages sample different latents from the same seed."""
    if not is_vae:
        return None
    return torch.Generator(device=device).manual_seed(cfg.seed + _LATENT_SEED)


def _step_masks(gen):
    """A function returning ``gen`` rewound to its state at this call
    (None for None): every training decode of one optimizer step, an
    L-BFGS step's line-search probes included, draws the same dropout
    masks (or VAE latent noise), as the JAX engines' step reuses one key;
    the next step draws new ones."""
    if gen is None:
        return lambda: None
    state = gen.get_state()

    def rewound():
        gen.set_state(state)
        return gen

    return rewound


class _Lbfgs:
    """The engines' L-BFGS (``optimizer="lbfgs"``): :func:`lbfgs_wolfe`
    over the generator's parameters, and its state.  ``memory_size`` and
    ``max_linesearch_steps`` come from ``cfg.extras["lbfgs_memory"]``
    (10, the reference's history) and ``["lbfgs_linesearch"]`` (20)."""

    def __init__(self, cfg: ExperimentConfig, net: torch.nn.Module):
        self.opt = lbfgs_wolfe(
            memory_size=int(cfg.extras.get("lbfgs_memory", 10)),
            max_linesearch_steps=int(cfg.extras.get("lbfgs_linesearch",
                                                    20)))
        named = list(net.named_parameters())
        self.names = [k for k, _ in named]
        self.params = [p for _, p in named]
        self.state = self.opt.init(self.params)
        # value-and-gradient evaluations of the last step: the step's
        # own and one a line-search probe
        self.evaluations = 0

    def updates(self, loss_fn):
        """One L-BFGS iteration of ``loss_fn(params) -> (loss, *aux)``
        (``params`` None: the generator's own; else replacements by
        name): the value and gradient at the current parameters, then
        the line search, whose every probe evaluates the same loss's
        value and gradient, as the JAX engine's ``value_fn`` does.
        Returns (``loss_fn``'s outputs at the current parameters, the
        updates); :meth:`apply` takes the step."""
        out = loss_fn(None)
        grads = torch.autograd.grad(out[0], self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]

        def value_fn(leaves):
            return loss_fn(dict(zip(self.names, leaves)))[0]

        upd, self.state = self.opt.update(
            grads, self.state, self.params, value=out[0].detach(),
            grad=grads, value_fn=value_fn)
        self.evaluations = 1 + self.state.info.num_linesearch_steps
        return out, upd

    @torch.no_grad()
    def apply(self, upd):
        for p, u in zip(self.params, upd):
            p.add_(u)


def _make_optimizer(cfg: ExperimentConfig, net: torch.nn.Module):
    """Adam (a ``torch.optim.Adam``), L-BFGS (:class:`_Lbfgs`), SGLD or
    SGHMC (``optim.sgmcmc``, lr ``cfg.lr``, friction 0.05, temperature 1)
    over the generator ``net``'s parameters.  A new SG-MCMC optimizer
    restarts its noise stream from its seed, as optax's ``init`` resets
    the key (the drift guard's and ``phase_reset_opt``'s fresh ones)."""
    if cfg.optimizer == "adam":
        # the same update as optax.adam(lr, b1, b2=0.999, eps)
        return torch.optim.Adam(net.parameters(), lr=cfg.lr,
                                betas=(cfg.beta1, 0.999), eps=cfg.adam_eps)
    if cfg.optimizer == "lbfgs":
        # the line search picks the step: lr is not used
        return _Lbfgs(cfg, net)
    if cfg.optimizer in ("sgld", "sghmc"):
        sampler = sgld if cfg.optimizer == "sgld" else sghmc
        return sampler(net.parameters(), cfg.lr,
                       seed=cfg.seed + _SGMCMC_SEED)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


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
        np.savez(path, **npz_from_state_dict(self.net.state_dict(),
                                             self.net))
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
    """Generator-reparameterized acoustic FWI.

    ``device`` holds the generator, the workload and the physics.  On
    the fused second-order path (``backend`` "auto"/"pallas", ``l1``
    misfit, single-row receivers) the physics runs kernels B1/B2 on
    CUDA and their plain versions on CPU; otherwise it takes the JAX
    engine's "xla" path, autograd through :func:`simulate_acoustic`.
    Frequency continuation swaps the physics data per stage
    (:meth:`_stage_data`); ``wavelet_from_data`` (AutoWav) on a synthetic
    workload gives every shot its own copy of the wavelet.

    A VAE generator (``netG`` starting with "vae") samples its latent on
    every training decode from a generator of its own on the engine's
    device (every other decode takes z = mu), and the loss gains
    ``kl_weight`` times the KL term (minus the mean flow log-det for the
    planar-flow VAEs); a generator with a flow log-det and no KL term
    (AutoNF) adds ``flow_weight`` times the latent's negative
    log-likelihood 0.5 |z|^2 - log|det|.
    """

    def __init__(self, cfg: ExperimentConfig, workload=None, mesh=None,
                 val_workload=None, *, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh (shot sharding) is not ported yet (ROADMAP Queue A, "
                "item 13)")
        if cfg.dataroot:
            raise NotImplementedError(
                "dataroot workloads are not ported yet (ROADMAP Queue A, "
                "item 10)")
        if cfg.encoded_shots > 0:
            raise NotImplementedError(
                "encoded_shots is not ported yet (ROADMAP Queue A, item 9)")
        self.cfg = cfg
        if device is None:
            device = (workload.device if workload is not None
                      else default_device())
        self.device = _resolve_device(device)
        # (water_rows is not passed, as in the JAX engine: ROADMAP Queue C)
        self.wl = workload or SyntheticAcousticWorkload.build(
            nz=cfg.nz, nx=cfg.nx, dx=cfg.dx, nt=cfg.nt, dt=cfg.dt,
            pml_width=cfg.pml_width, freq=cfg.freq,
            num_shots=cfg.num_shots, num_receivers=cfg.num_receivers,
            seed=cfg.seed, chunk=cfg.chunk, device=self.device)
        if self.wl.device != self.device:
            raise ValueError(f"workload lives on {self.wl.device}, engine "
                             f"on {self.device}")
        if cfg.wavelet_from_data and self.wl.wavelet.ndim == 1:
            # AutoWav on a synthetic workload: the per-shot wavelet array
            # [ns, nt] that stored data would carry
            ns = int(self.wl.acq.src_z.shape[0])
            self.wl.wavelet = self.wl.wavelet[None].expand(
                ns, -1).contiguous()
        acq = self.wl.acq
        single_row = bool((acq.rcv_z == acq.rcv_z[:, :1]).all())
        why = [w for cond, w in (
            (cfg.backend not in ("pallas", "auto"),
             f"backend={cfg.backend}"),
            (cfg.misfit != "l1", f"misfit={cfg.misfit}"),
            (not single_row, "multi-row receivers")) if cond]
        # the fused path runs kernel B2 on the card and its plain version
        # on the CPU; otherwise the JAX engine's "xla" path: autograd
        # through simulate_acoustic, plain PyTorch on either device
        self._use_fused = not why
        if self._use_fused:
            self.physics_path = ("fused-cuda" if self.device.type == "cuda"
                                 else "fused-plain")
            _log_path(cfg.name, "acoustic", self.physics_path)
        else:
            self.physics_path = "xla"
            _log_path(cfg.name, "acoustic", self.physics_path,
                      "fused unavailable: " + ", ".join(why))

        geom = self.wl.geom
        g = self.wl.cfg.grid
        if self._use_fused and not self.wl.from_disk:
            # regenerate obs with the fused path's operator so the
            # misfit is zero at the true model
            self.wl.obs = forward2(self.wl.vp_true, self.wl.wavelet, *geom,
                                   self.wl.cfg)
            self.wl.obs_norm = trace_normalize(self.wl.obs)
        self._dir_rows = None
        self._direct = None
        if cfg.direct_wave:
            const = torch.full_like(self.wl.vp_true, cfg.water_vel)
            if self._use_fused:
                self._dir_rows = forward2(const, self.wl.wavelet, *geom,
                                          self.wl.cfg, return_rows=True)
                cols = geom[3].long() + g.pml_width
                dir_recs = torch.gather(
                    self._dir_rows, 2, cols[:, None, :].expand(-1, g.nt, -1))
            else:
                with torch.no_grad():
                    self._direct = simulate_acoustic(
                        const, self.wl.wavelet, *geom, self.wl.cfg)
                dir_recs = self._direct
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
        self.is_vae = cfg.netG.lower().startswith("vae")
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
        self.opt = _make_optimizer(cfg, self.net)
        self.lr_policy = LrPolicy(cfg) if cfg.optimizer == "adam" else None
        self._drop_gen = _dropout_generator(cfg, self.device)
        self._latent_gen = _latent_generator(cfg, self.device, self.is_vae)
        self._build_physics()

    def _kernel_rows(self, pd, dir_rows):
        """Add the fused kernel's layouts to the physics data ``pd``: the
        normalized observed gathers as receiver rows, and the direct-wave
        rows (or zeros) padded to the rows' length."""
        g = self.wl.cfg.grid
        obs_rows = scatter_rows(pd["obs_norm"], self.wl.acq.rcv_x, nt=g.nt,
                                nx=g.nx, pml_width=g.pml_width)
        if dir_rows is None:
            pd["dir_rows"] = torch.zeros_like(obs_rows)
        else:
            pad_t = obs_rows.shape[1] - dir_rows.shape[1]
            pd["dir_rows"] = torch.nn.functional.pad(
                dir_rows, (0, 0, 0, pad_t)).contiguous()
        pd["obs_rows"] = obs_rows
        return pd

    def _build_physics(self):
        """The base physics data (the full band: wavelet, normalized
        observed gathers, direct wave and, on the fused path, the
        kernel's rows), the stage cache, and the validation inputs."""
        wl = self.wl
        self._phys = {"wav": wl.wavelet, "obs_norm": wl.obs_norm,
                      "direct": self._direct}
        if self._use_fused:
            self._kernel_rows(self._phys, self._dir_rows)
        self._stage_cache = {}
        if self.val_wl is not None:
            # the twin's network input is its simulate_acoustic output,
            # without direct-wave removal (as in the JAX engine)
            self._val_in = self.val_wl.obs.permute(1, 2, 0)[None]
            self._val_true = self.val_wl.vp_true
        else:
            self._val_in, self._val_true = self.shots_in, self.wl.vp_true
        self._geom = wl.geom

    def _stage_data(self, fc):
        """Physics data of the continuation stage ``fc`` (port of the JAX
        engine's ``_stage_phys_pd``; the mesh branches are not ported):
        the wavelet, the observed gathers (then trace-normalized) and the
        direct wave low-passed at ``fc`` once per stage (by linearity
        simulating with the filtered wavelet equals filtering the
        prediction), and on the fused path the kernel's rows rebuilt from
        them.  ``fc <= 0`` returns the base data; a new stage evicts the
        cached ones."""
        key = float(fc or 0.0)
        if key <= 0.0:
            return self._phys
        if key not in self._stage_cache:
            dt, wl = self.cfg.dt, self.wl
            pd = dict(self._phys)
            pd["wav"] = lowpass_filter_time(wl.wavelet, key, dt, axis=-1)
            pd["obs_norm"] = trace_normalize(
                lowpass_filter_time(wl.obs, key, dt, axis=1))
            if self._direct is not None:
                pd["direct"] = lowpass_filter_time(self._direct, key, dt,
                                                   axis=1)
            if self._use_fused:
                dir_rows = (None if self._dir_rows is None else
                            lowpass_filter_time(self._dir_rows, key, dt,
                                                axis=1))
                self._kernel_rows(pd, dir_rows)
            _evict_stale_stages(self._stage_cache, key)
            self._stage_cache[key] = pd
        return self._stage_cache[key]

    def physics_value_and_grad(self, vp: torch.Tensor, fc: float = 0.0):
        """(loss, processed dJ/dvp) at stage ``fc`` (0 = full band): the
        fused loss+gradient (B2) or, on the "xla" path, autograd through
        :func:`simulate_acoustic`; then depth^2 weighting, the water mask
        and ``grad_scale``."""
        cfg, wl = self.cfg, self.wl
        pd = self._stage_data(fc)
        if self._use_fused:
            loss, grad = fwi_l1_loss_grad(vp, pd["wav"], *self._geom,
                                          wl.cfg, pd["obs_rows"],
                                          pd["dir_rows"])
        else:
            def misfit(pred):
                # the reference pipeline: subtract the direct wave,
                # trace-normalize, L1/L2/Huber against the observed data
                return normalized_trace_misfit(pred, pd["obs_norm"],
                                               direct=pd["direct"],
                                               kind=cfg.misfit)

            loss, grad = acoustic_gradient(vp, misfit, pd["wav"],
                                           *self._geom, wl.cfg)
        grad = depth_weighting(grad, 2.0)
        grad = water_mask(grad, wl.vp_true, cfg.water_vel)
        return loss, grad * cfg.grad_scale

    def physics_loss(self, vp: torch.Tensor, fc: float = 0.0) -> torch.Tensor:
        """Differentiable physics loss of vp [nz, nx] at stage ``fc``."""
        return _PhysicsLoss.apply(
            vp, lambda v: self.physics_value_and_grad(v, fc))

    def _total_loss(self, use_physics: bool, fc: float = 0.0, params=None,
                    generator=None):
        """(loss, model MSE) of the generator (with its parameters
        replaced by ``params`` where given; its random draws, a VAE's
        latent noise or dropout masks, from ``generator``)."""
        cfg = self.cfg
        out = pack_output(_call(self.net, params, self.shots_in,
                                generator=generator))
        vp = apply_velocity_output(out.field, self.true_b,
                                   water_vel=cfg.water_vel)[0, :, :, 0]
        model_mse = torch.mean((vp - self.wl.vp_true) ** 2)
        if use_physics:
            loss = self.physics_loss(vp, fc)
        else:
            loss = torch.zeros((), device=self.device)
        if cfg.supervised_weight > 0:
            loss = loss + cfg.supervised_weight * model_mse
        elif cfg.lstart != 0 and not use_physics:
            # warmup phase trains on the model-MSE oracle
            loss = loss + model_mse
        if out.mu is not None and cfg.kl_weight > 0:
            kl = kl_divergence(out.mu, out.logvar)
            if out.logdet is not None:
                # flow-sharpened posterior: KL(q0 || N) - E[logdet]
                kl = kl - torch.mean(out.logdet)
            loss = loss + cfg.kl_weight * kl
        elif out.logdet is not None:
            # invertible latent (AutoNF): 0.5 |z|^2 - log|det J|
            nll = (0.5 * torch.mean(torch.sum(out.latent ** 2, dim=-1))
                   - torch.mean(out.logdet))
            loss = loss + cfg.flow_weight * nll
        return loss, model_mse

    def optimize_parameters(self, epoch: int, freq: float | None = None,
                            tether_stage: int | None = None):
        """One iteration at continuation stage ``freq`` (None or 0: the
        full band).  ``tether_stage`` is accepted for the train loop's
        sake, as in the JAX engine (the tether is an elastic recipe)."""
        use_physics = epoch > self.cfg.lstart
        fc = freq or 0.0
        # a VAE draws latent noise, as the JAX engine's "latent" rng;
        # other generators dropout masks
        draws = _step_masks(self._latent_gen if self.is_vae
                            else self._drop_gen)
        if isinstance(self.opt, _Lbfgs):
            # the line search's probes evaluate the same loss (on the
            # card kernel B2 once a probe) with the same draws
            (loss, model_mse), upd = self.opt.updates(
                lambda params: self._total_loss(use_physics, fc, params,
                                                draws()))
            self.opt.apply(upd)
        else:
            if self.lr_policy is not None:
                lr = self.lr_policy.lr_for_epoch(epoch)
                for group in self.opt.param_groups:
                    group["lr"] = lr
            self.opt.zero_grad(set_to_none=True)
            loss, model_mse = self._total_loss(use_physics, fc, None,
                                               draws())
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


def elastic_workload(cfg: ExperimentConfig, device):
    """The synthetic workload an :class:`ElasticDIPEngine` builds from
    ``cfg`` when it is given none."""
    return SyntheticElasticWorkload.build(
        nz=cfg.nz, nx=cfg.nx, dx=cfg.dx, nt=cfg.nt, dt=cfg.dt,
        pml_width=cfg.pml_width, freq=cfg.freq, num_shots=cfg.num_shots,
        num_receivers=cfg.num_receivers, seed=cfg.seed, chunk=cfg.chunk,
        free_surface=cfg.free_surface, water_rows=cfg.water_rows,
        src_depth_row=cfg.extras.get("src_depth_row"),
        rcv_depth_row=cfg.extras.get("rcv_depth_row"),
        rcv_follow_seabed=cfg.extras.get("rcv_follow_seabed", False),
        device=device)


def holdout_split(n_shots: int, holdout_shots: int):
    """(held-out, training pool) shot indices as int64 numpy arrays:
    ``k = min(holdout_shots, max(n_shots - 1, 1))`` evenly spaced
    interior shots (numpy rounds half to even: 35 shots hold out
    [8, 17, 26], 5 shots [1, 2, 3]) and the rest; ``(None, all)`` when
    ``holdout_shots <= 0``."""
    if holdout_shots <= 0:
        return None, np.arange(n_shots)
    k = min(holdout_shots, max(n_shots - 1, 1))
    hold = np.unique(np.round(np.linspace(0, n_shots - 1, k + 2)[1:-1])
                     .astype(np.int64))
    return hold, np.setdiff1d(np.arange(n_shots), hold)


class ElasticDIPEngine(EngineBase):
    """Two-branch elastic FWI with frequency continuation.

    Physics paths, chosen as the JAX engine chooses them: "fused" (kernel
    B3, ``ops/elastic_fused.py``, on CUDA "fused-cuda", its plain version
    on CPU "fused-plain") for the ``l2``/``snl2``/``tnl1`` misfits on a
    single receiver row (``tnl1`` with distinct columns) and ``backend``
    "auto"/"pallas"; otherwise "fast" (autograd through
    :func:`simulate_elastic_fast`, the 5-field sponge scheme) for
    ``backend`` "auto"/"fast"/"pallas", else "xla" (autograd through the
    split-PML :func:`simulate_elastic`).  Synthetic observed data are
    regenerated with the path's operator (not on "xla", whose operator
    made them).

    Each physics epoch draws a random subset of ``shots_per_iter``
    shots of the training pool from an explicit ``torch.Generator``
    seeded from ``cfg.seed + 7``; it is not the JAX engine's
    ``jax.random`` draw, so the two packages pick different shots from
    the same seed.

    The robust recipe's options (``marmousi_elastic_robust``):
    ``holdout_shots`` keeps evenly spaced shots out of the pool and logs
    their misfit as ``loss_H`` every ``holdout_every`` physics epochs
    (:meth:`holdout_misfit`, through the path's forward); ``step_cap``
    scales each physics step so the decoded model moves at most that
    RMS; ``phase_reset_opt`` makes a fresh optimizer at the first
    physics epoch; :meth:`guard_revert` and ``guard_lr_ramp`` serve the
    train loop's drift guard.

    ``grad_illum_eps > 0`` (DENISE's EPRECOND, ``seam_elastic_robust``)
    divides the gradient by the starting model's source illumination
    (:meth:`_illum_weight`, computed once, at the first physics step);
    ``grad_smooth`` smooths it (:func:`smooth_spatial`).  With
    ``dropout > 0`` (``mcdip_uq``) every training decode samples dropout
    masks from a generator of its own on the engine's device, seeded from
    ``cfg.seed``; every other decode is deterministic, and
    :meth:`mc_realizations` draws the MC-dropout ensemble.
    """

    def __init__(self, cfg: ExperimentConfig, workload=None, mesh=None, *,
                 device=None):
        why = [w for cond, w in (
            (mesh is not None,
             "mesh (shot sharding): ROADMAP Queue A, item 13"),
            (bool(cfg.dataroot), "dataroot: ROADMAP Queue A, item 10"))
            if cond]
        if why:
            raise NotImplementedError("not ported yet: " + "; ".join(why))
        self.cfg = cfg
        if device is None:
            device = (workload.device if workload is not None
                      else default_device())
        self.device = _resolve_device(device)
        self.wl = workload or elastic_workload(cfg, self.device)
        if self.wl.device != self.device:
            raise ValueError(f"workload lives on {self.wl.device}, engine "
                             f"on {self.device}")
        self.n_shots = int(self.wl.acq.num_shots)
        if self.n_shots != cfg.num_shots:
            print(f"[{cfg.name}] workload has {self.n_shots} shots; "
                  f"config num_shots={cfg.num_shots} -- using the "
                  f"workload's count")
        # held-out shots never enter the training pool; their misfit
        # (loss_H) is the unsupervised early-stopping metric
        hold, pool = holdout_split(self.n_shots, cfg.holdout_shots)
        self._holdout_idx = (None if hold is None else
                             torch.as_tensor(hold, device=self.device))
        self._train_pool = torch.as_tensor(pool, device=self.device)
        acq = self.wl.acq
        single_row = bool((acq.rcv_z == acq.rcv_z[:, :1]).all())
        # the fused tnl1 misfit identifies traces with receiver-row
        # columns, so they must be distinct within each shot
        distinct_cols = all(len(set(row.tolist())) == len(row)
                            for row in acq.rcv_x)
        why = [w for cond, w in (
            (cfg.backend not in ("auto", "pallas"),
             f"backend={cfg.backend}"),
            (not single_row, "multi-row receivers"),
            (cfg.misfit not in ("l2", "snl2", "tnl1"),
             f"misfit={cfg.misfit}"),
            (cfg.misfit == "tnl1" and not distinct_cols,
             "duplicate receiver columns")) if cond]
        self._use_fused = not why
        if self._use_fused:
            self.physics_path = ("fused-cuda" if self.device.type == "cuda"
                                 else "fused-plain")
            self._sim = simulate_elastic_ring
        elif cfg.backend in ("auto", "fast", "pallas"):
            self.physics_path, self._sim = "fast", simulate_elastic_fast
        else:
            self.physics_path, self._sim = "xla", simulate_elastic
        _log_path(cfg.name, "elastic", self.physics_path,
                  "fused unavailable: " + ", ".join(why) if why else "")
        if self.physics_path != "xla" and not self.wl.from_disk:
            # regenerate obs with the path's operator so the misfit is
            # zero at the true model
            wl = self.wl
            with torch.no_grad():
                wl.obs_vx, wl.obs_vz = self._sim(
                    wl.true["vp"], wl.true["vs"], wl.true["rho"],
                    wl.wavelet, *wl.geom, wl.cfg)
        ns, nt, nr = self.wl.obs_vx.shape
        self.net = define_generator(
            cfg.netG, out_shape=(cfg.nz, cfg.nx), in_shape=(nt, nr, ns),
            latent_dim=cfg.latent_dim, filters=cfg.filters,
            time_decimation=cfg.time_decimation, dropout=cfg.dropout,
            head=cfg.elastic_head,
            generator=torch.Generator().manual_seed(cfg.seed),
        ).to(self.device)
        # net inputs: [1, nt, nr, ns] (NHWC, as the JAX engine feeds them)
        self.in_vx = self.wl.obs_vx.permute(1, 2, 0)[None].contiguous()
        self.in_vz = self.wl.obs_vz.permute(1, 2, 0)[None].contiguous()
        # 2 fields = vp/vs with rho from the low-frequency model, 3 = rho
        # inverted too
        self.n_fields = int(getattr(self.net, "n_fields", 2))
        names = ("vp", "vs", "rho")[: self.n_fields]
        self.field_names = names
        self.lowf = torch.stack([self.wl.start[k] for k in names], -1)[None]
        self.true_m = torch.stack([self.wl.true[k] for k in names], -1)[None]
        self.opt = _make_optimizer(cfg, self.net)
        # per-field box constraints; the delta scale is a hard bound for
        # the tanh head, a unit-conditioning gain for the linear head
        default_scale = ((300.0, 200.0, 150.0)
                         if cfg.elastic_head == "tanh"
                         else (100.0, 100.0, 100.0))
        self.delta_scale = tuple(
            cfg.delta_scale or default_scale)[: self.n_fields]
        self.clip_min = tuple(
            cfg.clip_min or (1500.0, 0.0, 900.0))[: self.n_fields]
        self.clip_max = tuple(
            cfg.clip_max or (4700.0, 2700.0, 3000.0))[: self.n_fields]
        self.lr_policy = LrPolicy(cfg) if cfg.optimizer == "adam" else None
        self._shot_gen = torch.Generator().manual_seed(cfg.seed + 7)
        self._drop_gen = _dropout_generator(cfg, self.device)
        self._ilw = None  # the EPRECOND weight, at the first physics step
        self._stage_cache = {}
        # trailing-tether state (cfg.tether_mode="stage")
        self._tether_ref = None
        self._tether_stage_i = -1
        self._tether_epoch = 0
        self._phase_reset_done = False
        # drift-guard state: the epoch of the last revert, for the
        # post-revert lr ramp
        self._guard_ramp_from = None
        # the last capped step: its cap, scale and uncapped model move
        self.last_step_cap = None

    def _stage_data(self, fc):
        """Per-stage (wavelet_fc, obs_vx_fc, obs_vz_fc), cached.
        Frequency continuation low-passes the wavelet (by linearity the
        same as filtering the prediction) and the observed data once per
        stage."""
        key = float(fc or 0.0)
        if key not in self._stage_cache:
            wl, cfg = self.wl, self.cfg
            if key > 0:
                wav = lowpass_filter_time(wl.wavelet, key, cfg.dt, axis=-1)
                ovx = lowpass_filter_time(wl.obs_vx, key, cfg.dt, axis=1)
                ovz = lowpass_filter_time(wl.obs_vz, key, cfg.dt, axis=1)
            else:
                wav, ovx, ovz = wl.wavelet, wl.obs_vx, wl.obs_vz
            if cfg.misfit == "snl2":
                # shot-normalized raw L2: each shot's gathers and wavelet
                # divided by the shot's observed RMS
                s = torch.sqrt(torch.mean(ovx ** 2 + ovz ** 2, dim=(1, 2),
                                          keepdim=True))
                s = torch.clamp(s, min=1e-30)
                if wav.ndim == 1:
                    wav = wav[None].expand(ovx.shape[0], wav.shape[-1])
                wav = wav / s[:, :, 0]
                ovx, ovz = ovx / s, ovz / s
            _evict_stale_stages(self._stage_cache, key)
            self._stage_cache[key] = (wav, ovx, ovz)
        return self._stage_cache[key]

    def _stage_pack(self, fc):
        """Per-stage wavelet, observed gathers and, on the fused path,
        their fused-kernel row layouts (``tnl1`` obs rows are
        pre-normalized: the kernel normalizes only the predicted side),
        cached."""
        key = ("pack", float(fc or 0.0))
        if key not in self._stage_cache:
            wav, ovx, ovz = self._stage_data(fc)
            pd = {"wav": wav, "ovx": ovx, "ovz": ovz}
            if self._use_fused:
                sx_, sz_ = ovx, ovz
                if self.cfg.misfit == "tnl1":
                    sx_, sz_ = trace_normalize(sx_), trace_normalize(sz_)
                rcv_x = self.wl.acq.rcv_x
                pd["orx"] = scatter_rows_el(sx_, rcv_x, self.wl.cfg, KC=8)
                pd["orz"] = scatter_rows_el(sz_, rcv_x, self.wl.cfg, KC=8)
            _evict_stale_stages(self._stage_cache, key[1])
            self._stage_cache[key] = pd
        return self._stage_cache[key]

    def _physics_loss_raw(self, m, shot_idx, pd, rho=None):
        """The misfit of m [nz, nx, F] on a shot subset, from the path's
        operator (the ring forward on the fused path: no gradient;
        autograd through the fast or split-PML propagator otherwise):
        ``tnl2``/``tnl1`` trace-normalize both sides and sum ``mean (p -
        o)^2`` or ``mean|p - o|`` over vx and vz, ``l2``/``snl2`` the raw
        L2.  ``pd`` holds the stage's wavelet and observed gathers; with
        F == 2 the density is the low-frequency rho (or ``rho``)."""
        wl = self.wl
        wav = pd["wav"]
        sz, sx, rz, rx = (a[shot_idx] for a in wl.geom)
        if wav.ndim == 2:
            wav = wav[shot_idx]
        if rho is None:
            rho = m[..., 2] if self.n_fields == 3 else wl.start["rho"]
        pvx, pvz = self._sim(m[..., 0], m[..., 1], rho, wav, sz, sx, rz, rx,
                             wl.cfg)
        ovx, ovz = pd["ovx"][shot_idx], pd["ovz"][shot_idx]
        if self.cfg.misfit in ("tnl2", "tnl1"):
            pvx, pvz = trace_normalize(pvx), trace_normalize(pvz)
            ovx, ovz = trace_normalize(ovx), trace_normalize(ovz)
            if self.cfg.misfit == "tnl1":
                return (torch.mean(torch.abs(pvx - ovx))
                        + torch.mean(torch.abs(pvz - ovz)))
        return torch.mean((pvx - ovx) ** 2) + torch.mean((pvz - ovz) ** 2)

    def _autograd_value_and_grad(self, m, shot_idx, pd, rho=None):
        """(loss, dJ/dm [nz, nx, F]) by autograd through
        :meth:`_physics_loss_raw` (the "fast" and "xla" paths)."""
        with torch.enable_grad():
            mm = m.detach().requires_grad_(True)
            loss = self._physics_loss_raw(mm, shot_idx, pd, rho)
            (grad,) = torch.autograd.grad(loss, mm)
        return loss.detach(), grad

    def _fused_value_and_grad(self, m, shot_idx, pd, rho=None):
        """(loss, dJ/dm [nz, nx, F]) from the fused kernel on the
        selected shot subset.  With F == 2 the density entering the
        simulation is the low-frequency rho (or ``rho``)."""
        wl = self.wl
        wav = pd["wav"]
        sz, sx, rz, rx = (a[shot_idx] for a in wl.geom)
        if wav.ndim == 2:
            wav = wav[shot_idx]
        vp, vs = m[..., 0], m[..., 1]
        if rho is None:
            rho = m[..., 2] if self.n_fields == 3 else wl.start["rho"]
        loss, grads = fused_elastic_loss_grad(
            vp, vs, rho, wav, sz, sx, rz, rx, wl.cfg, pd["orx"][shot_idx],
            pd["orz"][shot_idx], KC=8, wrt=self.field_names,
            misfit="l2" if self.cfg.misfit == "snl2" else self.cfg.misfit)
        return loss, torch.stack([grads[k] for k in self.field_names], -1)

    def _illum_weight(self):
        """DENISE's EPRECOND weight [nz, nx]: 1 / (il + grad_illum_eps),
        il the source illumination of the starting model over all shots
        (:func:`elastic_illumination`) over its maximum.  Computed once,
        on the engine's device, the first time a step needs it: an engine
        built only to evaluate never pays for it."""
        if self._ilw is None:
            wl = self.wl
            il = elastic_illumination(
                wl.start["vp"], wl.start["vs"], wl.start["rho"], wl.wavelet,
                *wl.geom[:2], wl.cfg)
            self._ilw = 1.0 / (il / torch.amax(il) + self.cfg.grad_illum_eps)
        return self._ilw

    def _processed_value_and_grad(self, m, shot_idx, pd, rho=None):
        """(loss, processed dJ/dm [nz, nx, F]) on the engine's path (B3,
        or autograd through the path's propagator): per field the
        top-rows taper, the EPRECOND weight ``pd["ilw"]`` (with
        ``grad_illum_eps > 0``), ``grad_smooth`` binomial passes,
        depth^p weighting (only without EPRECOND, which replaces it),
        ``grad_scale`` or the rescale to the model, and the field weight
        ``pd["fw"]``; then the tether toward ``pd["lowf_m"]`` with weight
        ``pd["tw"]`` times the gradient's RMS."""
        cfg = self.cfg
        taper_rows = (cfg.grad_taper_rows if cfg.grad_taper_rows
                      is not None else cfg.water_rows)
        value_and_grad = (self._fused_value_and_grad if self._use_fused
                          else self._autograd_value_and_grad)
        loss, gm = value_and_grad(m, shot_idx, pd, rho)
        cols = []
        for k in range(self.n_fields):
            g = taper_top(gm[..., k], taper_rows,
                          smooth=cfg.grad_taper_smooth)
            if cfg.grad_illum_eps > 0:
                g = g * pd["ilw"]
            if cfg.grad_smooth > 0:
                g = smooth_spatial(g, cfg.grad_smooth)
            if cfg.grad_depth_power > 0 and cfg.grad_illum_eps <= 0:
                # the illumination weight replaces the depth ramp: both
                # would boost deep cells by ~z^p / eps
                g = depth_weighting(g, cfg.grad_depth_power)
            if cfg.grad_rescale == "max":
                g = rescale_to_model(g, m[..., k])
            else:
                g = g * cfg.grad_scale
            cols.append(g * pd["fw"][k])
        gm = torch.stack(cols, -1)
        if cfg.tether_weight > 0:
            # Tikhonov-to-start tether in gradient units
            d = m - pd["lowf_m"]
            g_rms = torch.sqrt(torch.mean(gm ** 2, dim=(0, 1), keepdim=True))
            d_rms = torch.sqrt(torch.mean(d ** 2, dim=(0, 1), keepdim=True))
            gm = gm + pd["tw"] * g_rms * d / (d_rms + 1e-20)
        return loss, gm

    def _make_physics_loss(self):
        """The differentiable physics loss ``physics_loss(m, shot_idx,
        pd)`` of m [nz, nx, F]: the path's loss, with the processed
        gradient (:meth:`_processed_value_and_grad`) as its gradient."""
        def physics_loss(m, shot_idx, pd):
            return _PhysicsLoss.apply(
                m, lambda mm: self._processed_value_and_grad(mm, shot_idx,
                                                             pd))

        return physics_loss

    def _decode(self, params=None, generator=None):
        """The decoder's model [1, nz, nx, F] (with the generator's
        parameters replaced by ``params`` where given; dropout masks from
        ``generator``, deterministic without one)."""
        deltas, _ = _call(self.net, params, self.in_vx, self.in_vz,
                          generator=generator)
        return self._model(deltas)

    def _model(self, deltas):
        """The model [B, nz, nx, F] of the decoder's ``deltas``."""
        return apply_elastic_output(
            deltas, self.lowf, self.true_m, delta_scale=self.delta_scale,
            clip_min=self.clip_min, clip_max=self.clip_max,
            pin_rows=self.cfg.water_rows, clip_mode=self.cfg.clip_mode)

    def _field_weights(self, epoch: int):
        """Per-field gradient multipliers for this epoch:
        grad_field_weights masked by the field_start_epochs gate."""
        cfg = self.cfg
        fw = [1.0] * self.n_fields
        if cfg.grad_field_weights is not None:
            fw = [float(w) for w in
                  cfg.grad_field_weights[: self.n_fields]]
        if cfg.field_start_epochs is not None:
            for k, e0 in enumerate(cfg.field_start_epochs[: self.n_fields]):
                if epoch < cfg.lstart + int(e0):
                    fw[k] = 0.0
        return fw

    def _phys(self, fc, epoch: int, stage_i: int, tether_m):
        cfg = self.cfg
        pd = dict(self._stage_pack(fc), fw=self._field_weights(epoch),
                  tw=cfg.tether_weight * cfg.tether_decay ** stage_i,
                  lowf_m=tether_m)
        if cfg.grad_illum_eps > 0:
            pd["ilw"] = self._illum_weight()
        return pd

    def optimize_parameters(self, epoch: int, freq: float | None = None,
                            tether_stage: int | None = None):
        cfg = self.cfg
        fc = freq if freq is not None else (
            cfg.freq_stages[0] if cfg.freq_stages else 0.0)
        pool = self._train_pool
        nsub = min(cfg.shots_per_iter or self.n_shots, int(pool.shape[0]))
        # random shot subset per iteration, drawn every epoch
        perm = torch.randperm(int(pool.shape[0]), generator=self._shot_gen)
        idx = pool[perm[:nsub].to(pool.device)]
        use_physics = epoch > cfg.lstart
        if (use_physics and cfg.lstart > 0 and cfg.phase_reset_opt
                and not self._phase_reset_done):
            # a fresh optimizer at the warmup->physics switch: moments and
            # step count (or the L-BFGS memory) start from zero, as optax's
            # opt.init does
            self.opt = _make_optimizer(cfg, self.net)
            self._phase_reset_done = True
        if self.lr_policy is not None:
            lr = self.lr_policy.lr_for_epoch(epoch)
            if use_physics and cfg.phase_lr_ramp > 0:
                # linear lr ramp over the first physics epochs
                lr *= min(1.0, (epoch - cfg.lstart) / cfg.phase_lr_ramp)
            if (use_physics and cfg.guard_lr_ramp > 0
                    and self._guard_ramp_from is not None):
                # the same ramp after each drift-guard revert (which
                # made a fresh optimizer)
                k = epoch - self._guard_ramp_from
                if k < cfg.guard_lr_ramp:
                    lr *= (k + 1) / cfg.guard_lr_ramp
            for group in self.opt.param_groups:
                group["lr"] = lr
        stage_i = (cfg.freq_stages.index(fc)
                   if cfg.freq_stages and fc in cfg.freq_stages else 0)
        if tether_stage is not None:
            stage_i = tether_stage
        tether_m = self.lowf[0]
        if cfg.tether_weight > 0 and cfg.tether_mode == "stage" and \
                use_physics:
            # trailing tether: pull toward the model at the start of the
            # current segment
            refresh = (self._tether_ref is None
                       or stage_i != self._tether_stage_i
                       or (cfg.tether_refresh_epochs > 0
                           and epoch - self._tether_epoch
                           >= cfg.tether_refresh_epochs))
            if refresh:
                self._tether_ref = self._sample_model()[0]
                self._tether_stage_i = stage_i
                self._tether_epoch = epoch
            tether_m = self._tether_ref
        phys = self._phys(fc, epoch, stage_i, tether_m) if use_physics else None
        physics_loss = self._make_physics_loss()
        masks = _step_masks(self._drop_gen)

        def total_loss(params):
            m = self._decode(params, masks())
            if use_physics:
                loss_d = physics_loss(m[0], idx, phys)
                loss = loss_d
                if cfg.anchor_weight > 0:
                    anchor = torch.mean((m - self.lowf) ** 2)
                    loss = loss + cfg.anchor_weight * anchor * 1e-6
            else:
                # warmup (epoch <= lstart): anchor regression to the
                # low-frequency model, no physics
                loss = torch.mean((m - self.lowf) ** 2)
                loss_d = torch.zeros((), device=self.device)
            return loss, loss_d, torch.mean((m - self.true_m) ** 2), m

        if isinstance(self.opt, _Lbfgs):
            # every line-search probe evaluates the same loss on the same
            # shots and stage data
            (loss, loss_d, mse, m), upd = self.opt.updates(total_loss)

            def step():
                self.opt.apply(upd)
        else:
            self.opt.zero_grad(set_to_none=True)
            loss, loss_d, mse, m = total_loss(None)
            loss.backward()
            step = self.opt.step
        if cfg.step_cap > 0 and use_physics:
            # the cap measures deterministic decodes: under dropout the
            # step's own model is a masked one
            m_old = m.detach() if self._drop_gen is None else \
                self._sample_model()
            self._capped_step(m_old, self._step_cap(stage_i), step)
        else:
            step()
        # one device sync for both scalars
        loss_d, mse = torch.stack([loss_d.detach(), mse.detach()]).tolist()
        out = {"loss_D_MSE": loss_d, "loss_M_MSE": mse}
        if (self._holdout_idx is not None and use_physics
                and epoch % max(cfg.holdout_every, 1) == 0):
            out["loss_H"] = self.holdout_misfit(fc)
        if self.lr_policy is not None:
            # the warmup's constant-zero loss_D must not feed the plateau
            # lr controller
            out["lr"] = (self.lr_policy.after_epoch(loss_d) if use_physics
                         else self.lr_policy.lr)
        return out

    def _step_cap(self, stage_i: int) -> float:
        """The model-move cap of this step: ``step_cap``, or in the final
        continuation stage ``step_cap_final`` (0: 1e9, uncapped; > 0: that
        value; -1: keep).  ``stage_i`` is the tether's stage where
        ``tether_anneal_plateaus`` overrides it, as in the JAX engine."""
        cfg = self.cfg
        if cfg.freq_stages and stage_i == len(cfg.freq_stages) - 1:
            if cfg.step_cap_final == 0:
                return 1e9
            if cfg.step_cap_final > 0:
                return cfg.step_cap_final
        return cfg.step_cap

    def _capped_step(self, m_old, cap: float, step):
        """The optimizer's step scaled so that the decoded model moves at
        most ``cap`` RMS (m/s): the update u = p_new - p_old of ``step()``
        (which updates the parameters in place), then two fixed-point
        rounds ``s = min(1, cap / dm(1))``, ``s *= min(1, cap / dm(s))``
        with dm(s) the RMS of decode(p_old + s u) - m_old, and p = p_old +
        s u.  The optimizer's state advances unscaled, as optax's does.
        ``m_old`` is the deterministic decode before the step."""
        params = list(self.net.parameters())
        old = [p.detach().clone() for p in params]
        step()
        with torch.no_grad():
            upd = [p - o for p, o in zip(params, old)]

            def move(s):
                for p, o, u in zip(params, old, upd):
                    p.copy_(o + s * u)
                return torch.sqrt(torch.mean((self._decode() - m_old) ** 2))

            dm1 = move(1.0)
            s = torch.clamp(cap / (dm1 + 1e-20), max=1.0)
            s = s * torch.clamp(cap / (move(s) + 1e-20), max=1.0)
            for p, o, u in zip(params, old, upd):
                p.copy_(o + s * u)
        self.last_step_cap = {"cap": cap, "scale": s, "move": dm1}

    def holdout_misfit(self, fc=None) -> float:
        """``cfg.misfit`` on the held-out shots at continuation stage
        ``fc``, at the decoder's model: the unsupervised early-stopping
        metric ``loss_H``.  The path's forward makes the traces (on the
        fused path the ring forward, on the card its resident route at
        marmousi_elastic's grid)."""
        if self._holdout_idx is None:
            raise ValueError("holdout_misfit needs cfg.holdout_shots>0")
        wav, ovx, ovz = self._stage_data(fc)
        m = self._sample_model()[0]
        with torch.no_grad():
            return float(self._physics_loss_raw(
                m, self._holdout_idx, {"wav": wav, "ovx": ovx, "ovz": ovz}))

    def guard_revert(self, params: dict, epoch: int):
        """Drift-guard revert (``cfg.guard_patience``, train.py): load the
        parameter snapshot ``params`` (a state dict of clones), make a
        fresh optimizer, start the post-revert lr ramp at ``epoch`` and
        drop the trailing-tether reference."""
        self.net.load_state_dict(params)
        self.opt = _make_optimizer(self.cfg, self.net)
        self._guard_ramp_from = epoch
        self._tether_ref = None

    def physics_value_and_grad(self, m: torch.Tensor, fc: float = 0.0,
                               rho=None):
        """(loss, processed dJ/dm [nz, nx, F]) at model ``m`` ([nz, nx,
        F] or [1, nz, nx, F]) on all training shots at stage ``fc`` (0 =
        unfiltered), with the first physics epoch's field weights and
        tether.  ``rho`` replaces the density a two-field engine
        simulates with (its low-frequency rho): at the true vp, vs and
        rho the misfit of synthetic data is zero."""
        if m.ndim == 4:
            m = m[0]
        phys = self._phys(fc, self.cfg.lstart + 1, 0, self.lowf[0])
        return self._processed_value_and_grad(m.detach(), self._train_pool,
                                              phys, rho)

    @torch.no_grad()
    def _sample_model(self):
        """The decoder's model [1, nz, nx, F]."""
        return self._decode()

    def test(self):
        m = self._sample_model()
        mse = torch.mean((m - self.true_m) ** 2)
        return {"loss_V_MSE": float(mse)}, m[0].cpu().numpy()

    @torch.no_grad()
    def mc_realizations(self, n: int, seed: int = 0) -> np.ndarray:
        """MC-dropout posterior samples, numpy [n, nz, nx, F]: the latent
        of the observed gathers (the encoder has no dropout) repeated n
        times through one batched decoder pass, each copy with its own
        masks from a generator seeded with ``seed`` (GroupNorm is per
        sample, so the batch does not mix the copies)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        z = self.net.encode(self.in_vx, self.in_vz)
        deltas = self.net.decode(z.expand(n, -1), deterministic=False,
                                 generator=gen)
        return self._model(deltas).cpu().numpy()


_ENGINES: dict[str, Any] = {
    "acoustic_dip": AcousticDIPEngine,
    "elastic_dip": ElasticDIPEngine,
}


def create_engine(cfg: ExperimentConfig, **kw):
    """Factory by ``cfg.engine``."""
    if cfg.engine not in _ENGINES:
        raise NotImplementedError(
            f"engine {cfg.engine!r} is not ported yet (ROADMAP Queue A, "
            "item 9)")
    return _ENGINES[cfg.engine](cfg, **kw)
