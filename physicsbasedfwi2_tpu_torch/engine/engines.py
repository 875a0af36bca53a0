"""Inversion engines (port of ``physicsbasedfwi2_tpu/engine/engines.py``:
``EngineBase``, ``AcousticDIPEngine`` on its fused, "xla" and "encoded"
paths, ``ElasticDIPEngine`` on its fused, "fast" and "xla" paths with
held-out shots, the step cap, the drift guard's revert, illumination
preconditioning, gradient smoothing and MC dropout, Adam or L-BFGS in
both, SGLD or SGHMC in both, the VAE and flow generators' loss terms;
``MultiSampleAcousticDIPEngine``, the three with a rank mesh
(``mesh=``: shot sharding, ``parallel/``), ``ClassicFWIEngine``,
``LatentInversionEngine``, ``ImpedanceDIPEngine`` and the supervised/GAN
baselines' ``SupervisedEngine``; ``LrPolicy``, ``_make_optimizer``,
``_evict_stale_stages`` and ``create_engine``).

The JAX engines inject the processed physics gradient into the
generator's autodiff with a ``jax.custom_vjp``; here that is
:class:`_PhysicsLoss`, a ``torch.autograd.Function`` whose forward runs
the physics loss+gradient (the fused kernel B2 or B3 on CUDA, their
plain versions on CPU, or autograd through ``simulate_acoustic``,
``simulate_elastic_fast`` or ``simulate_elastic``) and the engine's
gradient processing, and whose backward returns the processed gradient.
"""

from __future__ import annotations

import functools
import os
from typing import Any

import numpy as np
import torch

from physicsbasedfwi2_tpu_torch.data.synthetic import (
    SyntheticAcousticWorkload, SyntheticElasticWorkload,
    acoustic_workload_from_disk, elastic_workload_from_disk,
    latent_workload_from_disk,
)
from physicsbasedfwi2_tpu_torch.device import default_device
from physicsbasedfwi2_tpu_torch.engine.config import ExperimentConfig
from physicsbasedfwi2_tpu_torch.geo.filters import lowpass_filter_time
from physicsbasedfwi2_tpu_torch.models import (
    apply_elastic_output, apply_generator, apply_velocity_output,
    define_discriminator, define_generator, gan_loss, kl_divergence,
    pack_output,
)
from physicsbasedfwi2_tpu_torch.models.convert import (
    npz_from_state_dict, state_dict_from_npz,
)
from physicsbasedfwi2_tpu_torch.models.vae import VaeNet
from physicsbasedfwi2_tpu_torch.ops import (
    acoustic_gradient, l1_misfit, l2_misfit, normalized_trace_misfit,
    simulate_acoustic, trace_normalize,
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
from physicsbasedfwi2_tpu_torch.ops.encoding import (
    encode_shots, encoded_fwi_gradient,
)
from physicsbasedfwi2_tpu_torch.ops.gradproc import (
    depth_weighting, rescale_to_model, smooth_spatial, taper_top, water_mask,
)
from physicsbasedfwi2_tpu_torch.ops.impedance import impedance_synthetic
from physicsbasedfwi2_tpu_torch.ops.scalar2 import forward2
from physicsbasedfwi2_tpu_torch.ops.ssim import ssim
from physicsbasedfwi2_tpu_torch.optim.lbfgs import lbfgs_wolfe
from physicsbasedfwi2_tpu_torch.optim.schedules import (
    PlateauController, make_scheduler,
)
from physicsbasedfwi2_tpu_torch.optim.sgmcmc import sghmc, sgld
from physicsbasedfwi2_tpu_torch.parallel import (
    all_gather, all_reduce, broadcast_module, pad_shots_for_fused,
    pad_shots_to_multiple, sample_shot_sharded_acoustic_gradient,
    shot_sharded_acoustic_gradient, shot_sharded_fused_acoustic_gradient,
)
from physicsbasedfwi2_tpu_torch.parallel.mesh import broadcast_
from physicsbasedfwi2_tpu_torch.parallel.shard import shot_block

# Offsets from cfg.seed of the engines' generators on the device, apart
# so that no two draw from one Philox stream: dropout masks (0), a VAE's
# latent noise (1), SG-MCMC noise (2).  The weights' generator (cfg.seed)
# is on the CPU.
_LATENT_SEED, _SGMCMC_SEED = 1, 2
# Offsets of CPU generators, as the JAX engines offset their keys: the
# elastic engine's shot draw (7), classic FWI's (11), the super-shot
# encoding (77)
_SHOT_SEED, _CLASSIC_SHOT_SEED, _ENCODING_SEED = 7, 11, 77


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _engine_device(device, workload, mesh=None) -> torch.device:
    """The device an engine runs on: ``device``, else its workload's,
    else its mesh rank's, else :func:`default_device` (the card; raises
    without one)."""
    if device is None:
        device = (workload.device if workload is not None
                  else mesh.device if mesh is not None
                  else default_device())
    dev = _resolve_device(device)
    if workload is not None and workload.device != dev:
        raise ValueError(f"workload lives on {workload.device}, engine "
                         f"on {dev}")
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

    def updates(self, loss_fn, process=None):
        """One L-BFGS iteration of ``loss_fn(params) -> (loss, *aux)``
        (``params`` None: the generator's own; else replacements by
        name): the value and gradient at the current parameters, then
        the line search, whose every probe evaluates the same loss's
        value and gradient, as the JAX engine's ``value_fn`` does.
        ``process`` maps the gradient list before it sets the direction
        (classic FWI's gradient processing; the probes' gradients stay
        raw, as in the JAX engine).  Returns (``loss_fn``'s outputs at the
        current parameters, the updates); :meth:`apply` takes the step."""
        out = loss_fn(None)
        grads = torch.autograd.grad(out[0], self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        if process is not None:
            grads = process(grads)

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
    """Checkpoint plumbing shared by the engines.

    :attr:`weights` is the module whose parameters the optimizer trains:
    the generator ``net``, or for the engines without one (classic FWI,
    latent inversion) ``params``, an ``nn.ParameterDict`` of their
    tensors by name."""

    cfg: ExperimentConfig
    net: torch.nn.Module

    @property
    def weights(self) -> torch.nn.Module:
        return self.net

    def save_networks(self, tag: str | int):
        """Save the trained weights as ``<tag>_net_G.npz`` with the JAX
        package's keys (loads in either package; no pickle)."""
        os.makedirs(self._dir(), exist_ok=True)
        path = os.path.join(self._dir(), f"{tag}_net_G.npz")
        np.savez(path, **self._npz_arrays())
        return path

    def load_networks(self, tag: str | int):
        """Restore weights saved by :meth:`save_networks` (by either
        package) into the engine."""
        path = os.path.join(self._dir(), f"{tag}_net_G.npz")
        with np.load(path) as z:
            self._load_npz_arrays({k: z[k] for k in z.files})
        return path

    def _npz_arrays(self) -> dict:
        return npz_from_state_dict(self.net.state_dict(), self.net)

    def _load_npz_arrays(self, arrays: dict) -> None:
        # raises on a missing key or shape
        self.net.load_state_dict(state_dict_from_npz(arrays))

    def _dir(self):
        return os.path.join(self.cfg.save_dir, self.cfg.name)


class _ParamsEngine(EngineBase):
    """An engine whose trained state is ``params``, an
    ``nn.ParameterDict`` (the JAX engine's ``params`` dict): its npz keys
    are ``['<name>']``, as ``jax.tree_util.keystr`` writes them."""

    params: torch.nn.ParameterDict

    @property
    def weights(self) -> torch.nn.Module:
        return self.params

    def _npz_arrays(self) -> dict:
        return {f"['{k}']": v.detach().cpu().numpy()
                for k, v in self.params.items()}

    def _load_npz_arrays(self, arrays: dict) -> None:
        # raises on a missing key or shape
        self.params.load_state_dict({k: torch.as_tensor(arrays[f"['{k}']"])
                                     for k in self.params})


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
    CUDA and their plain versions on CPU; with ``encoded_shots`` > 0 the
    "encoded" path: every step a fresh random-polarity encoding of the
    shots into that many super-shots (:meth:`encoding`, from a CPU
    generator seeded ``cfg.seed + 77``), the misfit of the raw
    super-gathers (``ops/encoding.py``), receivers common to all shots
    required; otherwise the JAX engine's "xla" path, autograd through
    :func:`simulate_acoustic`.  Frequency continuation swaps the physics
    data per stage
    (:meth:`_stage_data`); ``wavelet_from_data`` (AutoWav) on a synthetic
    workload gives every shot its own copy of the wavelet.

    A VAE generator (``netG`` starting with "vae") samples its latent on
    every training decode from a generator of its own on the engine's
    device (every other decode takes z = mu), and the loss gains
    ``kl_weight`` times the KL term (minus the mean flow log-det for the
    planar-flow VAEs); a generator with a flow log-det and no KL term
    (AutoNF) adds ``flow_weight`` times the latent's negative
    log-likelihood 0.5 |z|^2 - log|det|.

    With ``mesh`` (``parallel.make_mesh``, a "shot" axis) every rank
    builds the same engine, takes rank 0's weights, and runs the physics
    on its block of the shots, the shot axis padded to the mesh: kernel
    B2 per rank ("fused+mesh", :func:`shot_sharded_fused_acoustic_gradient`)
    or autograd through :func:`simulate_acoustic` ("sharded-xla",
    :func:`shot_sharded_acoustic_gradient`); one all-reduce of the
    detached loss and gradient then leaves the step the same on every
    rank.  The "encoded" path runs whole on every rank.
    """

    def __init__(self, cfg: ExperimentConfig, workload=None, mesh=None,
                 val_workload=None, *, device=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = _engine_device(device, workload, mesh)
        if workload is None and cfg.dataroot:
            workload = acoustic_workload_from_disk(
                cfg.dataroot, wavelet_from_data=cfg.wavelet_from_data,
                **_acoustic_disk_kw(cfg), device=self.device)
        # (water_rows is not passed, as in the JAX engine: ROADMAP Queue C)
        self.wl = workload or SyntheticAcousticWorkload.build(
            nz=cfg.nz, nx=cfg.nx, dx=cfg.dx, nt=cfg.nt, dt=cfg.dt,
            pml_width=cfg.pml_width, freq=cfg.freq,
            num_shots=cfg.num_shots, num_receivers=cfg.num_receivers,
            seed=cfg.seed, chunk=cfg.chunk, device=self.device)
        if cfg.wavelet_from_data and self.wl.wavelet.ndim == 1:
            # AutoWav on a synthetic workload: the per-shot wavelet array
            # [ns, nt] that stored data would carry
            ns = int(self.wl.acq.src_z.shape[0])
            self.wl.wavelet = self.wl.wavelet[None].expand(
                ns, -1).contiguous()
        acq = self.wl.acq
        single_row = bool((acq.rcv_z == acq.rcv_z[:, :1]).all())
        self._encoded = cfg.encoded_shots > 0
        if self._encoded and not ((acq.rcv_z == acq.rcv_z[:1]).all()
                                  and (acq.rcv_x == acq.rcv_x[:1]).all()):
            # every super-shot records on shot 0's spread
            # (encoded_fwi_gradient): a per-shot layout would get a wrong
            # gradient
            raise ValueError(
                "encoded_shots>0 requires an identical receiver spread "
                "(rcv_z/rcv_x) across all shots; this workload's geometry "
                "varies per shot")
        why = [w for cond, w in (
            (cfg.backend not in ("pallas", "auto"),
             f"backend={cfg.backend}"),
            (cfg.misfit != "l1", f"misfit={cfg.misfit}"),
            (not single_row, "multi-row receivers"),
            (self._encoded, "encoded_shots")) if cond]
        # the fused path runs kernel B2 on the card and its plain version
        # on the CPU; otherwise the JAX engine's "xla" path (autograd
        # through simulate_acoustic) or, with encoded_shots, its "encoded"
        # path (super-shots, ops/encoding.py): plain PyTorch on either
        # device
        self._use_fused = not why
        if self._use_fused:
            self.physics_path = (
                "fused+mesh" if mesh is not None else
                "fused-cuda" if self.device.type == "cuda" else "fused-plain")
            _log_path(cfg.name, "acoustic", self.physics_path)
        elif self._encoded:
            self.physics_path = "encoded"
            _log_path(cfg.name, "acoustic", self.physics_path)
        else:
            self.physics_path = "sharded-xla" if mesh is not None else "xla"
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
        if mesh is not None:
            broadcast_module(self.net, mesh)
        self.is_vae = cfg.netG.lower().startswith("vae")
        # net input: [1, nt, nr, ns] (NHWC, as the JAX engine feeds it)
        self.shots_in = self.wl.obs.permute(1, 2, 0)[None].contiguous()
        self.true_b = self.wl.vp_true[None, :, :, None]
        self.val_wl = val_workload
        if self.val_wl is None and cfg.validate_on_twin:
            self.val_wl = self._build_val_twin()
        self.opt = _make_optimizer(cfg, self.net)
        self.lr_policy = LrPolicy(cfg) if cfg.optimizer == "adam" else None
        self._drop_gen = _dropout_generator(cfg, self.device)
        self._latent_gen = _latent_generator(cfg, self.device, self.is_vae)
        # encoded_shots: a fresh encoding every step (the JAX engine's key
        # comes from its step rng, so the packages encode differently)
        self._enc_gen = (
            torch.Generator().manual_seed(cfg.seed + _ENCODING_SEED)
            if self._encoded else None)
        self._build_physics()

    def _build_val_twin(self):
        """The validation twin (the reference's create_dataset2 Test
        dataset): a dataroot's ``test`` sample, None when it has no
        ``testA`` (the training sample then validates); without a
        dataroot, the synthetic workload of seed ``cfg.seed + 101``."""
        cfg = self.cfg
        if cfg.dataroot:
            if not os.path.isdir(os.path.join(cfg.dataroot, "testA")):
                return None
            return acoustic_workload_from_disk(
                cfg.dataroot, **_acoustic_disk_kw(cfg), phase="test",
                device=self.device)
        return SyntheticAcousticWorkload.build(
            nz=cfg.nz, nx=cfg.nx, dx=cfg.dx, nt=cfg.nt, dt=cfg.dt,
            pml_width=cfg.pml_width, freq=cfg.freq,
            num_shots=cfg.num_shots, num_receivers=cfg.num_receivers,
            seed=cfg.seed + 101, chunk=cfg.chunk, device=self.device)

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

    def _shard(self, pd):
        """With a mesh, pad the shot axis of the physics data ``pd`` to
        it: kernel B2's operands on the fused path (zero wavelet and rows
        for the pad shots, the padded wavelet as ``pd["wavp"]``, the
        padded geometry and the shot counts in ``_fused_pad``), else the
        geometry, observed gathers and direct wave (``pd["padded"]``),
        with the real shots' ``pd["mask"]``."""
        mesh = self.mesh
        if mesh is None or self._encoded:
            return pd
        n = mesh.shape["shot"]
        if self._use_fused:
            (pd["wavp"], *geom, pd["obs_rows"], pd["dir_rows"]), ns, ns_pad \
                = pad_shots_for_fused(pd["wav"], *self.wl.geom,
                                      pd["obs_rows"], pd["dir_rows"], n)
            self._fused_pad = (*geom, ns, ns_pad)
        else:
            arrays = [*self.wl.geom, pd["obs_norm"]]
            if pd["direct"] is not None:
                arrays.append(pd["direct"])
            pd["padded"], pd["mask"] = pad_shots_to_multiple(arrays, n)
        return pd

    def _build_physics(self):
        """The base physics data (the full band: wavelet, normalized
        observed gathers, direct wave and, on the fused path, the
        kernel's rows), the stage cache, and the validation inputs."""
        wl = self.wl
        self._phys = {"wav": wl.wavelet, "obs_norm": wl.obs_norm,
                      "direct": self._direct}
        if self._encoded:
            # the super-gathers combine the raw per-shot gathers linearly
            self._phys["obs"] = wl.obs
        if self._use_fused:
            self._kernel_rows(self._phys, self._dir_rows)
        self._shard(self._phys)
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
        engine's ``_stage_phys_pd``):
        the wavelet, the observed gathers (then trace-normalized) and the
        direct wave low-passed at ``fc`` once per stage (by linearity
        simulating with the filtered wavelet equals filtering the
        prediction), and on the fused path the kernel's rows rebuilt from
        them, padded to the mesh (:meth:`_shard`).  ``fc <= 0`` returns
        the base data; a new stage evicts the cached ones."""
        key = float(fc or 0.0)
        if key <= 0.0:
            return self._phys
        if key not in self._stage_cache:
            dt, wl = self.cfg.dt, self.wl
            pd = dict(self._phys)
            pd["wav"] = lowpass_filter_time(wl.wavelet, key, dt, axis=-1)
            obs = lowpass_filter_time(wl.obs, key, dt, axis=1)
            pd["obs_norm"] = trace_normalize(obs)
            if self._encoded:
                pd["obs"] = obs
            if self._direct is not None:
                pd["direct"] = lowpass_filter_time(self._direct, key, dt,
                                                   axis=1)
            if self._use_fused:
                dir_rows = (None if self._dir_rows is None else
                            lowpass_filter_time(self._dir_rows, key, dt,
                                                axis=1))
                self._kernel_rows(pd, dir_rows)
            self._shard(pd)
            _evict_stale_stages(self._stage_cache, key)
            self._stage_cache[key] = pd
        return self._stage_cache[key]

    def encoding(self):
        """A fresh super-shot encoding (groups, polarities) from the
        engine's generator (``encoded_shots > 0``)."""
        return encode_shots(int(self.wl.acq.src_z.shape[0]),
                            self.cfg.encoded_shots, self._enc_gen)

    def physics_value_and_grad(self, vp: torch.Tensor, fc: float = 0.0,
                               encoding=None):
        """(loss, processed dJ/dvp) at stage ``fc`` (0 = full band): the
        fused loss+gradient (B2), on the "encoded" path the super-shots'
        (``encoding``, else a fresh one), or on the "xla" path autograd
        through :func:`simulate_acoustic`, each on this rank's shots with
        a mesh, all-reduced; then depth^2 weighting, the water mask and
        ``grad_scale``."""
        cfg, wl = self.cfg, self.wl
        pd = self._stage_data(fc)
        if self._encoded:
            groups, pol = encoding or self.encoding()
            loss, grad = encoded_fwi_gradient(
                vp, pd["obs"], pd["wav"], *self._geom, wl.cfg,
                cfg.encoded_shots, groups=groups, pol=pol, misfit=cfg.misfit)
        elif self._use_fused and self.mesh is not None:
            *geom, ns, ns_pad = self._fused_pad
            loss, grad = shot_sharded_fused_acoustic_gradient(
                self.mesh, vp, pd["wavp"], *geom, wl.cfg, pd["obs_rows"],
                pd["dir_rows"])
            # each rank's call normalizes by its padded shot count
            loss, grad = loss * (ns_pad / ns), grad * (ns_pad / ns)
        elif self._use_fused:
            loss, grad = fwi_l1_loss_grad(vp, pd["wav"], *self._geom,
                                          wl.cfg, pd["obs_rows"],
                                          pd["dir_rows"])
        elif self.mesh is not None:
            sz, sx, rz, rx, obs, *direct = pd["padded"]
            loss, grad = shot_sharded_acoustic_gradient(
                self.mesh, vp, obs, pd["wav"], sz, sx, rz, rx, wl.cfg,
                misfit=cfg.misfit, shot_mask=pd["mask"],
                direct=direct[0] if direct else None)
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

    def physics_loss(self, vp: torch.Tensor, fc: float = 0.0,
                     encoding=None) -> torch.Tensor:
        """Differentiable physics loss of vp [nz, nx] at stage ``fc``."""
        return _PhysicsLoss.apply(
            vp, lambda v: self.physics_value_and_grad(v, fc, encoding))

    def _total_loss(self, use_physics: bool, fc: float = 0.0, params=None,
                    generator=None, encoding=None):
        """(loss, model MSE) of the generator (with its parameters
        replaced by ``params`` where given; its random draws, a VAE's
        latent noise or dropout masks, from ``generator``; the
        super-shot ``encoding`` of the step)."""
        cfg = self.cfg
        out = pack_output(_call(self.net, params, self.shots_in,
                                generator=generator))
        vp = apply_velocity_output(out.field, self.true_b,
                                   water_vel=cfg.water_vel)[0, :, :, 0]
        model_mse = torch.mean((vp - self.wl.vp_true) ** 2)
        if use_physics:
            loss = self.physics_loss(vp, fc, encoding)
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
        # every step draws a new encoding, as the JAX engine splits a key
        enc = self.encoding() if self._encoded else None
        if isinstance(self.opt, _Lbfgs):
            # the line search's probes evaluate the same loss (on the
            # card kernel B2 once a probe) with the same draws and
            # encoding
            (loss, model_mse), upd = self.opt.updates(
                lambda params: self._total_loss(use_physics, fc, params,
                                                draws(), enc))
            self.opt.apply(upd)
        else:
            _set_lr(self, epoch)
            self.opt.zero_grad(set_to_none=True)
            loss, model_mse = self._total_loss(use_physics, fc, None,
                                               draws(), enc)
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


def _acoustic_disk_kw(cfg: ExperimentConfig) -> dict:
    """The grid arguments of the acoustic from-disk loaders."""
    return dict(nz=cfg.nz, nx=cfg.nx, dx=cfg.dx, nt=cfg.nt, dt=cfg.dt,
                pml_width=cfg.pml_width, freq=cfg.freq, chunk=cfg.chunk)


def _elastic_from_disk(cfg: ExperimentConfig, device):
    """``cfg.dataroot``'s elastic workload, on ``device``, with the
    config's acquisition extras."""
    return elastic_workload_from_disk(
        cfg.dataroot, nz=cfg.nz, nx=cfg.nx, dx=cfg.dx, nt=cfg.nt,
        dt=cfg.dt, pml_width=cfg.pml_width, freq=cfg.freq,
        free_surface=cfg.free_surface, chunk=cfg.chunk,
        water_rows=cfg.water_rows,
        src_depth_row=cfg.extras.get("src_depth_row"),
        rcv_depth_row=cfg.extras.get("rcv_depth_row"),
        rcv_follow_seabed=cfg.extras.get("rcv_follow_seabed", False),
        device=device)


def elastic_workload(cfg: ExperimentConfig, device):
    """The workload an :class:`ElasticDIPEngine` builds from ``cfg`` when
    it is given none: ``cfg.dataroot``'s, or the synthetic one."""
    if cfg.dataroot:
        return _elastic_from_disk(cfg, device)
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

    With ``mesh`` (a "shot" axis whose size divides ``shots_per_iter``;
    DENISE's 30 MPI ranks, networks.py:7709-7710) every rank takes rank
    0's weights and shot subset and runs the path on its block of the
    subset (B3 per rank on the fused path), then a mean all-reduce of
    the loss and gradient; the path's name gains "+mesh".
    """

    def __init__(self, cfg: ExperimentConfig, workload=None, mesh=None, *,
                 device=None):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            nsub = cfg.shots_per_iter or cfg.num_shots
            n_dev = mesh.shape["shot"]
            if nsub % n_dev:
                raise ValueError(
                    f"shots_per_iter ({nsub}) must be divisible by the "
                    f"mesh shot axis ({n_dev}): pick e.g. "
                    f"shots_per_iter={-(-nsub // n_dev) * n_dev}")
        self.device = _engine_device(device, workload, mesh)
        self.wl = workload or elastic_workload(cfg, self.device)
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
            base, self._sim = "fused", simulate_elastic_ring
        elif cfg.backend in ("auto", "fast", "pallas"):
            base, self._sim = "fast", simulate_elastic_fast
        else:
            base, self._sim = "xla", simulate_elastic
        if mesh is not None:
            self.physics_path = base + "+mesh"
        elif self._use_fused:
            self.physics_path = ("fused-cuda" if self.device.type == "cuda"
                                 else "fused-plain")
        else:
            self.physics_path = base
        _log_path(cfg.name, "elastic", self.physics_path,
                  "fused unavailable: " + ", ".join(why) if why else "")
        if base != "xla" and not self.wl.from_disk:
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
        if mesh is not None:
            broadcast_module(self.net, mesh)
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
        self._shot_gen = torch.Generator().manual_seed(cfg.seed + _SHOT_SEED)
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

    def _physics_loss_raw(self, m, shot_idx, pd, rho=None, sim=None):
        """The misfit of m [nz, nx, F] on a shot subset, from the path's
        operator (the ring forward on the fused path: no gradient;
        autograd through the fast or split-PML propagator otherwise) or
        from ``sim``, a propagator of the same signature:
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
        pvx, pvz = (sim or self._sim)(m[..., 0], m[..., 1], rho, wav, sz, sx,
                                      rz, rx, wl.cfg)
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

    def _sharded_value_and_grad(self, m, shot_idx, pd, rho=None):
        """(loss, dJ/dm) with the shot subset sharded over the mesh's
        "shot" axis: the path's value and gradient (B3 on the fused
        path) on this rank's block, then a mean all-reduce (each block's
        misfit is a mean over its shots)."""
        blk = shot_block(self.mesh, "shot", int(shot_idx.shape[0]))
        local = (self._fused_value_and_grad if self._use_fused
                 else self._autograd_value_and_grad)
        loss, gm = local(m, shot_idx[blk], pd, rho)
        return (all_reduce(loss, self.mesh, "shot", mean=True),
                all_reduce(gm, self.mesh, "shot", mean=True))

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
        value_and_grad = (
            self._sharded_value_and_grad if self.mesh is not None
            else self._fused_value_and_grad if self._use_fused
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
        if self.mesh is not None:
            # every rank runs rank 0's subset
            broadcast_(idx, self.mesh)
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


def _first_order_optimizer(cfg: ExperimentConfig, weights: torch.nn.Module,
                           what: str):
    """:func:`_make_optimizer` for an engine whose JAX step hands the
    optimizer no loss value (Adam, SGLD, SGHMC): L-BFGS needs one."""
    if cfg.optimizer == "lbfgs":
        raise ValueError(f"{what} takes adam, sgld or sghmc, not lbfgs")
    return _make_optimizer(cfg, weights)


def _step(opt, loss: torch.Tensor) -> None:
    """One first-order step of ``opt`` on ``loss``."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()


def _epoch_record(engine, losses: dict) -> dict:
    """``losses`` (0-d tensors) as floats, one device sync for all, with
    the lr policy's ``lr`` after the first loss where the engine has one."""
    vals = torch.stack([v.detach() for v in losses.values()]).tolist()
    out = dict(zip(losses, vals))
    if engine.lr_policy is not None:
        out["lr"] = engine.lr_policy.after_epoch(vals[0])
    return out


def _set_lr(engine, epoch: int) -> None:
    """The lr policy's lr for ``epoch`` into every param group."""
    if engine.lr_policy is not None:
        lr = engine.lr_policy.lr_for_epoch(epoch)
        for group in engine.opt.param_groups:
            group["lr"] = lr


class MultiSampleAcousticDIPEngine(EngineBase):
    """One generator trained on a batch of acoustic FWI samples
    (``engine="acoustic_dip_multi"``): the generator runs over the batch,
    and the physics is a loop over the samples (the JAX engine's vmap,
    "xla-loop"): each sample's trace-normalized misfit by autograd
    through :func:`simulate_acoustic`, their mean the loss.  With a
    {sample, shot} ``mesh`` (``parallel.make_mesh2d``) each rank takes
    rank 0's weights, runs the generator on the whole batch and the
    physics on its block of samples and shots
    (:func:`sample_shot_sharded_acoustic_gradient`,
    "sample-shot-sharded"), and gathers the per-sample gradients over the
    sample axis.  Each sample's dJ/dvp gets depth^2 weighting and its
    own water mask, times ``grad_scale``, through :class:`_PhysicsLoss`.

    One direct wave (the constant water model is the same for every
    sample) is subtracted from every prediction and from the gathers of
    the synthetic samples.  The observed batch [S, ns, nt, nr] is
    trace-normalized over its axis 1, the shots, as the JAX engine does
    (ROADMAP Queue C).  Epochs up to ``lstart`` train on the model MSE.
    """

    def __init__(self, cfg: ExperimentConfig, workloads=None, mesh=None,
                 n_samples: int = 2, *, device=None):
        if mesh is not None and not {"sample", "shot"} <= set(mesh.shape):
            raise ValueError("the multi-sample engine takes a {sample, shot} "
                             "mesh (parallel.make_mesh2d)")
        self.cfg = cfg
        self.mesh = mesh
        self.device = _engine_device(
            device, workloads[0] if workloads else None, mesh)
        if workloads is None:
            workloads = [SyntheticAcousticWorkload.build(
                nz=cfg.nz, nx=cfg.nx, dx=cfg.dx, nt=cfg.nt, dt=cfg.dt,
                pml_width=cfg.pml_width, freq=cfg.freq,
                num_shots=cfg.num_shots, num_receivers=cfg.num_receivers,
                seed=cfg.seed + i, chunk=cfg.chunk, device=self.device)
                for i in range(n_samples)]
        for w in workloads:
            _engine_device(self.device, w)  # raises off the engine's device
        self.wls = workloads
        wl0 = workloads[0]
        self._geom, self._wcfg, self._wav = wl0.geom, wl0.cfg, wl0.wavelet
        self.vp_true = torch.stack([w.vp_true for w in workloads])
        obs = torch.stack([w.obs for w in workloads])
        self._direct = None
        if cfg.direct_wave:
            const = torch.full_like(wl0.vp_true, cfg.water_vel)
            with torch.no_grad():
                self._direct = simulate_acoustic(const, self._wav,
                                                 *self._geom, self._wcfg)
            # stored gathers lack the direct arrival; synthetic ones lose
            # it here, per sample
            synth = torch.tensor([0.0 if w.from_disk else 1.0
                                  for w in workloads], device=self.device)
            obs = obs - synth[:, None, None, None] * self._direct[None]
        self.obs = obs
        self.obs_norm = trace_normalize(obs)
        self.shots_in = obs.permute(0, 2, 3, 1).contiguous()
        self.true_b = self.vp_true[..., None]
        ns, nt, nr = obs.shape[1:]
        self.net = define_generator(
            cfg.netG, out_shape=(cfg.nz, cfg.nx), in_shape=(nt, nr, ns),
            latent_dim=cfg.latent_dim, filters=cfg.filters,
            time_decimation=cfg.time_decimation,
            generator=torch.Generator().manual_seed(cfg.seed),
        ).to(self.device)
        if mesh is not None:
            broadcast_module(self.net, mesh)
        self.opt = _first_order_optimizer(cfg, self.net,
                                          "the multi-sample engine")
        self.lr_policy = LrPolicy(cfg) if cfg.optimizer == "adam" else None
        self.physics_path = ("sample-shot-sharded" if mesh is not None
                             else "xla-loop")
        _log_path(cfg.name, "multi-sample acoustic", self.physics_path)

    def physics_value_and_grad(self, vps: torch.Tensor):
        """(mean over the samples of each one's misfit, processed dJ/dvps
        [S, nz, nx]) at the models ``vps``."""
        cfg = self.cfg
        if self.mesh is not None:
            loss, raw = sample_shot_sharded_acoustic_gradient(
                self.mesh, vps, self.obs_norm, self._wav, *self._geom,
                self._wcfg, misfit=cfg.misfit, direct=self._direct)
            raw = all_gather(raw, self.mesh, "sample")
        else:
            mis = l1_misfit if cfg.misfit == "l1" else l2_misfit
            # the mean's cotangent of each sample's loss
            ct = torch.tensor(1.0 / vps.shape[0], device=vps.device)
            losses, raw = [], []
            for vp, obs_norm in zip(vps, self.obs_norm):
                with torch.enable_grad():
                    v = vp.detach().requires_grad_(True)
                    pred = simulate_acoustic(v, self._wav, *self._geom,
                                             self._wcfg)
                    if self._direct is not None:
                        pred = pred - self._direct
                    loss = mis(trace_normalize(pred), obs_norm)
                    (g,) = torch.autograd.grad(loss, v, ct)
                losses.append(loss.detach())
                raw.append(g)
            loss = torch.mean(torch.stack(losses))
        grads = [water_mask(depth_weighting(g, 2.0), true, cfg.water_vel)
                 for g, true in zip(raw, self.vp_true)]
        return loss, torch.stack(grads) * cfg.grad_scale

    def _decode(self):
        out = pack_output(self.net(self.shots_in))
        return apply_velocity_output(out.field, self.true_b,
                                     water_vel=self.cfg.water_vel)[..., 0]

    def optimize_parameters(self, epoch: int):
        _set_lr(self, epoch)
        use_physics = epoch > self.cfg.lstart
        vps = self._decode()
        mse = torch.mean((vps - self.vp_true) ** 2)
        # up to lstart the model-MSE oracle, as the single-sample engine
        loss = (_PhysicsLoss.apply(vps, self.physics_value_and_grad)
                if use_physics else mse)
        _step(self.opt, loss)
        return _epoch_record(self, {"loss_D" if use_physics else "loss_M":
                                    loss, "loss_M_MSE": mse})

    @torch.no_grad()
    def test(self):
        vps = self._decode()
        mse = torch.mean((vps - self.vp_true) ** 2)
        return {"loss_V_MSE": float(mse)}, vps.cpu().numpy()


class ClassicFWIEngine(_ParamsEngine):
    """Classic FWI: the model grids are the parameters (``params``).

    Acoustic workloads invert vp: the trace-normalized ``l1``/``l2``
    misfit of :func:`simulate_acoustic` (plain autograd, the JAX engine's
    XLA path, neither B2's nor B5/B6's scheme), the gradient water-masked
    and depth^2-weighted, vp clipped to [1490, 4700] after each step.

    Elastic workloads (``dataset_mode`` ending in "El") invert vp and vs
    from the low-frequency model with rho held there: the raw L2 of the
    vx and vz gathers on ``shots_per_iter`` shots a step, drawn from a
    ``torch.Generator`` seeded ``cfg.seed + 11`` (the JAX engine's
    ``jax.random`` key of that seed draws other shots), through
    :func:`simulate_elastic_fast` (``backend`` "auto"/"fast", the obs
    regenerated with it) or the split-PML :func:`simulate_elastic`; each
    gradient's water rows tapered and the gradient rescaled to its
    field's magnitude, vp clipped to [1490, 4700] and vs to [0, 2700].

    Adam, SGLD, SGHMC or L-BFGS; L-BFGS takes its direction from the
    processed gradient and its line-search probes re-evaluate the raw
    loss on the step's shots, as the JAX engine's ``value_fn`` does.
    """

    def __init__(self, cfg: ExperimentConfig, workload=None, *,
                 device=None):
        self.cfg = cfg
        self.is_elastic = cfg.dataset_mode.lower().endswith("el")
        self.device = _engine_device(device, workload)
        self.lr_policy = LrPolicy(cfg) if cfg.optimizer == "adam" else None
        if self.is_elastic:
            self._init_elastic(workload)
        else:
            self._init_acoustic(workload)
        self._geom = self.wl.geom
        self.opt = _make_optimizer(cfg, self.params)

    def _init_acoustic(self, workload):
        cfg = self.cfg
        self.wl = workload or SyntheticAcousticWorkload.build(
            nz=cfg.nz, nx=cfg.nx, dx=cfg.dx, nt=cfg.nt, dt=cfg.dt,
            pml_width=cfg.pml_width, freq=cfg.freq,
            num_shots=cfg.num_shots, num_receivers=cfg.num_receivers,
            seed=cfg.seed, chunk=cfg.chunk, device=self.device)
        self.physics_path = "xla"
        self.params = torch.nn.ParameterDict(
            {"vp": self.wl.vp_start.clone()})

    def _init_elastic(self, workload):
        cfg = self.cfg
        if workload is None and cfg.dataroot:
            workload = _elastic_from_disk(cfg, self.device)
        self.wl = wl = workload or SyntheticElasticWorkload.build(
            nz=cfg.nz, nx=cfg.nx, dx=cfg.dx, nt=cfg.nt, dt=cfg.dt,
            pml_width=cfg.pml_width, freq=cfg.freq,
            num_shots=cfg.num_shots, num_receivers=cfg.num_receivers,
            seed=cfg.seed, chunk=cfg.chunk, free_surface=cfg.free_surface,
            water_rows=cfg.water_rows, device=self.device)
        if cfg.backend in ("auto", "fast"):
            self.physics_path, self._sim = "fast", simulate_elastic_fast
            if not wl.from_disk:
                with torch.no_grad():
                    wl.obs_vx, wl.obs_vz = self._sim(
                        wl.true["vp"], wl.true["vs"], wl.true["rho"],
                        wl.wavelet, *wl.geom, wl.cfg)
        else:
            self.physics_path, self._sim = "xla", simulate_elastic
        self.params = torch.nn.ParameterDict(
            {"vp": wl.start["vp"].clone(), "vs": wl.start["vs"].clone()})
        self.n_shots = int(wl.acq.src_z.shape[0])
        self._nsub = cfg.shots_per_iter or self.n_shots
        self._shot_gen = torch.Generator().manual_seed(
            cfg.seed + _CLASSIC_SHOT_SEED)

    def _draw_shots(self) -> torch.Tensor:
        """This step's shot subset (``shots_per_iter`` of the shots)."""
        perm = torch.randperm(self.n_shots, generator=self._shot_gen)
        return perm[: self._nsub].to(self.device)

    def _loss(self, params=None, shot_idx=None):
        """(the data misfit,) at ``params`` (by name; None: the
        engine's), on ``shot_idx`` for an elastic workload."""
        p = self.params if params is None else params
        wl = self.wl
        if not self.is_elastic:
            pred = simulate_acoustic(p["vp"], wl.wavelet, *self._geom, wl.cfg)
            mis = l1_misfit if self.cfg.misfit == "l1" else l2_misfit
            return (mis(trace_normalize(pred), wl.obs_norm),)
        sz, sx, rz, rx = (a[shot_idx] for a in self._geom)
        pvx, pvz = self._sim(p["vp"], p["vs"], wl.start["rho"], wl.wavelet,
                             sz, sx, rz, rx, wl.cfg)
        return (torch.mean((pvx - wl.obs_vx[shot_idx]) ** 2)
                + torch.mean((pvz - wl.obs_vz[shot_idx]) ** 2),)

    def _process(self, grads: list) -> list:
        """The JAX engine's gradient processing: acoustic, the water mask
        then depth^2; elastic, per field the water-row taper then the
        rescale to the field's magnitude."""
        cfg = self.cfg
        if not self.is_elastic:
            g = water_mask(grads[0], self.wl.vp_true, cfg.water_vel)
            return [depth_weighting(g, 2.0)]
        return [rescale_to_model(taper_top(g, cfg.water_rows), p.detach())
                for g, p in zip(grads, self.params.values())]

    def optimize_parameters(self, epoch: int, freq: float | None = None,
                            tether_stage: int | None = None):
        """One step.  ``freq`` and ``tether_stage`` are accepted for the
        train loop's sake and not used, as in the JAX engine."""
        _set_lr(self, epoch)
        idx = self._draw_shots() if self.is_elastic else None

        def loss_fn(params):
            return self._loss(params, idx)

        if isinstance(self.opt, _Lbfgs):
            (loss,), upd = self.opt.updates(loss_fn, self._process)
            self.opt.apply(upd)
        else:
            (loss,) = loss_fn(None)
            weights = list(self.params.values())
            grads = torch.autograd.grad(loss, weights)
            for p, g in zip(weights, self._process(list(grads))):
                p.grad = g
            self.opt.step()
        with torch.no_grad():
            self.params["vp"].clamp_(1490.0, 4700.0)
            if self.is_elastic:
                self.params["vs"].clamp_(0.0, 2700.0)
        return _epoch_record(self, {"loss_D_MSE": loss,
                                    "loss_M_MSE": self._model_mse()})

    @torch.no_grad()
    def _model_mse(self) -> torch.Tensor:
        if not self.is_elastic:
            return torch.mean((self.params["vp"] - self.wl.vp_true) ** 2)
        return sum(torch.mean((self.params[k] - self.wl.true[k]) ** 2)
                   for k in ("vp", "vs"))

    def test(self):
        mse = float(self._model_mse())
        if self.is_elastic:
            m = torch.stack([self.params["vp"], self.params["vs"]], -1)
            return {"loss_V_MSE": mse}, m.detach().cpu().numpy()
        return {"loss_V_MSE": mse}, self.params["vp"].detach().cpu().numpy()


class LatentInversionEngine(_ParamsEngine):
    """Latent-space inversion (BASELINE config 4): a frozen decoder, and
    the latent ``z`` [1, latent_dim] (``params["z"]``, zeros at the start)
    the only parameter, optimized through decoder, velocity map and
    :func:`simulate_acoustic` by plain autograd: the ``l1``/``l2`` misfit
    of the trace-normalized prediction.

    ``decoder_net`` is a pretrained model-domain VAE
    (:func:`engine.pretrain.pretrain_model_vae`; moved to the engine's
    device and frozen in place) with ``decoder_norm`` = (vmin, vmax)
    mapping its [0, 1] output to velocities; without one a fresh
    :class:`VaeNet` for the observed gathers, seeded ``cfg.seed``, with
    the true model's range.

    The JAX engine has no ``params``, so its ``save_networks`` raises
    (ROADMAP Queue C); here ``save_networks``/``load_networks`` write and
    read ``z`` under the key ``['z']``, the one the JAX save would write
    for ``params = {"z": z}``.
    """

    def __init__(self, cfg: ExperimentConfig, workload=None,
                 decoder_net: torch.nn.Module | None = None,
                 decoder_norm: tuple[float, float] | None = None, *,
                 device=None):
        self.cfg = cfg
        self.device = _engine_device(device, workload)
        if workload is None and cfg.dataroot:
            # the reference's latent workload consumed real npy data
            # (unalignedVelLatent2_dataset.py)
            workload = latent_workload_from_disk(
                cfg.dataroot, **_acoustic_disk_kw(cfg),
                sample=int(cfg.extras.get("latent_sample", 0)),
                device=self.device)
        self.wl = wl = workload or SyntheticAcousticWorkload.build(
            nz=cfg.nz, nx=cfg.nx, dx=cfg.dx, nt=cfg.nt, dt=cfg.dt,
            pml_width=cfg.pml_width, freq=cfg.freq,
            num_shots=cfg.num_shots, num_receivers=cfg.num_receivers,
            seed=cfg.seed, chunk=cfg.chunk, device=self.device)
        # [1, nt, nr, ns], the fresh decoder's input shape
        self.shots_in = wl.obs.permute(1, 2, 0)[None].contiguous()
        if decoder_net is None:
            decoder_net = VaeNet(
                out_shape=(cfg.nz, cfg.nx), in_shape=self.shots_in.shape[1:],
                latent_dim=cfg.latent_dim, filters=cfg.filters,
                generator=torch.Generator().manual_seed(cfg.seed))
        self.net = decoder_net.to(self.device).requires_grad_(False)
        self.decoder_norm = decoder_norm
        latent_dim = getattr(self.net, "latent_dim", cfg.latent_dim)
        self.params = torch.nn.ParameterDict(
            {"z": torch.zeros((1, latent_dim), device=self.device)})
        self.opt = _first_order_optimizer(cfg, self.params,
                                          "the latent engine")
        self.lr_policy = LrPolicy(cfg) if cfg.optimizer == "adam" else None
        self.physics_path = "xla"
        self._geom = wl.geom
        self._true_b = wl.vp_true[None, :, :, None]

    def _velocity(self, **kw) -> torch.Tensor:
        """The decoded velocity model [nz, nx] of ``z``."""
        vmin, vmax = self.decoder_norm or (None, None)
        f01 = self.net.decode(self.params["z"])
        return apply_velocity_output(f01, self._true_b, vmin=vmin,
                                     vmax=vmax, **kw)[0, :, :, 0]

    def optimize_parameters(self, epoch: int):
        _set_lr(self, epoch)
        wl = self.wl
        vp = self._velocity(water_vel=self.cfg.water_vel)
        pred = simulate_acoustic(vp, wl.wavelet, *self._geom, wl.cfg)
        mis = l1_misfit if self.cfg.misfit == "l1" else l2_misfit
        loss = mis(trace_normalize(pred), wl.obs_norm)
        _step(self.opt, loss)
        mse = torch.mean((vp.detach() - wl.vp_true) ** 2)
        return _epoch_record(self, {"loss_D_MSE": loss, "loss_M_MSE": mse})

    @torch.no_grad()
    def test(self):
        # without water_vel, as the JAX engine's test (its default 1500)
        vp = self._velocity()
        mse = torch.mean((vp - self.wl.vp_true) ** 2)
        return {"loss_V_MSE": float(mse)}, vp.cpu().numpy()


class ImpedanceDIPEngine(EngineBase):
    """Deep-image-prior inversion through the impedance convolutional
    model (BASELINE config 1's Auto2 recipe, ``marmousi_impedance``): the
    generator (time decimation 1) maps the observed post-stack section
    [1, nz, nx, 1], the impedance synthetic of the true model, to a
    velocity model; its impedance synthetic against the section, ``l1``
    or ``l2``.  Plain autograd: a conv1d and elementwise ops.  The
    wavelet: ``extras`` ``impedance_freq`` (20 Hz), ``impedance_dt`` (2
    ms), ``impedance_nwav`` (100 samples)."""

    def __init__(self, cfg: ExperimentConfig, workload=None, *,
                 device=None):
        self.cfg = cfg
        self.device = _engine_device(device, workload)
        self.wl = workload or SyntheticAcousticWorkload.build(
            nz=cfg.nz, nx=cfg.nx, dx=cfg.dx, nt=max(cfg.nt, 64), dt=cfg.dt,
            pml_width=cfg.pml_width, freq=cfg.freq,
            num_shots=max(cfg.num_shots, 1),
            num_receivers=cfg.num_receivers, seed=cfg.seed,
            chunk=cfg.chunk, device=self.device)
        self._synth = functools.partial(
            impedance_synthetic, freq=cfg.extras.get("impedance_freq", 20.0),
            n_wavelet=cfg.extras.get("impedance_nwav", 100),
            dt=cfg.extras.get("impedance_dt", 2e-3), axis=-2)
        self.true_b = self.wl.vp_true[None, :, :, None]
        self.obs_stack = self._synth(self.true_b)
        self.net = define_generator(
            cfg.netG, out_shape=(cfg.nz, cfg.nx),
            in_shape=tuple(self.obs_stack.shape[1:]),
            latent_dim=cfg.latent_dim, filters=cfg.filters,
            time_decimation=1,
            generator=torch.Generator().manual_seed(cfg.seed),
        ).to(self.device)
        self.opt = _first_order_optimizer(cfg, self.net,
                                          "the impedance engine")
        self.lr_policy = LrPolicy(cfg) if cfg.optimizer == "adam" else None
        self.physics_path = "impedance"

    def _decode(self):
        out = pack_output(self.net(self.obs_stack))
        return apply_velocity_output(out.field, self.true_b,
                                     water_vel=self.cfg.water_vel)

    def optimize_parameters(self, epoch: int):
        _set_lr(self, epoch)
        vp = self._decode()
        mis = l1_misfit if self.cfg.misfit == "l1" else l2_misfit
        loss = mis(self._synth(vp), self.obs_stack)
        mse = torch.mean((vp[0, :, :, 0] - self.wl.vp_true) ** 2)
        _step(self.opt, loss)
        return _epoch_record(self, {"loss_D_MSE": loss, "loss_M_MSE": mse})

    @torch.no_grad()
    def test(self):
        vp = self._decode()[0, :, :, 0]
        mse = torch.mean((vp - self.wl.vp_true) ** 2)
        return {"loss_V_MSE": float(mse)}, vp.cpu().numpy()


class SupervisedEngine(EngineBase):
    """Image-to-image baselines (``engine="supervised"``: pix2pix2,
    unetSSIMAC, FNO): the generator ``cfg.netG`` (filters (16, 32, 64), no
    ``out_shape``: the output keeps the input's size) maps the input image
    ``a`` [B, H, W, in_channels] to the target ``b``; its loss is
    ``extras["lambda_l1"]`` (10) times the L1, plus 1 - SSIM at window
    ``extras["ssim_window"]`` where it is set, plus the GAN loss
    (``extras["gan_mode"]``, "lsgan"; "none" drops the discriminator) of
    the current discriminator on [a, fake].  The discriminator (a 3-layer
    PatchGAN at base 32 on [a, b] or [a, fake], weights from seed 1) then
    takes one step on the same forward's fake, detached.

    The generator's Adam follows :class:`LrPolicy`; the discriminator's
    keeps ``cfg.lr`` with b1 ``cfg.beta1`` and eps 1e-8, as the JAX
    engine's ``optax.adam(cfg.lr, b1=cfg.beta1)`` does.
    ``save_networks`` saves the generator alone."""

    def __init__(self, cfg: ExperimentConfig, in_shape=(128, 128),
                 in_channels: int = 1, out_channels: int = 1, *,
                 device=None):
        self.cfg = cfg
        self.device = _engine_device(device, None)
        self.gan_mode = cfg.extras.get("gan_mode", "lsgan")
        self.lambda_l1 = cfg.extras.get("lambda_l1", 10.0)
        self.ssim_window = cfg.extras.get("ssim_window", 0)
        self.net = define_generator(
            cfg.netG, out_shape=None, in_shape=(*in_shape, in_channels),
            out_channels=out_channels, filters=(16, 32, 64),
            generator=torch.Generator().manual_seed(cfg.seed),
        ).to(self.device)
        self.opt = _first_order_optimizer(cfg, self.net,
                                          "the supervised engine")
        self.lr_policy = LrPolicy(cfg)
        self._epoch = 0
        self.use_gan = self.gan_mode != "none"
        if self.use_gan:
            self.disc = define_discriminator(
                "n_layers", in_channels=in_channels + out_channels, base=32,
                n_layers=3, generator=torch.Generator().manual_seed(1),
            ).to(self.device)
            self.d_opt = torch.optim.Adam(self.disc.parameters(), lr=cfg.lr,
                                          betas=(cfg.beta1, 0.999), eps=1e-8)

    def optimize_parameters(self, a: torch.Tensor, b: torch.Tensor,
                            epoch: int | None = None):
        """One generator step, then (with the GAN term) one discriminator
        step on the same fake; ``epoch`` (default: the last one + 1) sets
        the generator's lr.  Returns ``loss_G`` (and ``loss_D``), each the
        loss before its step, and ``lr``."""
        self._epoch = epoch if epoch is not None else self._epoch + 1
        _set_lr(self, self._epoch)
        a, b = a.to(self.device), b.to(self.device)
        fake = pack_output(self.net(a)).field
        loss = self.lambda_l1 * torch.mean(torch.abs(fake - b))
        if self.ssim_window:
            loss = loss + (1.0 - ssim(fake, b, window_size=self.ssim_window))
        losses = {"loss_G": loss}
        if self.use_gan:
            # the generator's step trains the generator alone
            self.disc.requires_grad_(False)
            loss = loss + gan_loss(self.disc(torch.cat([a, fake], -1)), True,
                                   self.gan_mode)
            losses["loss_G"] = loss
        _step(self.opt, loss)
        if self.use_gan:
            self.disc.requires_grad_(True)
            pr = self.disc(torch.cat([a, b], -1))
            pf = self.disc(torch.cat([a, fake.detach()], -1))
            losses["loss_D"] = 0.5 * (gan_loss(pr, True, self.gan_mode)
                                      + gan_loss(pf, False, self.gan_mode))
            _step(self.d_opt, losses["loss_D"])
        vals = torch.stack([v.detach() for v in losses.values()]).tolist()
        return {**dict(zip(losses, vals)), "lr": self.lr_policy.lr}

    @torch.no_grad()
    def test(self, a: torch.Tensor, b: torch.Tensor):
        """The generator's L1 to ``b`` (``loss_V_L1``) and its image."""
        fake = pack_output(self.net(a.to(self.device))).field
        l1 = torch.mean(torch.abs(fake - b.to(self.device)))
        return {"loss_V_L1": float(l1)}, fake.cpu().numpy()


_ENGINES: dict[str, Any] = {
    "acoustic_dip": AcousticDIPEngine,
    "acoustic_dip_multi": MultiSampleAcousticDIPEngine,
    "elastic_dip": ElasticDIPEngine,
    "classic_fwi": ClassicFWIEngine,
    "latent_inversion": LatentInversionEngine,
    "supervised": SupervisedEngine,
    "impedance_dip": ImpedanceDIPEngine,
}


def create_engine(cfg: ExperimentConfig, **kw):
    """Factory by ``cfg.engine``; ``kw`` goes to the engine (``device``,
    a workload; the supervised engine's ``in_shape``, ``in_channels`` and
    ``out_channels``)."""
    return _ENGINES[cfg.engine](cfg, **kw)
