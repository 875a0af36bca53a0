"""Experiment configuration and workload registry.

A verbatim copy of ``physicsbasedfwi2_tpu/engine/config.py`` (it
imports only ``dataclasses``/``typing``); the two registries are held
equal field for field by tests/test_torch_engine.py.

Replaces the reference's three-stage argparse system (options/
base_options.py:60-93, where each model/dataset class mutates the
flag defaults) with one frozen dataclass plus a name->config registry
mirroring every training shell script / BASELINE.json config.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class ExperimentConfig:
    # identity
    name: str = "experiment"
    engine: str = "acoustic_dip"       # engine key (create_engine)
    netG: str = "Auto22"               # generator registry name
    dataset_mode: str = "unalignedVelABCD2"
    dataroot: str | None = None        # None -> synthetic workload

    # grid / physics (reference defaults: networks.py:5339-5345)
    nz: int = 151
    nx: int = 200
    dx: float = 10.0
    nt: int = 4001
    dt: float = 0.001
    pml_width: int = 20
    free_surface: bool = False
    freq: float = 8.0                  # source peak frequency (Hz)
    num_shots: int = 18
    num_receivers: int = 200
    shots_per_iter: int | None = None  # random shot subset (elastic: 5)
    water_vel: float = 1500.0
    water_rows: int = 26               # pinned top rows (elastic)

    # training (train_options.py defaults; scripts override)
    batch_size: int = 1
    lr: float = 0.01
    beta1: float = 0.5
    optimizer: str = "adam"            # adam | lbfgs | sgld | sghmc
    adam_eps: float = 1e-8             # raising this suppresses
                                       # full-size steps on near-zero-
                                       # gradient coordinates (Adam's
                                       # per-coordinate normalization
                                       # otherwise amplifies null-
                                       # space noise; see the elastic
                                       # recipe notes below)
    lr_policy: str = "linear"
    n_epochs: int = 100
    n_epochs_decay: int = 100
    lstart: int = 0                    # physics kicks in after this epoch
    grad_scale: float = 1.0e5          # VJP scale (Auto22_model.py:300)
    misfit: str = "l1"                 # l1/l2: raw; tnl1/tnl2:
                                       # per-trace-max normalized;
                                       # snl2 (elastic): raw L2 with
                                       # per-shot RMS scaling folded
                                       # into wavelet+obs — keeps
                                       # amplitude/AVO information
                                       # and fixes raw-L2's ~1e-7 f32
                                       # conditioning
    direct_wave: bool = True           # constant-model direct-arrival
                                       # removal (networks.py:5396-5411)
    wavelet_from_data: bool = False    # AutoWav: per-shot wavelets
                                       # from trainD (networks.py:13163)
    encoded_shots: int = 0             # >0: random-polarity
                                       # simultaneous-source encoding —
                                       # n_super super-shots per
                                       # iteration instead of all shots
                                       # (beyond the reference; Krebs
                                       # et al. 2009 style)
    validate_on_twin: bool = True      # held-out Test-twin validation
                                       # (data/__init__.py:41-62)
    holdout_shots: int = 0             # >0: exclude this many evenly
                                       # spaced shots from the
                                       # training pool and log their
                                       # misfit as loss_H — an
                                       # UNSUPERVISED early-stopping /
                                       # model-selection metric (the
                                       # reference early-stopped by
                                       # manually resuming from a
                                       # chosen epoch,
                                       # trainVelAutoElMar22ModelPhy.sh
                                       # --epoch 1500; a real user has
                                       # no ground-truth model MSE to
                                       # peek at).  train.py saves the
                                       # best-loss_H checkpoint of the
                                       # final frequency stage as
                                       # 'selected'.
    holdout_every: int = 10            # epochs between loss_H
                                       # evaluations (each costs a
                                       # forward sim of the held-out
                                       # shots)
    guard_patience: int = 0            # >0: drift guard ON — an
                                       # UNSUPERVISED trust region on
                                       # loss_H.  Untethered descent is
                                       # a seed lottery (2/3 seeds
                                       # catapult into data-consistent
                                       # drift basins the TRAIN misfit
                                       # cannot reject, runs_r4/
                                       # probe_{h,i,j}); the held-out
                                       # misfit DOES reject them
                                       # (measured: runs_r5/el_armB_s1
                                       # drift has loss_H 0.245 vs
                                       # 0.178 at its best).  train.py
                                       # snapshots the best-loss_H
                                       # model per continuation stage;
                                       # after this many CONSECUTIVE
                                       # loss_H evals above guard_tol x
                                       # the stage best, it reverts the
                                       # model to that snapshot with a
                                       # fresh optimizer (the catapult
                                       # is an Adam second-moment
                                       # artifact; phase_reset_opt
                                       # rationale) and re-descends.
    guard_tol: float = 1.05            # "worse" threshold: loss_H >
                                       # guard_tol x stage best counts
                                       # toward guard_patience
    guard_lr_ramp: int = 0             # >0: linear lr ramp over this
                                       # many epochs after each revert
                                       # (bounds the re-descent kick)
    step_cap: float = 0.0              # >0: hard trust region in MODEL
                                       # space — per iteration, the
                                       # decoded model may move at most
                                       # this RMS (m/s over all
                                       # fields); the parameter update
                                       # is scaled down otherwise.  The
                                       # seed catapult is an OVERSHOOT:
                                       # seeds 1/2 jump 11k -> 19k
                                       # vp+vs MSE within 9 physics
                                       # epochs (>= 3.5 m/s RMS per
                                       # epoch) into a drift basin
                                       # whose low-band data fit then
                                       # IMPROVES (loss_H 0.279 ->
                                       # 0.210 while model MSE doubles,
                                       # runs_r5/el_guard_s1) — no
                                       # misfit-side guard can reject
                                       # it.  Good descent moves ~0.2
                                       # m/s/epoch net (probe E); a
                                       # speed limit forces every seed
                                       # onto that gentle NTK gradient
                                       # flow instead of the lottery.
    step_cap_final: float = -1.0       # cap used in the FINAL
                                       # continuation stage: -1 = same
                                       # as step_cap, 0 = uncapped
                                       # (the catapult lives in the
                                       # low-frequency stages; the
                                       # final stage carries most of
                                       # the budget and descends ~2x
                                       # faster uncapped, with the
                                       # loss_H drift guard as the
                                       # insurance there), >0 = that
                                       # cap.  Threaded through the
                                       # step pack as data - stage
                                       # changes never recompile.
    supervised_weight: float = 0.0     # model-MSE term weight
    anchor_weight: float = 0.0         # optional low-freq tether in the
                                       # physics phase (off = reference)
    kl_weight: float = 0.0             # VAE
    flow_weight: float = 1e-4          # invertible-latent NLL (AutoNF)
    latent_dim: int = 8
    filters: tuple = (16, 32, 64, 128)
    time_decimation: int = 4
    dropout: float = 0.0

    # frequency continuation (trainValLatent4dVel2Elastic.py:49-51,136-146)
    freq_stages: tuple = ()            # e.g. (10.0, 15.0, 20.0) fc_high Hz
    plateau_eps: float = 5e-10
    plateau_history: int = 5
    plateau_mode: str = "range"        # "range": reference detector
                                       # (|hi-lo|/|hi| over the window;
                                       # its 5e-10 eps never fires on
                                       # real SGD loss scales — the
                                       # reference's freqL=[20] made it
                                       # vestigial).  "improve": advance
                                       # when the window-median loss
                                       # stops improving by more than
                                       # plateau_eps relative — robust
                                       # to random-shot-subset jitter.
    stage_max_epochs: int = 0          # >0: force-advance a stage
                                       # after this many epochs (the
                                       # DENISE practice of fixed
                                       # iterations per fc stage)

    # elastic gradient conditioning (DENISE taper/filter equivalents)
    grad_taper_rows: int | None = None  # None -> water_rows (ref
                                        # networks.py:7808-7814).  The
                                        # raw adjoint gradient has
                                        # near-singular values at the
                                        # src/rcv row (water_rows+1) —
                                        # tapering only the water rows
                                        # leaves them in.
    grad_taper_smooth: int = 0          # cosine-ramp rows below taper
    grad_smooth: int = 0                # binomial smoothing passes of
                                        # dJ/dm (DENISE SPATFILTER role)
    grad_rescale: str = "max"           # "max": DENISE r1..r3 — max|g|
                                        # rescaled to max|m| EVERY
                                        # iteration (keeps the update
                                        # pressure constant even at
                                        # convergence); "none": fixed
                                        # grad_scale multiplier (the
                                        # acoustic engine's x1e5
                                        # convention — gradient decays
                                        # naturally with the residual)
    grad_depth_power: float = 0.0       # depth^p weighting of the
                                        # elastic gradient (the
                                        # acoustic engine uses p=2,
                                        # networks.py:5329-5332)
    tether_weight: float = 0.0          # gradient-level Tikhonov
                                        # tether to the low-frequency
                                        # model: a pull of
                                        # tether_weight x the physics
                                        # gradient's per-field RMS is
                                        # added toward lowf inside the
                                        # injected VJP.  Unlike
                                        # anchor_weight (a loss term
                                        # whose scale is
                                        # incommensurate with the
                                        # grad_scale-amplified physics
                                        # push), this acts in the same
                                        # units as the physics
                                        # gradient, so 0.3 means "the
                                        # tether is 30% as strong as
                                        # the data term" at every
                                        # iteration and stage.
    tether_mode: str = "lowf"           # what the tether pulls toward.
                                        # "lowf": the fixed low-
                                        # frequency starting model —
                                        # bounds TOTAL drift but also
                                        # caps total progress at the
                                        # tether equilibrium (~5-8%
                                        # below start, docs/RESULTS.md).
                                        # "stage": a TRAILING reference
                                        # — the model snapshot taken at
                                        # each continuation-stage
                                        # advance (and, if
                                        # tether_refresh_epochs > 0,
                                        # every that-many physics
                                        # epochs inside a stage).  Each
                                        # segment's displacement is
                                        # bounded exactly like the
                                        # fixed tether bounds it, but
                                        # locked-in progress moves the
                                        # reference along, so there is
                                        # no global equilibrium cap —
                                        # a proximal-point /
                                        # trust-region version of the
                                        # same regularizer.  Null-space
                                        # drift (physics-gradient
                                        # component < tether_weight x
                                        # gradient RMS) is re-zeroed
                                        # every segment instead of
                                        # accumulating across the run.
    tether_refresh_epochs: int = 0      # tether_mode="stage" only:
                                        # >0 also refreshes the
                                        # trailing reference every this
                                        # many physics epochs, so the
                                        # long final stage (most of the
                                        # budget after continuation
                                        # ends) keeps its per-segment
                                        # drift bound instead of
                                        # reverting to a fixed tether.
    tether_decay: float = 1.0           # per-stage tether relaxation:
                                        # the effective tether at
                                        # continuation stage i is
                                        # tether_weight * decay**i —
                                        # classical multiscale FWI
                                        # shrinks regularization as
                                        # higher frequencies add
                                        # trustworthy data content.
                                        # Threaded through the step's
                                        # data pack (no recompile).
    grad_illum_eps: float = 0.0         # >0 enables DENISE-style
                                        # illumination preconditioning
                                        # (EPRECOND): the elastic
                                        # gradient is divided by
                                        # (illum/max(illum) + eps),
                                        # where illum is the forward
                                        # particle-velocity energy of
                                        # the STARTING model summed
                                        # over all shots and time
                                        # (ops/elastic_fast.py
                                        # elastic_illumination) — the
                                        # physics-informed version of
                                        # grad_depth_power's z^2 ramp,
                                        # which it REPLACES when
                                        # enabled (the engine skips
                                        # the ramp — applying both
                                        # would compound ~z^p/eps).
                                        # eps bounds the boost of
                                        # never-illuminated cells
                                        # (1/eps max amplification).
    tether_anneal_plateaus: int = 0     # after the FINAL frequency
                                        # stage, keep multiplying the
                                        # tether by tether_decay each
                                        # time the plateau detector
                                        # fires again, up to this many
                                        # extra times.  Lets a long run
                                        # escape the tether equilibrium
                                        # (the tether holds the model
                                        # ~8% under its start and then
                                        # stalls, docs/RESULTS.md)
                                        # once continuation has already
                                        # steered it into a good basin.
                                        # 0 = off (tether held at the
                                        # final-stage value forever).
    grad_field_weights: tuple | None = None
                                        # per-field multipliers applied
                                        # to the PROCESSED gradient
                                        # (vp, vs[, rho]); None -> all
                                        # 1.  A weakly-illuminated
                                        # field (vs under a water
                                        # layer) can be damped without
                                        # touching the others.
    field_start_epochs: tuple | None = None
                                        # per-field physics-phase entry
                                        # offset: field k's gradient is
                                        # zeroed until epoch >=
                                        # lstart + value
                                        # (staged multi-parameter FWI —
                                        # the reference gates the rho
                                        # backward on currenterror <
                                        # 0.4*initerror the same way,
                                        # AutoElMar22_model.py:446-451).
                                        # None -> all fields from the
                                        # first physics epoch.
    delta_scale: tuple | None = None    # per-field delta scale (m/s):
                                        # tanh head -> max |delta|
                                        # bound (None -> 300,200,150);
                                        # linear head -> gain on the
                                        # raw decoder output (None ->
                                        # 100,100,100 — the SI
                                        # equivalent of the
                                        # reference's /100-unit
                                        # additive head)
    clip_min: tuple | None = None       # per-field physical lower
                                        # bounds (DENISE VPLOWERLIM..;
                                        # None -> 1500, 0, 900).
                                        # Setting clip_min == clip_max
                                        # pins a field (the reference's
                                        # RealData marine mode:
                                        # VSUPPERLIM = VSLOWERLIM = 881,
                                        # networks.py:10455-10460)
    clip_max: tuple | None = None       # upper bounds (None ->
                                        # 4700, 2700, 3000)
    phase_reset_opt: bool = False       # re-init the optimizer state
                                        # at the lstart warmup ->
                                        # physics switch (the
                                        # reference's physics phase
                                        # started from a checkpoint
                                        # with a NEW optimizer).  Note:
                                        # with --continue-train
                                        # resuming inside the physics
                                        # phase this fires once more
                                        # on the first resumed epoch.
    phase_lr_ramp: int = 0              # >0: ramp lr linearly from 0
                                        # over this many epochs after
                                        # the physics switch (damps
                                        # the oversized first steps on
                                        # a fresh loss surface)
    clip_mode: str = "hard"             # "hard": jnp.clip (zero
                                        # gradient outside the bounds
                                        # — railed cells are stuck);
                                        # "ste": hard clip forward,
                                        # straight-through backward so
                                        # railed cells stay
                                        # recoverable
    elastic_head: str = "linear"        # "linear": reference-faithful
                                        # unbounded additive delta
                                        # (networks.py:7455-7456 vp1 =
                                        # lowf + vp1f, physical clip
                                        # only); "tanh": bounded delta
                                        # — freezes wherever the
                                        # needed delta exceeds the
                                        # bound (gradient dies at
                                        # saturation)

    # propagator
    order: int = 4
    chunk: int = 64
    backend: str = "auto"              # auto | pallas | xla

    # bookkeeping
    save_dir: str = "./checkpoints"
    save_epoch_freq: int = 50
    seed: int = 0
    extras: dict = dataclasses.field(default_factory=dict)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


_WORKLOADS: dict[str, ExperimentConfig] = {}


def register_workload(name: str, cfg: ExperimentConfig):
    _WORKLOADS[name.lower()] = cfg


def get_workload(workload: str, **overrides) -> ExperimentConfig:
    cfg = _WORKLOADS[workload.lower()]
    # an explicit name override (e.g. --set name=myrun) wins over the
    # registry-key default run name
    overrides.setdefault("name", workload)
    return cfg.replace(**overrides)


def list_workloads() -> list[str]:
    return sorted(_WORKLOADS)


def parse_set_overrides(pairs) -> dict:
    """Parse CLI ``--set FIELD=VALUE`` pairs into config overrides.

    Values parse as python literals (``--set 'freq_stages=(4.0,8.0)'``)
    with a bare-string fallback (``--set misfit=tnl1``).  The
    reference exposed every option through its three-stage argparse
    (base_options.py:20-57); this is the registry-equivalent.
    Raises ValueError on unknown field names."""
    import ast
    import dataclasses
    field_names = {f.name for f in dataclasses.fields(ExperimentConfig)}
    out = {}
    for kv in pairs:
        k, sep, v = kv.partition("=")
        k, v = k.strip(), v.strip()
        if not sep or k not in field_names:
            raise ValueError(f"--set {kv!r}: unknown config field {k!r}")
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


# --- BASELINE.json config 1/2: Marmousi acoustic DIP ---------------------
register_workload("marmousi_acoustic", ExperimentConfig(
    engine="acoustic_dip", netG="Auto22",
    nz=151, nx=200, dx=10.0, nt=4001, dt=0.001, freq=8.0,
    num_shots=18, num_receivers=200,
    lr=0.01, lstart=0, misfit="l1",
    # reference budget (trainVelAuto2ModelPhy.sh / trainVelUnet2ModelPhy.sh:
    # --n_epochs 2000 --n_epochs_decay 2000); keeps the linear lr policy
    # from hitting zero at the 100+100 dataclass default
    n_epochs=2000, n_epochs_decay=2000,
))
# Real-Marmousi recipe (round 4, measured).  On the resampled
# published grid (fwi-prep marm751x2301.segy -> 151x200, vp up to
# 4700 m/s) the single-band 8 Hz recipe above saturates: the DIP
# drifts to the velocity rails and stalls at a data misfit WORSE
# than the smoothed start (runs_r4/ac_flagship_r4: misfit 0.105 vs
# 0.060 at the start model, model MSE flat at ~1.1e6).  The same
# cure as the elastic flagship applies — frequency continuation
# (zero-phase low-pass of wavelet+obs+direct per stage,
# AcousticDIPEngine._stage_phys_pd) from 3 Hz up to full band (0.0),
# advancing on the relative-improvement plateau detector.
register_workload("marmousi_acoustic_real", ExperimentConfig(
    engine="acoustic_dip", netG="Auto22",
    nz=151, nx=200, dx=10.0, nt=4001, dt=0.001, freq=8.0,
    num_shots=18, num_receivers=200,
    lr=0.01, lstart=0, misfit="l1",
    n_epochs=2000, n_epochs_decay=2000,
    freq_stages=(3.0, 4.5, 6.0, 8.0, 12.0, 0.0),
    plateau_mode="improve", plateau_eps=0.005, plateau_history=15,
    stage_max_epochs=150,
))
register_workload("marmousi_acoustic_unet", ExperimentConfig(
    engine="acoustic_dip", netG="Unet22",
    nz=151, nx=200, dx=10.0, nt=4001, dt=0.001, freq=8.0,
    num_shots=18, num_receivers=200, lr=0.01,
    n_epochs=2000, n_epochs_decay=2000,
))
register_workload("marmousi_acoustic_vae", ExperimentConfig(
    engine="acoustic_dip", netG="Vae2", kl_weight=1e-4,
    nz=151, nx=200, dx=10.0, nt=4001, dt=0.001, freq=8.0,
    num_shots=18, num_receivers=200, lr=0.01,
    n_epochs=2000, n_epochs_decay=2000,
))
# normalizing-flow decoder head (AutoNF, networks.py:13316-13624)
register_workload("marmousi_acoustic_nf", ExperimentConfig(
    engine="acoustic_dip", netG="AutoNF", flow_weight=1e-4,
    nz=151, nx=200, dx=10.0, nt=4001, dt=0.001, freq=8.0,
    num_shots=18, num_receivers=200, lr=0.01,
    n_epochs=2000, n_epochs_decay=2000,
))
# planar-flow VAE (VaeNormalizingPhy, networks.py:16190)
register_workload("marmousi_acoustic_vaeflow", ExperimentConfig(
    engine="acoustic_dip", netG="VaeNormalizingPhy", kl_weight=1e-4,
    nz=151, nx=200, dx=10.0, nt=4001, dt=0.001, freq=8.0,
    num_shots=18, num_receivers=200, lr=0.01,
    n_epochs=2000, n_epochs_decay=2000,
))
# source wavelet taken from the data (AutoWav, networks.py:13120-13180)
register_workload("marmousi_acoustic_wav", ExperimentConfig(
    engine="acoustic_dip", netG="AutoWav", wavelet_from_data=True,
    nz=151, nx=200, dx=10.0, nt=4001, dt=0.001, freq=8.0,
    num_shots=30, num_receivers=200, lr=0.01,
    n_epochs=2000, n_epochs_decay=2000,
))
# BASELINE config 1: Auto2's impedance-synthetic L1 training
# (Auto2_model.py:240-342 — reflectivity + wavelet convolution)
register_workload("marmousi_impedance", ExperimentConfig(
    engine="impedance_dip", netG="Auto",
    nz=151, nx=200, dx=10.0, nt=64, dt=0.001, freq=14.0,
    num_shots=1, num_receivers=200, lr=0.01, misfit="l1",
))

# --- BASELINE.json config 3: Marmousi elastic (Adam and L-BFGS) ----------
_EL = ExperimentConfig(
    engine="elastic_dip", netG="AutoElMar22",
    dataset_mode="unalignedVelABCDEl",
    nz=100, nx=300, dx=20.0, nt=3334, dt=0.0015, freq=10.0,
    free_surface=True, num_shots=35, num_receivers=298,
    shots_per_iter=5, water_rows=26,
    # anchor_weight=0 in the physics phase matches the reference: its
    # physics branch backprops ONLY the injected field gradients
    # (AutoElMar22_model.py:398-420); lstart=30 runs the
    # loss_G=loss_L_MSE anchor warmup first, landing the decoder on
    # the low-frequency model before physics starts (the reference
    # resumed elastic runs from pretrained checkpoints,
    # trainVelAutoElMar22ModelPhy.sh --continue_train --epoch 1500)
    lr=0.001, anchor_weight=0.0, lstart=30,
    # reference epoch budget: --n_epochs 4000 --n_epochs_decay 2000
    # (trainVelAutoElMar22ModelPhy.sh) — without this the default
    # 100+100 linear policy silently freezes the run at epoch 200
    n_epochs=4000, n_epochs_decay=2000,
    # Inversion recipe (measured, round 3): the reference's literal
    # conditioning (misfit="l2", grad_rescale="max" = DENISE r1..r3
    # per-iteration max-rescale, 10 Hz start) does NOT invert this
    # workload here — the landscape is benign (monotone misfit from
    # start to truth) but constant-pressure rescaled updates plus
    # Adam's per-coordinate normalization amplify null-space drift
    # until the model is worse than its low-frequency start.  The
    # recipe below — trace-normalized L1, fixed gradient scale so the
    # update decays with the residual, depth^2 weighting (the acoustic
    # engine's own convention, networks.py:5329-5332), taper of the
    # water column UP TO the src/rcv row (taper_top zeroes rows
    # 0..26; the src/rcv row water_rows+1 = 27 itself stays live,
    # its spike damped by the depth^2 weight), continuation from
    # 4 Hz with an improvement-based
    # plateau detector — beats the starting model
    # (7,951 -> <5,400 model MSE) with every stage advancing.
    misfit="tnl1", grad_rescale="none", grad_scale=1e6,
    grad_depth_power=2.0, grad_taper_rows=27,
    freq_stages=(4.0, 6.0, 8.0, 10.0, 15.0, 20.0),
    plateau_mode="improve", plateau_eps=0.005, plateau_history=15,
    stage_max_epochs=150,
    # The data term barely separates basins on this workload (tnl1
    # plateaus ~0.2-0.3 whether the model converges or diverges), so
    # the recipe above is fragile to the workload/net seed: measured,
    # seed (0,0) descends to 4.2k model MSE while (1,1), (0,1) and
    # (1,0) all blow past 45k.  The gradient-level lowf tether bounds
    # that drift: every probed combination descends monotonically
    # below its starting model with tether 0.3 (engines.py
    # _make_physics_loss; w=1.0 pins at start, w=0 reproduces the
    # fragile reference behavior).
    tether_weight=0.3,
)
register_workload("marmousi_elastic", _EL)
# The real-Marmousi flagship recipe (round 4, measured).  Run against
# a known-density tree (``fwi-prep --physics elastic --rho-start
# true``, e.g. dataroots/marm_elastic_kd): with the density floor
# removed the true vp/vs is an exact misfit minimum, and UNTETHERED
# descent through the continuation stages is what actually inverts —
# the tether equilibrium caps progress ~5% below the start while
# probe E (this recipe, seed 0) reaches ~60-70% below it
# (docs/RESULTS.md round-4 table).  This is the raw untethered
# recipe: seed-sensitive by measurement (seeds 1/2 catapult,
# runs_r4/probe_{h,i,j}) and kept for the round-4 flagship's
# provenance; the seed-robust production recipe is
# `marmousi_elastic_robust` (2.5 Hz ladder + step_cap + loss_H
# guard), optionally wrapped in `fwi-race`.
register_workload("marmousi_elastic_real",
                  _EL.replace(tether_weight=0.0, seed=0))
# Seed-robust flagship recipe (round 5): untethered descent inverts
# but is a seed lottery (2 of 3 seeds diverge 6-8x above start,
# runs_r4/probe_{h,i,j}).  Measured failure modes of every
# alternative (runs_r5): a strong trailing tether bounds drift but
# chokes descent to ~0.95 x start at 1500 epochs (el_robust_s1, vs
# the warmup-end anchor), a weak/decaying one RATCHETS drift
# (el_armB_s1 ends 1.4 x start), and a loss_H guard alone cannot
# reject the catapult basin because its low-band data fit IMPROVES
# while the model diverges (el_guard_s1: loss_H 0.279 -> 0.210 as
# vp+vs MSE doubles).  What works (el_low_s1, seed 1 - the worst
# round-4 offender - descends monotonically):
# - START THE LADDER AT 2.5 Hz: at 4 Hz the lowf start sits on a
#   basin boundary and the seed decides which way the DIP flows; the
#   2.5 Hz stage builds a background that points every probed seed
#   at the true basin (the catapult was measured at the 4 Hz stage,
#   el_cap_s1/el_guard_s1).
# - step_cap=1.0 m/s RMS/iter: a hard model-space trust region so no
#   seed can jump basins in the 9-epoch catapult window; released in
#   the final stage (step_cap_final=0) where it would halve descent
#   speed and the drift risk is the slow kind the guard catches.
# - guard_*: the loss_H trust region reverts late/slow drift
#   segments (the armB failure mode, where loss_H DOES separate).
# phase_reset_opt bounds the warmup->physics switch.  For adversarial
# inits beyond the probed seeds, `fwi-race` (engine/race.py) wraps
# this recipe in a K-seed race with unsupervised final-stage loss_H
# selection.
register_workload("marmousi_elastic_robust",
                  _EL.replace(tether_weight=0.0,
                              phase_reset_opt=True,
                              freq_stages=(2.5, 4.0, 6.0, 8.0,
                                           10.0, 15.0, 20.0),
                              step_cap=1.0, step_cap_final=0.0,
                              holdout_shots=3, holdout_every=10,
                              guard_patience=2, guard_tol=1.05,
                              guard_lr_ramp=30))
# L-BFGS variant (AutoElMar22LBFGS_model.py:128-137).  L-BFGS builds
# its own curvature model from (value, grad) pairs, so the Adam-era
# gradient conditioning above (grad_scale=1e6 fixed rescale, depth^2
# weighting, taper, gradient-level tether) must come OFF: a zoom
# linesearch fed a conditioned "gradient" mis-estimates the
# directional derivative by ~1e6 and collapses the step to ~1e-8
# (measured).  Full-batch (all 35 shots per closure, the reference's
# FullBatchLBFGS contract) over the smooth trace-normalized L2
# misfit; raw-amplitude l2 is ~1e-7 in f32 and stalls the Wolfe
# comparisons (measured).  The optimizer ignores lr (linesearch
# picks the step).
register_workload("marmousi_elastic_lbfgs",
                  _EL.replace(optimizer="lbfgs", shots_per_iter=None,
                              misfit="tnl2", grad_rescale="none",
                              grad_scale=1.0, grad_depth_power=0.0,
                              grad_taper_rows=0, tether_weight=0.0))
# strict-parity mode: the reference's LITERAL elastic recipe, wired
# end-to-end so "your hyperparameters transfer" is verified rather
# than asserted (docs/MIGRATION.md "Where the defaults deliberately
# deviate").  Raw L2 misfit (DENISE lnorm=2), per-iteration max
# rescale (networks.py:7843-7862 r1..r3), water-rows-only taper
# (networks.py:7808-7814), 10 Hz start with the reference's
# shift-register range detector at its literal 5e-10 eps
# (trainValLatent4dVel2Elastic.py:136-146), no tether, no depth
# weighting.  Measured: this recipe ends WORSE than its starting
# model here (see the marmousi_elastic notes above) — it exists for
# hyperparameter-transfer verification, not as a recommended default.
register_workload("marmousi_elastic_parity", _EL.replace(
    misfit="l2", grad_rescale="max", grad_scale=1.0,
    grad_depth_power=0.0, grad_taper_rows=None,
    freq_stages=(10.0, 15.0, 20.0),
    plateau_mode="range", plateau_eps=5e-10, plateau_history=5,
    stage_max_epochs=0, tether_weight=0.0))
# density-inversion head (AutoElFullRhoMar22, networks.py:8552-8936)
register_workload("marmousi_elastic_rho",
                  _EL.replace(netG="AutoElFullRhoMar22"))
# "Zp" variant — in the reference a vestigial label over the same
# three-head vp/vs/rho decoder (networks.py:10740-10880); trains through
# the identical rho-inversion path here
register_workload("marmousi_elastic_zp",
                  _EL.replace(netG="AutoElMarZp22"))

# simultaneous-source (super-shot) acoustic DIP — beyond the
# reference: 18 shots compressed into 4 random-polarity super-shots
# per iteration (ops/encoding.py); raw-amplitude L2 misfit (encoded
# gathers combine linearly, so the trace-normalize/direct-wave
# pipeline does not apply)
register_workload("marmousi_acoustic_encoded", ExperimentConfig(
    engine="acoustic_dip", netG="Auto22",
    nz=151, nx=200, dx=10.0, nt=4001, dt=0.001, freq=8.0,
    num_shots=18, num_receivers=200,
    lr=0.01, lstart=0, misfit="l2", encoded_shots=4,
    direct_wave=False,
))

# --- BASELINE.json config 4: VAE latent-space inversion ------------------
register_workload("latent_inversion", ExperimentConfig(
    engine="latent_inversion", netG="VaeLatent2NoPhy",
    dataset_mode="unalignedVelLatent2",
    nz=151, nx=201, dx=10.0, nt=800, dt=0.0015, freq=15.0,
    num_shots=10, num_receivers=150, lr=0.1,
))

# --- BASELINE.json config 5: SEAM elastic + MCDIP UQ ---------------------
# SEAM geometry (networks.py:9637-9712): dx=30, 9 s records at 5 Hz,
# sources every 8*30 m at 180 m depth (row 6), receiver line every
# 30 m at depth_rec = 23*30 m (row 23), 4 random shots/iter; the
# seabed-following nnz receiver mode (networks.py:4898-4946) is the
# rcv_follow_seabed extra (geo.acquisition.seabed_rows)
# SEAM's source is a 5 Hz Ricker (networks.py:9637-9700 dx=30 SEAM
# slice) — the Marmousi 4-20 Hz ladder inherited from _EL is a no-op
# above ~8 Hz (measured: runs at that ladder leave the 5 Hz band
# after ~100 epochs and drift monotonically away from the start);
# the ladder must live INSIDE the source band.
_SEAM_STAGES = (2.0, 3.0, 4.0, 5.0, 7.5)
register_workload("seam_elastic", _EL.replace(
    netG="AutoSEAMMar22", dx=30.0, nz=120, nx=324, nt=2568, dt=0.0035,
    freq=5.0, num_shots=38, shots_per_iter=4, num_receivers=300,
    water_rows=20, freq_stages=_SEAM_STAGES,
    extras={"src_depth_row": 6, "rcv_depth_row": 23}))
register_workload("seam_elastic_seabed", _EL.replace(
    netG="AutoSEAMMar22", dx=30.0, nz=120, nx=324, nt=2568, dt=0.0035,
    freq=5.0, num_shots=38, shots_per_iter=4, num_receivers=300,
    water_rows=20, freq_stages=_SEAM_STAGES,
    extras={"src_depth_row": 6, "rcv_follow_seabed": True}))
register_workload("mcdip_uq", _EL.replace(
    netG="AutoElMarMCDIP22", dropout=0.1))
# Round-5 recipes: untethered descent under the loss_H drift guard
# (see marmousi_elastic_robust — tethers either choke descent or
# ratchet drift, measured in runs_r5/el_robust_s1 / el_armB_s1).
# SEAM's round-4 best was -5.4% at the fixed-tether equilibrium and
# untethered SEAM drifts; the guard rolls drift segments back while
# keeping real descent.  SEAM also gets DENISE-style illumination
# preconditioning (EPRECOND): at dx=30 with a 600 m water column the
# z^2 ramp under-weights the deep section the 5 Hz band must fill in.
register_workload("seam_elastic_robust", _EL.replace(
    netG="AutoSEAMMar22", dx=30.0, nz=120, nx=324, nt=2568, dt=0.0035,
    freq=5.0, num_shots=38, shots_per_iter=4, num_receivers=300,
    water_rows=20, freq_stages=_SEAM_STAGES,
    extras={"src_depth_row": 6, "rcv_depth_row": 23},
    tether_weight=0.0, phase_reset_opt=True, grad_illum_eps=0.05,
    step_cap=1.0, step_cap_final=0.0,
    holdout_shots=3, holdout_every=10,
    guard_patience=2, guard_tol=1.05, guard_lr_ramp=30))
register_workload("mcdip_uq_robust", _EL.replace(
    netG="AutoElMarMCDIP22", dropout=0.1,
    tether_weight=0.0, phase_reset_opt=True,
    freq_stages=(2.5, 4.0, 6.0, 8.0, 10.0, 15.0, 20.0),
    step_cap=1.0, step_cap_final=0.0,
    holdout_shots=3, holdout_every=10,
    guard_patience=2, guard_tol=1.05, guard_lr_ramp=30))

# --- field-data workload (AutoRealData, networks.py:9937-10580) ----------
# Marine setting: DT=3.5 ms, TIME=7.0035 s (nt=2001), 5 Hz source,
# FREE_SURF=0, receivers at depth 23*30 m, 8*30 m source spacing;
# vp-only inversion — DENISE bounds pin vs and rho
# (VSUPPERLIM = VSLOWERLIM = 881, RHOUPPERLIM = RHOLOWERLIM = 1010,
# networks.py:10448-10460), band 3-10 Hz (add_fwi_stage fc_low=3.0,
# fc_high=10.0).  Observed data arrives via `fwi-prep --su-obs`
# (trainA/trainD SU ingestion); trainB is optional for field data.
# (dt 2 ms instead of DENISE's 3.5 ms: the VPUPPERLIM of 6000 m/s
# violates the explicit staggered-grid CFL bound at 3.5 ms x 30 m —
# DENISE's implicit damping tolerated it; we keep the record length
# in samples and stay stable)
register_workload("real_data", _EL.replace(
    netG="AutoRealData", dx=30.0, nz=150, nx=300, nt=2001, dt=0.002,
    freq=5.0, free_surface=False, num_shots=12, shots_per_iter=4,
    num_receivers=280, water_rows=0, freq_stages=(3.0, 6.0, 10.0),
    clip_min=(3000.0, 881.0, 1010.0), clip_max=(6000.0, 881.0, 1010.0),
    extras={"src_depth_row": 2, "rcv_depth_row": 23}))

# --- classic FWI (no net): AutoEl22N (networks.py:6477-6520) -------------
register_workload("classic_fwi_elastic", _EL.replace(
    engine="classic_fwi", netG="AutoEl22N"))
register_workload("classic_fwi_acoustic", ExperimentConfig(
    engine="classic_fwi", netG="AutoEl22N",
    nz=151, nx=200, dx=10.0, nt=4001, dt=0.001, freq=8.0,
    num_shots=18, num_receivers=200, lr=20.0, misfit="l1",
))

# --- supervised / GAN baselines (pix2pix2*, unetSSIMAC) ------------------
register_workload("pix2pix_baseline", ExperimentConfig(
    engine="supervised", netG="unet_128", dataset_mode="unaligned2",
    lr=2e-4, beta1=0.5,
    extras={"gan_mode": "lsgan", "lambda_l1": 10.0}))
register_workload("unet_ssim_baseline", ExperimentConfig(
    engine="supervised", netG="unet_128", dataset_mode="unalignedAC2",
    lr=2e-4, extras={"gan_mode": "none", "lambda_l1": 100.0,
                     "ssim_window": 5}))
# multi-channel GAN variants over the B/D and B/D/E letter combos
# (ref unalignedBD2_dataset.py / unalignedBDE2_dataset.py); the
# supervised loop is letter-generic so these differ only by mode
register_workload("pix2pix_bd", ExperimentConfig(
    engine="supervised", netG="unet_128", dataset_mode="unalignedBD2",
    lr=2e-4, beta1=0.5,
    extras={"gan_mode": "lsgan", "lambda_l1": 10.0}))
register_workload("pix2pix_bde", ExperimentConfig(
    engine="supervised", netG="unet_128", dataset_mode="unalignedBDE2",
    lr=2e-4, beta1=0.5,
    extras={"gan_mode": "lsgan", "lambda_l1": 10.0}))
# Fourier-neural-operator supervised baseline (RUnet_FNO.py)
register_workload("fno_baseline", ExperimentConfig(
    engine="supervised", netG="FNO", dataset_mode="unaligned2",
    lr=1e-3, extras={"gan_mode": "none", "lambda_l1": 1.0}))
