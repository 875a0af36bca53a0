#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py`` (no
arguments; needs one CUDA card, ``nvcc`` and ``nvidia-smi``).  While
developing, ``python3 chip_smoke.py --only 2,3,7`` runs phase 1 and the
phases named, and prints neither the kernels line nor the result line.

Phases, each of which fails the run (non-zero exit, no result line):

1. the card (``nvidia-smi`` name and power limit), versions, TF32 and
   cuDNN determinism settings, and the build of
   ``physicsbasedfwi2_tpu_torch/csrc`` with ``nvcc`` into
   ``build/torch_kernels/`` (registers and spills);
2. kernel B1 (``forward2``) against its plain PyTorch version at the
   acoustic path's shapes (151 x 200, PML 20, 18 shots x 200
   receivers, nt 4001), its resident route (one thread-block cluster
   per shot) timed against its per-step route in turns on the same
   inputs, the two held to bit equality (1e-6 of max where FMA
   contraction differs), with the resident plan and how many of its
   clusters the card keeps resident;
3. kernel B2 (``fwi_l1_loss_grad``) against its plain version at the
   same shape (on a misfit whose residuals keep their signs, and on
   the real one), and the loss at the true model; its two routes in
   turns as B1's, a device trace of one call on each route (kernel
   time by name: the forward sweep, the misfit, the reverse sweep), and
   the resident route at KC 32 and KC 8 in turns, with each one's peak
   memory;
4. kernel B3 (``fused_elastic_loss_grad_meds``) and the ring forward
   (``simulate_elastic_ring``) against their plain versions at the
   elastic path's shapes (100 x 300, free surface, nt 3334; the ring
   forward on all 35 shots, B3 on 5 shots x 298 receivers): the ring
   forward's two routes timed in turns and held to bit equality, its
   resident plan (8-row bands) with the clusters the card keeps
   resident, and a device trace of one resident call; the ring
   forward, the ``l2`` misfit, ``tnl1`` with residual signs fixed and
   on the real misfit, and the loss at the true model, all on the
   resident routes; B3's resident plan and how many of its clusters the
   card keeps resident, its two routes timed in turns on the same
   inputs (``l2`` and ``tnl1``) and held to bit equality, a device
   trace of one call on each route (the forward sweep, the misfit, the
   reverse sweep), and layout 1's instance for 8-row bands (the media
   through L1, the gradients in shared memory; SEAM's and real_data's
   layout) timed against the plan's layout 0 in turns, bit for bit;
5. the acoustic path: ``train(get_workload("marmousi_acoustic"),
   epochs=3)`` at full width on ``cuda:0``, every epoch's B2 on the
   resident route;
6. the elastic path: ``train(get_workload("marmousi_elastic"),
   epochs=lstart + 3)`` at full width: the 30 warmup epochs, then 3
   physics epochs on the 4 Hz continuation stage, every one's B3 and
   the engine setup's ring forward on the resident route;
7. kernels B4a (``forward2_ckpt``) and B4b (``backward2``) against B1
   and their plain versions at the acoustic path's shapes, each route
   against the other in turns as B1's, and the
   gradient of a smooth misfit through ``acoustic_pallas2`` against the
   plain version in float32 and float64;
8. kernels B5 (``acoustic_forward_pallas``) and B6
   (``acoustic_pallas_backward``) the same way through
   ``acoustic_pallas``, and B5 against ``simulate_acoustic``; their
   resident plan and how many of its clusters the card keeps resident,
   each one's two routes timed in turns and held to bit equality (B5's
   traces, B6's checkpoints and dJ/dvp), B6's peak memory on each route,
   and a device trace of one B6 call on each route (the forward sweep,
   then the recompute and adjoint);
9. the differentiable propagators' path at full width: the workload
   built with ``backend="pallas"`` (B5), the direct wave from
   ``select_acoustic("auto")``, then 3 model-pixel FWI iterations of
   the trace-normalized L1 loss through ``acoustic_pallas`` (B5 + B6)
   and 3 through ``acoustic_pallas2`` (B4a + B4b), every launch on the
   resident route, with each propagator's peak memory;
10. the acoustic engine's non-fused path: ``train(get_workload(
    "marmousi_acoustic", backend="xla", nt=XLA_NT), epochs=1)`` at full
    width (the time loop cut)
    (plain PyTorch autograd through ``simulate_acoustic``, no kernel);
11. kernels B7a (``forward2b``) and B7b (``backward2b``) at the acoustic
    path's shapes: their resident route (B4's resident sweeps with the
    checkpoints in shot pairs) and per-step route timed in turns on the
    same inputs and held within 1e-6 of max, each backward route fed
    the other forward route's checkpoints, resident B7a ``torch.equal``
    to resident B4a at KC 16 (traces and checkpoints) and resident B7b
    to the pair-ordered sum of resident B4b's per-shot gradients, both
    against their plain versions (the gradient of a smooth misfit also
    in float64 at 4 shots), the clusters resident, a device trace of
    one call on each route (resident: B7a one ``fwd_resident`` launch,
    B7b one ``rev_resident`` and one ``sum_pairs``), and an odd shot
    count, 5, on both routes; then the shot-pair propagator's path: 3
    model-pixel FWI iterations of the trace-normalized L1 loss through
    ``acoustic_pallas2b`` at 18 shots and one at 17, every B7 launch on
    the resident route, with the peak memory;
12. kernel B8 (``elastic_forward_pallas``) at ``marmousi_elastic``'s
    shape with an absorbing top (35 shots, 144 x 384 in kernel layout):
    its path, one call on the resident route, then its resident
    (9-row bands) and per-step routes (the ring forward's kernels with
    no free-surface row) timed in turns and held to bit equality, the
    plan with the clusters resident, a device trace of one resident
    call, the resident route bit-equal to the ring forward's on the same
    inputs, against its plain version, and each route's kernel launches
    in a device trace of one call (resident 1, per-step 2 a step);
13. B2's wavelet gradient (``want_wavelet_grad``) at phase 3's shape
    against the plain version in float32 and float64, both routes in
    turns;
14. the acoustic engine's new paths at full width:
    ``train(get_workload("marmousi_acoustic_real", stage_max_epochs=2),
    epochs=6)`` across continuation stages, and
    ``train(get_workload("marmousi_acoustic_wav"), epochs=3)`` (AutoWav,
    30 shots with per-shot wavelets);
15. the robust elastic recipe at full width:
    ``train(get_workload("marmousi_elastic_robust"), epochs=lstart + 10)``
    (3 of the 35 shots held out, 30 warmup epochs, 10 physics epochs at
    2.5 Hz under the step cap, the drift guard's anchor ``loss_H`` at
    epoch 30 and ``loss_H`` at epoch 40): B3 once a physics epoch and the
    ring forward at setup and for each ``loss_H``, all on the resident
    route, a fresh optimizer at epoch 31, each epoch's step-cap scale
    and uncapped move, the time of a ``loss_H`` evaluation, then a drift-
    guard revert on the card (``torch.equal``, empty optimizer state, the
    next epoch at ``lr / guard_lr_ramp``) and ``evaluate`` of the run's
    ``latest`` checkpoint;
16. L-BFGS and the non-fused elastic paths at full width:
    ``marmousi_elastic_lbfgs``'s engine (35 shots a closure, the ``tnl2``
    misfit on the "fast" path: plain autograd through the 5-field sponge
    propagator, no kernel), its setup and its misfit at the true model
    (its first physics epoch runs in phase 25, as ``adam_vs_lbfgs``'s
    L-BFGS arm); two L-BFGS epochs of ``marmousi_acoustic`` (B2 once an
    evaluation, all on the resident route); one ``elastic_gradient``
    (split PML, autograd) on 5 shots at the elastic grid;
17. BASELINE config 5 (SEAM elastic FWI with MC-dropout uncertainty):
    the ring forward at ``seam_elastic``'s grid (120 x 324, free surface,
    144 x 384 in kernel layout, nt 2568, 38 shots, sources on row 6,
    receivers on row 23), its two routes in turns held to bit equality,
    with the clusters resident and the waves, against the plain version
    on 4 shots; B3 on those 4 shots: its plan (16 bands of 9 rows in
    layout 1) with the clusters resident and the ptxas line of each
    instance, its two routes timed in turns and held to bit equality, a
    device trace of one resident call (the media copy and one launch a
    sweep), and the resident route against its plain version (residual signs
    fixed, the real misfit, the loss at the true model) beside the
    bound; ``train(get_workload("seam_elastic_robust",
    holdout_every=3), epochs=lstart + 6)`` (EPRECOND: the illumination
    once, at the first physics step; B3 resident once a physics epoch;
    ``loss_H``; the setup split, the peak memory, every gradient
    finite); ``train(get_workload("mcdip_uq"), epochs=lstart + 3)`` (B3
    resident once a physics epoch, dropout masks on every training
    decode), ``mc_realizations(32)`` timed and its seeds, and
    ``evaluate(realizations=32)`` of the run's ``latest`` checkpoint
    (``mc_std`` 0 in the pinned water rows, > 0 below them);
18. BASELINE config 2 and the acoustic generator zoo: ``marmousi_acoustic``'s
    workload and validation twin built once, each engine on a copy:
    ``marmousi_acoustic_unet`` (Unet22 at full resolution, 3 epochs; one
    generator forward and one forward + backward timed), ``_vae``, ``_nf``
    and ``_vaeflow`` (3 epochs each; a VAE's two training decodes differ,
    its two ``test()`` calls are equal), ``marmousi_acoustic`` with
    ``netG="Auto22CBAM"`` and with ``optimizer="sgld"`` (2 epochs each),
    B2 resident once an epoch on every one; ``mcdip_uq`` under
    ``optimizer="sghmc"`` (the warmup cut to 2 epochs, then 2 physics
    epochs; B3 and the ring forward resident; a non-finite B3 loss in the
    last one held to its plain version's); one SGLD and one SGHMC step's noise statistics on 1e6
    elements on the card;
19. BASELINE config 4 and the rest of the physics engines at full width,
    each on its own workload, every kernel's launch count 0 across the
    phase (they run plain PyTorch, as the JAX package runs XLA there):
    first the ops that ``torch.use_deterministic_algorithms(True,
    warn_only=True)`` names on one pretraining epoch and on one forward +
    backward of Unet22, Auto22 (``marmousi_acoustic``'s [1, 4001, 200,
    18] input) and AutoElMar22 (``marmousi_elastic``'s), and each net's
    weight gradients taken twice, held to ``torch.equal``; then config
    4's two stages through ``experiments/run_latent_flagship.py``: the
    VAE pretraining on ``make_model_bank(48)`` at 151 x 201
    (``PRETRAIN_EPOCHS`` of the recipe's 300 epochs; the recon loss
    falls), run once more from the same seed with the recon-loss
    histories and weights held equal, ``latent_inversion`` (10 shots x
    150 receivers, nt 800) for ``LATENT_EPOCHS`` epochs through the
    frozen decoder (``loss_D_MSE`` falls below epoch 1's; the checkpoint
    holds ``z`` alone), ``evaluate`` of its ``latest`` checkpoint (``z``
    restored), ``GAN_STEPS`` GanFWI SGLD
    steps over the decoder; ``classic_fwi_acoustic`` (151 x 200, nt cut
    to ``CLASSIC_AC_NT``, 18 shots) 1 epoch; ``classic_fwi_elastic``
    (100 x 300, nt 3334, 5 of 35 shots a step, the "fast" path)
    ``CLASSIC_EL_EPOCHS`` epochs, vs live; ``marmousi_impedance`` 3
    epochs, then ``save_engine``/``restore_engine`` on the card;
    ``marmousi_acoustic_encoded`` (4 super-shots) 2 epochs on the
    "encoded" path; ``acoustic_dip_multi`` on ``marmousi_acoustic`` (nt
    cut to ``MULTI_NT``), 2 samples, 1 warmup epoch then 1 physics
    epoch.  Each prints its setup
    and epoch seconds, peak memory and physics path;
20. training from a dataroot at full width, the trees under a temporary
    directory removed at the end: the canonical Marmousi 751 x 2301
    written as SEG-Y; ``prep --physics acoustic`` (resampled to 151 x
    200, 18 shots x 200 receivers, nt 4001, train and test trees, B1
    resident for the direct wave and both trees), the native npy loader
    built, taken and equal to numpy on the tree; ``marmousi_acoustic``
    3 epochs from it (B2 resident once an epoch, the validation twin the
    tree's ``test`` sample, the misfit at the true model <= 1e-6);
    ``prep --physics elastic`` at 100 x 300 (35 shots, nt 3334, the ring
    forward resident once) and ``marmousi_elastic`` lstart + 3 epochs
    from it (B3 resident once a physics epoch, the misfit at the true
    model <= 1e-9); ``real_data`` (150 x 300 at dx 30 m, nt 2001, 12
    shots x 280 receivers, absorbing top): a model inside its clip
    bounds, its SU gathers from the ring forward (resident: 16 bands of
    12 rows in layout 1), ingested with ``prep --su-obs`` beside a
    starting model (no trainB, as field data) through the native SU
    reader; the ring forward's and B3's plans at 192 x 384 with the
    clusters resident and the ptxas lines, each one's two routes timed
    in turns and held to bit equality (the ring forward on the 12 shots,
    B3 on a physics epoch's 4, with a device trace of one resident
    call), each resident route against its plain version on 2 shots,
    then lstart + 3 epochs, every B3 launch resident;
    ``fwi-test --dataroot`` of the acoustic run and ``fwi-race
    --dataroot`` (``marmousi_elastic_robust``, 2 seeds, 2-epoch probes);
21. the supervised/GAN family: a dataroot of 128 x 128 float32 patches
    from numpy seed 0 (``trainA`` .. ``trainE`` 64 each, ``testA`` ..
    ``testC`` 4 each, under a temporary directory removed at the end);
    ``train(get_workload(w, dataroot=...), epochs=SUP_EPOCHS)`` on the
    card by default for ``pix2pix_baseline``, ``unet_ssim_baseline``,
    ``pix2pix_bd``, ``pix2pix_bde`` and ``fno_baseline`` at their
    registered configs (batch 1), every kernel counter 0, finite losses,
    ``loss_V_L1`` where the test twin has the letters, a checkpoint
    round trip to the bit and one ``fwi-train`` run; 10 steps of
    ``CycleGanEngine(base=64, n_blocks=9)`` (the upstream ngf 64 and
    resnet_9blocks) at 128 x 128, timed; ASPP, ResUNET, UNet3Plus, R2U,
    R2AttU and Multi as the generator of ``marmousi_acoustic`` at full
    width on phase 18's workload, 2 epochs each, B2 resident once an
    epoch and B1 resident at setup, each net's forward and forward +
    backward timed; the weight gradients of UNet3Plus, MultiScaleUNet
    (at [1, 4001, 200, 18]), ResnetGenerator and FNO2d (at 128 x 128)
    taken twice, held to ``torch.equal``; ``born_acoustic`` against a
    central difference of ``simulate_acoustic`` at 40 x 50 (nt 250) and
    timed at the Marmousi grid (151 x 200, 2 shots, nt cut to
    ``BORN_MARMOUSI_NT``), and
    ``born_elastic`` once at 36 x 48 (nt 64);
22. ``fwi-landscape`` (``landscape/cli.py::main`` on pre-built engines):
    ``marmousi_acoustic`` on phase 18's shared workload (B1 resident
    twice at its setup) and ``marmousi_elastic`` (the ring forward
    resident once at its setup), each a 3 x 3 surface on [-0.3, 0.3]^2
    with ``--vtp`` (every loss finite, the centre equal to a direct
    evaluation of the physics loss, the .vtp's 9 points and 4 quads;
    the elastic surface's 9 ring forwards resident); ``simulate_acoustic``
    without autograd at the full nt on its CUDA-graph chunks against the
    closure scan's loop, in turns, to the bit; four epoch-tagged elastic
    checkpoints and ``--trajectory`` (the last coordinate 0 within 1e-3,
    the epochs as saved, 9 more resident ring forwards); Lanczos in
    float64 through the composite HVP at the full grid, shots and
    generator with the misfit's time loop cut (acoustic 2 HVPs at nt
    ``HESS_NT_AC`` and one at ``HESS_NT2_AC``, whose peak memory against
    the first's gives the memory a time step adds; elastic 2 at
    ``HESS_NT_EL`` on the ``l2`` misfit), the acoustic first HVP and the
    elastic misfit's HVP in model space each against a central
    difference of two float64 gradients (relative L2 error <=
    ``HVP_CD_TOL``), each HVP's seconds and peak memory;
23. ``parallel/`` on ``torch.distributed``, each run in child processes
    (``parallel/dryrun.py::spawn``, a ``file://`` store) that load phase
    1's kernel library: run A on one rank (NCCL, ``cuda:0``),
    ``train()`` of ``AcousticDIPEngine(marmousi_acoustic,
    mesh=make_mesh())`` at full width for ``MESH_EPOCHS`` epochs
    (``fused+mesh``, B1 resident twice at setup, B2 resident once an
    epoch), every epoch's loss and the final weights equal to the bit to
    ``train()`` without a mesh, then ``ElasticDIPEngine(marmousi_elastic,
    mesh=...)`` for ``MESH_EL_LSTART`` + 3 epochs (the 30 warmup epochs
    cut to ``MESH_EL_LSTART``; B3 resident once a physics epoch, the
    ring forward at setup); run B on two ranks sharing the card (gloo,
    every CUDA tensor through the host): the same acoustic engine, 9
    shots a rank, every rank's weights equal to the bit after each step,
    the first step's loss and its dJ/dvp at the initial model against
    run A's (``MESH_FIRST_RTOL``), the later epochs' (``MESH_DRIFT_RTOL``),
    ``parallel/dryrun.py``'s four layouts at world 2, the halo
    decomposition's value and gradient (``simulate_acoustic_dd`` at the
    halo tests' 32 x 88, nt 160, 2 shots: every rank's dJ/dvp and
    dJ/dwavelet equal, all held to one rank's ``simulate_acoustic`` under
    autograd, ``HALO_TOL``, timed), and
    ``loss_surface_2d_sharded`` of the elastic landscape engine (3 x 3
    points, 5 a rank with the pad, the ring forward resident a point)
    against rank 0's ``loss_surface_2d``.  Each run prints its launches
    by kernel and route, its seconds and peak memory per rank, and the
    card's name and power limit.
24. kernel B9 (``build_variant``: B2's forward sweep with the source,
    the receiver rows and the checkpoints switched on at compile time) at
    ``benchmarks/bench_kernel_breakdown.py``'s case (151 x 200, PML 20,
    nt 4001 run for 126 x 32 steps, 18 shots on row 1, KC 32): the four
    cumulative variants once on the path (4 resident launches, every
    other count 0), each against its plain version, its time (the ported
    harness's ``measure_once``: ``time_fn``'s chained calls, which also
    time resident B2 on the same inputs as the ``full`` row) beside the
    plain version's, the bound and the previous variant's, and the eight
    B9 instances' registers and spills.

25. the experiment tools (``physicsbasedfwi2_tpu_torch/experiments/``,
    the JAX package's ``benchmarks/`` tools that time nothing), under a
    temporary directory removed at the end: ``make_realdata_su`` at
    ``real_data``'s shape (150 x 300 at dx 30 m, 12 shots x 280
    receivers, nt 2001; the split-PML scheme, no kernel), its SU headers
    and gathers, then ``real_data`` for lstart + 1 epochs on the result
    (B3 resident once); the canonical Marmousi's known-density tree
    (``prep --physics elastic --rho-start true``, 100 x 300, nt 3334,
    the ring forward resident once), a two-epoch ``marmousi_elastic`` run
    from it (lstart 1, B3 resident once) whose checkpoint defines path D,
    and ``misfit_linescan`` on all 35 shots, paths T and D at 5 points
    each (10 resident ring forwards and no other launch; the
    trace-normalized L2 at the truth below the start's);
    ``adam_vs_lbfgs``'s two elastic arms on the tool's synthetic
    workload (no ``--dataroot``) at the registered nt 3334 and a budget
    of ``AVL_BUDGET`` shot-gradients, each engine built through the
    tool's ``engine=`` hook (Adam: 14 physics steps of 5 shots, B3
    resident each; L-BFGS: ``marmousi_elastic_lbfgs``'s warmup and first
    physics epoch on the "fast" path, each 35-shot value and gradient
    timed, the budget the shots times the line search's probes, the
    accepted step's decrease, the peak memory).  ``run_latent_flagship``
    runs in phase 19.
26. the timing harnesses (``physicsbasedfwi2_tpu_torch/experiments/``:
    ``bench``, ``bench_configs``, ``bench_elastic``,
    ``bench_kernel_breakdown``), each through its ``main`` at cut counts:
    ``bench`` with 1 timed iteration a line on the kernels (``pallas``,
    ``fused``) and its two end-to-end lines at 1 iteration;
    ``bench_configs --only marmousi_acoustic`` and ``--only mcdip_uq`` at
    1 iteration; ``bench_elastic`` at nt ``HARNESS_EL_NT``; the breakdown
    harness at phase 24's case.  Every JSON line is parsed: no error
    row, the card's ``nvidia-smi`` line as ``device``, every number
    finite, every kernel path resident (``fused-resident``, or the
    engine's ``fused-cuda`` with only resident launches), and each
    harness's kernels launched (none for ``bench_elastic``'s split-PML
    scheme).  Then the host syncs one ``pallas`` and one ``fused`` value
    and gradient make (``torch.cuda.set_sync_debug_mode``), reported.

Each path reads its kernels' launch counts, set to 0 just before it; a
kernel's launches in the kernels line are the sum over the paths.  The
comparisons against float64 runs of the plain versions in phases 4, 8
and 17 run at a cut depth (``ACC_NT_EL``, ``ACC_NT_AC``,
``ACC_NT_SEAM``); every other comparison, timing and path at its own.
Device traces count only the records between two marker kernels around
the call, with host waits inside the trace before and after them, so
no trace's counts depend on the traces before it.
The line before the last is a JSON object with each kernel's launches,
error, times and bound (every kernel: ``ms`` on the resident route,
``per_step_ms`` on the per-step one; B3 and the ring forward also their
``seam_*`` and ``real_data_*`` times, on both routes, and bounds at
SEAM's and real_data's grids; B3 its layout 1 8-row band's
``layout1_r8_ms`` beside ``layout0_r8_ms``); the last line is
the result object.  The
script never falls back to the CPU or to the plain versions.
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "physicsbasedfwi2_tpu_torch/csrc/scalar2.cu"
EL_SOURCE = "physicsbasedfwi2_tpu_torch/csrc/elastic.cu"
AC_SOURCE = "physicsbasedfwi2_tpu_torch/csrc/acoustic.cu"
NT = 4001  # marmousi_acoustic's time steps
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
# HBM bandwidth
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# flops per cell per time step, counted from the schemes (PERF.md):
# B1/B2's forward (4th-order Laplacian 11 + update 6) and adjoint; B3's
# forward (6 staggered derivatives, 2 velocity and 3 stress updates)
# and its exact transpose.  The recompute that checkpointing adds is
# not counted: the card could keep every state instead.
FLOPS_B1 = 17
FLOPS_B2_ADJ = 20
FLOPS_B3 = 68
FLOPS_B3_ADJ = 99
# B5's forward (4 staggered derivatives at 5, p = px + pz, 4 updates at
# 3) and B6's transpose (4 derivatives at 5, 2 weights, kap products 2,
# imaging 4, 4 cotangent updates, pb0 2, 2 sums)
FLOPS_B5 = 33
FLOPS_B6_ADJ = 36


BUILD_LOG = []  # phase 1's nvcc report (empty where the library existed)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def timed_ms(fn, repeats: int = 3) -> tuple[object, float]:
    """(result of a warm-up call, mean milliseconds of ``repeats`` more
    calls), timed with CUDA events."""
    import torch
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop) / repeats


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of flops over the
    float32 peak and bytes over the HBM rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _flat(out) -> tuple:
    """The tensors of a kernel's output, nested tuples flattened."""
    if not isinstance(out, tuple):
        return (out,)
    return tuple(x for o in out for x in _flat(o))


def route_turns(name: str, fn, steps: int, repeats: int = 2,
                exact: bool = False) -> dict:
    """Time ``fn(route)`` on a kernel's two routes in turns
    (per-step, resident, resident, per-step; each turn a warm-up call
    and ``repeats`` timed ones), print each route's ms and us per time
    step (``steps`` of them per call) and how far the two outputs are
    apart, and check that they agree bit for bit (``exact``) or, where
    FMA contraction differs, within 1e-6 of max.  Returns each route's
    output and time."""
    import torch
    outs, times = {}, {"per_step": [], "resident": []}
    for route in ("per_step", "resident", "resident", "per_step"):
        outs[route], ms = timed_ms(lambda: fn(route), repeats=repeats)
        times[route].append(ms)
    diffs = [float((a.double() - b.double()).abs().max())
             / max(float(b.abs().max()), 1e-30)
             for a, b in zip(_flat(outs["resident"]), _flat(outs["per_step"]))]
    same = all(torch.equal(a, b) for a, b in
               zip(_flat(outs["resident"]), _flat(outs["per_step"])))
    ms_r = sum(times["resident"]) / 2
    ms_s = sum(times["per_step"]) / 2
    print(f"{name} routes in turns (per-step, resident, resident, "
          f"per-step): resident {times['resident'][0]:.2f}, "
          f"{times['resident'][1]:.2f} ms ({ms_r / steps * 1e3:.3f} us per "
          f"step), per-step {times['per_step'][0]:.2f}, "
          f"{times['per_step'][1]:.2f} ms ({ms_s / steps * 1e3:.3f} us per "
          f"step; {steps} steps a call); outputs bit-equal: {same}, largest "
          f"difference {max(diffs):.3e} of max (tol 1e-6)")
    check(max(diffs) <= 1e-6, f"{name}: resident and per-step routes "
          f"disagree")
    check(same or not exact, f"{name}: resident and per-step routes are "
          f"not bit-equal")
    return {"out": outs["resident"], "per_step_out": outs["per_step"],
            "ms": ms_r, "per_step_ms": ms_s}


def cluster_report(ns: int, group: int = 1) -> None:
    """The flagship grid's resident plan and how many of its clusters
    the card keeps resident (cudaOccupancyMaxActiveClusters), for the
    sweeps' instance with checkpoints grouped ``group`` shots at a time
    (1: B1, B2, B4; 2: B7)."""
    from physicsbasedfwi2_tpu_torch.ops import scalar2
    plan = scalar2.resident_plan(192, 256)
    fwd = scalar2.max_active_clusters(plan, ns, 192, 256, group=group)
    rev = scalar2.max_active_clusters(plan, ns, 192, 256, reverse=True,
                                      group=group)
    print(f"resident plan for {ns} shots on 192 x 256 (checkpoints in "
          f"groups of {group}): {plan}; clusters resident at once: forward "
          f"{fwd}, reverse {rev} (of {ns})")
    check(min(fwd, rev) >= 1, "the resident sweeps cannot be resident")


def ac_cluster_report(ns: int) -> None:
    """The flagship grid's resident plan of B5/B6 and how many of its
    clusters the card keeps resident (cudaOccupancyMaxActiveClusters)."""
    from physicsbasedfwi2_tpu_torch.ops import kernels
    plan = kernels.acoustic_resident_plan(192, 256)
    fwd = kernels.acoustic_max_active_clusters(plan, ns, 192, 256)
    rev = kernels.acoustic_max_active_clusters(plan, ns, 192, 256,
                                               reverse=True)
    print(f"B5/B6 resident plan for {ns} shots on 192 x 256: {plan}; "
          f"clusters resident at once: forward {fwd}, reverse {rev} (of "
          f"{ns})")
    check(min(fwd, rev) >= 1, "B5/B6's resident kernels cannot be resident")


def el_cluster_report(ns: int, nz8: int = 128, nx128: int = 384,
                      plan=None, what: str = "B3") -> None:
    """B3's resident plan for an [nz8, nx128] grid (by default
    marmousi_elastic's 128 x 384 in kernel layout; ``plan`` another one
    for it) and how many of its clusters the card keeps resident
    (cudaOccupancyMaxActiveClusters)."""
    from physicsbasedfwi2_tpu_torch.ops import elastic_fused as ef
    plan = plan or ef.elastic_resident_plan(nz8, nx128)
    check(plan is not None, f"no B3 resident plan holds {nz8} x {nx128}")
    fwd = ef.elastic_max_active_clusters(plan, ns, nz8, nx128)
    rev = ef.elastic_max_active_clusters(plan, ns, nz8, nx128,
                                         reverse=True)
    print(f"{what} resident plan for {ns} shots on {nz8} x {nx128}: "
          f"{plan}; clusters resident at once: forward {fwd}, reverse "
          f"{rev} (of {ns}; {plan.cluster * min(ns, fwd)} of 132 SMs "
          f"busy)")
    check(min(fwd, rev) >= 1, f"{what}'s resident kernels cannot be "
          f"resident")


def el_ptxas(rows: int, layout: int) -> None:
    """phase 1's ptxas line (registers, spills) of each resident
    instance of csrc/elastic.cu for bands of ``rows`` rows in
    ``layout`` (none where the library existed before the run)."""
    import re
    for log in BUILD_LOG:
        for line in ptxas_summary(log, ("el_fwd_resident",
                                        "el_rev_resident")):
            m = re.search(r"(el_\w+_resident<R (\d+),[^>]*layout (\d)>)"
                          r"\S*: (.*)", line)
            if m and (int(m[2]), int(m[3])) == (rows, layout):
                print(f"  ptxas: {m[1]}: {m[4]}")


def fwd_cluster_report(ns: int, nz8: int, nx128: int, what: str) -> None:
    """The forward sweep's resident plan for an [nz8, nx128] grid (the
    ring forward's and B8's) and how many of its clusters the card keeps
    resident (cudaOccupancyMaxActiveClusters), which sets the waves."""
    from physicsbasedfwi2_tpu_torch.ops import elastic_fused as ef
    plan = ef.elastic_forward_plan(nz8, nx128)
    check(plan is not None, f"no resident plan holds {what}'s grid")
    n = ef.elastic_forward_max_active_clusters(plan, ns, nz8, nx128)
    print(f"{what} resident plan for {ns} shots on {nz8} x {nx128}: {plan}; "
          f"clusters resident at once: {n} (of {ns}: "
          f"{-(-ns // max(n, 1))} waves)")
    check(n >= 1, f"{what}'s resident kernel cannot be resident")


def _readable(name: str) -> str:
    """A mangled el_fwd_resident<R, CK, L1> instance as R, checkpoints
    and layout, el_rev_resident (layout 0's, 8 rows) and
    el_rev_resident_l1<R> as R and layout, and fwd_resident<P> /
    rev_resident<P> as their checkpoint group."""
    import re
    name = re.sub(r"el_fwd_residentILi(\d+)ELb([01])ELb([01])E",
                  lambda m: f"el_fwd_resident<R {m[1]}, "
                  f"{'checkpoints' if m[2] == '1' else 'no checkpoints'}, "
                  f"layout {m[3]}>", name)
    name = re.sub(r"el_rev_residentENS", "el_rev_resident<R 8, layout 0>NS",
                  name)
    name = re.sub(r"el_rev_resident_l1ILi(\d+)EE",
                  lambda m: f"el_rev_resident<R {m[1]}, layout 1>", name)
    name = re.sub(r"b9_residentILi(\d+)EE", lambda m: "b9_resident<"
                  + (" ".join(f for b, f in ((2, "+src"), (4, "+rcv"),
                                             (8, "+ckpt"))
                              if int(m[1]) & b) or "stencil") + ">", name)
    return re.sub(r"(fwd|rev)_residentILi(\d+)EE",
                  lambda m: f"{m[1]}_resident<P {m[2]}>", name)


def ptxas_summary(log: str, keys) -> list[str]:
    """One line per compiled kernel whose mangled name holds one of
    ``keys``: registers, shared memory, stack and spills (nvcc -Xptxas
    -v)."""
    out, name, props = [], None, ""
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line:
            props = line
        elif name and "Used" in line and "registers" in line:
            if any(k in name for k in keys):
                out.append(f"{_readable(name)}: "
                           f"{line.split(':', 1)[1].strip()}; {props}")
            name = None
    return out


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (the
    harnesses' ``device``)."""
    import torch
    from physicsbasedfwi2_tpu_torch.experiments.timing import card
    return card(torch.device("cuda", 0))


def phase_card():
    import torch

    import physicsbasedfwi2_tpu_torch  # noqa: F401  (turns TF32 off)
    print(card_line())
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)} "
          f"(sm_{''.join(map(str, torch.cuda.get_device_capability(0)))})")
    cudnn = torch.backends.cudnn
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {cudnn.allow_tf32}; cudnn deterministic "
          f"{cudnn.deterministic}, benchmark {cudnn.benchmark}")
    check(not torch.backends.cuda.matmul.allow_tf32
          and not cudnn.allow_tf32, "TF32 must be off")
    check(cudnn.deterministic and not cudnn.benchmark,
          "cuDNN must be deterministic, without autotuning")
    from physicsbasedfwi2_tpu_torch.ops import cuda_build
    path, secs, log = cuda_build.build()
    BUILD_LOG.append(log)
    print(f"kernel build: {secs:.1f} s -> {path.relative_to(ROOT)}")
    for line in log.splitlines():
        if any(k in line for k in ("entry function", "registers", "spill",
                                   "error", ".cu:")):
            print(f"  ptxas: {line.strip()}")
    for line in ptxas_summary(log, ("resident", "misfit_tiles", "fwd_step",
                                    "adj_step", "el_fwd_", "el_adj_",
                                    "fwd_vel", "fwd_pres", "adj_vel",
                                    "adj_pres")):
        print(f"  ptxas, resident and per-step kernels: {line}")
    cuda_build.load_library()


def flagship_case(dev):
    """marmousi_acoustic's grid, geometry, true and starting models."""
    import torch
    from physicsbasedfwi2_tpu_torch.data.synthetic import (
        make_marmousi_like, smooth_model)
    from physicsbasedfwi2_tpu_torch.geo import Grid2D, ricker, surface_line
    from physicsbasedfwi2_tpu_torch.ops import AcousticConfig
    grid = Grid2D(nz=151, nx=200, dx=10.0, nt=NT, dt=0.001, pml_width=20)
    cfg = AcousticConfig(grid=grid, chunk=64, vmax_pml=5000.0)
    acq = surface_line(18, 200, 200)
    geom = tuple(torch.as_tensor(a, dtype=torch.int32, device=dev)
                 for a in (acq.src_z, acq.src_x, acq.rcv_z, acq.rcv_x))
    vp_np = make_marmousi_like(151, 200, seed=0, water_rows=26)
    vp = torch.as_tensor(vp_np, device=dev)
    vp0 = torch.as_tensor(smooth_model(vp_np, preserve_rows=26), device=dev)
    return cfg, ricker(8.0, NT, 0.001, device=dev), geom, vp, vp0


def phase_b1(dev):
    import torch
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import forward2, forward2_plain
    cfg, wav, geom, vp, _ = flagship_case(dev)
    cluster_report(len(geom[0]))
    turns = route_turns("B1 forward2", lambda r: forward2(
        vp, wav, *geom, cfg, return_rows=True, route=r), NT)
    rows_k, ms_k = turns["out"], turns["ms"]
    rows_p, ms_p = _plain_ms(lambda: forward2_plain(vp, wav, *geom, cfg,
                                                    return_rows=True))
    scale = float(rows_p.abs().max())
    err = float((rows_k - rows_p).abs().max())
    print(f"B1 forward2 [18 shots, nt {NT}, rows "
          f"{tuple(rows_k.shape)}]: max|err| {err:.3e} of max {scale:.3e} "
          f"(tol 1e-4 of max: FMA contraction and sum order differ); "
          f"kernel {ms_k:.2f} ms, plain {ms_p:.2f} ms")
    check(bool(torch.isfinite(rows_k).all()), "B1 rows not finite")
    check(err <= 1e-4 * scale, "B1 disagrees with its plain version")
    g = cfg.grid
    cells = len(geom[0]) * (g.nz + g.top_pad + g.pml_width) * (
        g.nx + 2 * g.pml_width)
    nz8, nx128 = 192, 256
    io = 3 * nz8 * nx128 * 4 + nbytes(wav, *geom[:3], rows_k)
    return {"max_abs_err": err, "ms": ms_k, "plain_ms": ms_p,
            "per_step_ms": turns["per_step_ms"],
            **bound(FLOPS_B1 * cells * g.nt, io), "library_ms": None}


def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm())


def phase_b2(dev):
    """B2 against its plain version (1) on a misfit whose residuals
    never change sign (observed rows offset by 3), where the kernel must
    be as accurate as the plain version against a float64 run of the
    same algorithm (the gradient's zero-lag correlation cancels strongly,
    so float32 rounding alone moves it ~1e-4), (2) on the real misfit, whose L1 kinks make the
    gradient follow rounding wherever a residual is near zero, held to
    the plain version's own sensitivity, and (3) the loss at the true
    model."""
    import torch
    from physicsbasedfwi2_tpu_torch.ops import trace_normalize
    from physicsbasedfwi2_tpu_torch.ops.fwi_fused import (
        fwi_l1_loss_grad, fwi_l1_loss_grad_plain, scatter_rows)
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import (
        forward2, forward2_plain)
    cfg, wav, geom, vp, vp0 = flagship_case(dev)
    g = cfg.grid
    const = torch.full_like(vp, 1500.0)
    dir_rows = forward2(const, wav, *geom, cfg, return_rows=True)
    cols = geom[3].long() + g.pml_width
    idx = cols[:, None, :].expand(-1, g.nt, -1)
    obs = forward2(vp, wav, *geom, cfg) - torch.gather(dir_rows, 2, idx)
    obs_rows = scatter_rows(trace_normalize(obs), geom[3], nt=g.nt,
                            nx=g.nx, pml_width=g.pml_width)
    pad = obs_rows.shape[1] - g.nt
    dir_pad = torch.nn.functional.pad(dir_rows, (0, 0, 0, pad)).contiguous()

    def kernel(o, d=dir_pad, v=vp0, route=None, KC=32):
        return fwi_l1_loss_grad(v, wav, *geom, cfg, o, d, route=route, KC=KC)

    def plain(o, d=dir_pad, v=vp0):
        return fwi_l1_loss_grad_plain(v, wav, *geom, cfg, o, d)

    # (1) |yn| <= 1 and |obs| <= 1, so yn - (obs + 3) < 0 everywhere
    off = (obs_rows + 3.0).contiguous()
    turns = route_turns("B2 fwi_l1_loss_grad", lambda r: kernel(off, route=r),
                        3 * obs_rows.shape[1])
    (lk, gk), ms_k = turns["out"], turns["ms"]
    for route in ("resident", "per_step"):
        n = phase_trace(f"B2 ({route} route)",
                        lambda: kernel(off, route=route))
        if route == "resident":
            check(n["fwd_resident"] == 1 and n["rev_resident"] == 1,
                  "resident B2 is not one launch a sweep")
    kc_turns(kernel, obs_rows, dir_pad, g.nt)
    (lp, gp), ms_p = _plain_ms(lambda: plain(off))
    lr, gr = fwi_l1_loss_grad_plain(vp0, wav, *geom, cfg, off, dir_pad,
                                    dtype=torch.float64)
    lk, lp, lr = float(lk), float(lp), float(lr)
    rel_loss = abs(lk - lp) / abs(lp)
    rel_g = _rel_l2(gk, gp)
    err_k, err_p = _rel_l2(gk.double(), gr), _rel_l2(gp.double(), gr)
    err = float((gk - gp).abs().max())
    print(f"B2 fwi_l1_loss_grad [18 shots, nt {NT}, residual "
          f"signs fixed]: loss {lk:.9g} vs plain {lp:.9g} (rel "
          f"{rel_loss:.2e}, tol 1e-5); grad rel L2 vs plain {rel_g:.2e}, "
          f"max|err| {err:.3e} of max {float(gp.abs().max()):.3e}; against "
          f"the plain version in float64: kernel {err_k:.2e}, plain float32 "
          f"{err_p:.2e} (tol max(1e-4, 2x plain)); kernel {ms_k:.2f} ms, "
          f"plain {ms_p:.2f} ms")
    check(math.isfinite(lk) and bool(torch.isfinite(gk).all()),
          "B2 output not finite")
    check(rel_loss <= 1e-5, "B2 loss disagrees with its plain version")
    check(abs(lk - lr) <= 1e-5 * abs(lr), "B2 loss vs float64")
    check(err_k <= max(1e-4, 2.0 * err_p),
          "B2 gradient is less accurate than its plain version")

    # (2) the real misfit, each side with obs and direct rows made by its
    # own forward (as the engine does): in the window before the scattered
    # arrivals y = pred - direct cancels, and the L1 signs there follow
    # rounding; the plain gradient's move under a 1e-7 relative change of
    # its direct rows measures that sensitivity
    dir_p = forward2_plain(const, wav, *geom, cfg, return_rows=True)
    obs_p = (forward2_plain(vp, wav, *geom, cfg)
             - torch.gather(dir_p, 2, idx))
    obs_rows_p = scatter_rows(trace_normalize(obs_p), geom[3], nt=g.nt,
                              nx=g.nx, pml_width=g.pml_width)
    dir_pad_p = torch.nn.functional.pad(dir_p, (0, 0, 0, pad)).contiguous()
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = torch.randn(dir_pad_p.shape, generator=gen, device=dev)
    dir_pert = (dir_pad_p * (1.0 + 1e-7 * noise)).contiguous()
    lk2, gk2 = kernel(obs_rows)
    lp2, gp2 = plain(obs_rows_p, dir_pad_p)
    lq2, gq2 = plain(obs_rows_p, dir_pert)
    rel_self = _rel_l2(gq2, gp2)
    rel_loss_self = abs(float(lq2) - float(lp2)) / abs(float(lp2))
    rel_g2 = _rel_l2(gk2, gp2)
    rel_loss2 = abs(float(lk2) - float(lp2)) / abs(float(lp2))
    print(f"B2 on the real misfit: loss {float(lk2):.9g} vs plain "
          f"{float(lp2):.9g} (rel {rel_loss2:.2e}), grad rel L2 "
          f"{rel_g2:.2e}; under a 1e-7 change of its direct rows the plain "
          f"loss moves {rel_loss_self:.2e} and its gradient {rel_self:.2e} "
          f"(tol max(1e-5, 10x) and max(1e-4, 10x))")
    check(rel_loss2 <= max(1e-5, 10.0 * rel_loss_self),
          "B2 loss (real misfit) disagrees")
    check(rel_g2 <= max(1e-4, 10.0 * rel_self),
          "B2 gradient (real misfit) disagrees beyond the misfit's own "
          "sensitivity")

    # (3) obs and direct rows come from B1, the misfit from B2
    l_true, _ = kernel(obs_rows, v=vp)
    print(f"B2 loss at the true model: {float(l_true):.3e} (tol 1e-6)")
    check(float(l_true) <= 1e-6, "B2 loss at the true model is not ~0")
    ns = len(geom[0])
    cells = ns * (g.nz + g.top_pad + g.pml_width) * (g.nx + 2 * g.pml_width)
    flops = (FLOPS_B1 + FLOPS_B2_ADJ) * cells * g.nt
    # K, d+, d- on [192, 256], the wavelet, the source cells and rows,
    # obs and direct rows and the receiver mask in; dJ/dK and the loss out
    io = (3 * 192 * 256 * 4 + nbytes(wav, *geom) + 2 * nbytes(obs_rows)
          + ns * 256 * 4 + 192 * 256 * 4 + 4)
    return {"max_abs_err": err, "ms": ms_k, "plain_ms": ms_p,
            "per_step_ms": turns["per_step_ms"], **bound(flops, io),
            "library_ms": None}


def kc_turns(kernel, rows, dirs, nt: int) -> None:
    """Resident B2 at the engine's KC 32 and at KC 8, in turns (32, 8,
    8, 32; each turn a warm-up call and 2 timed ones) on the same rows
    cut to each KC's padding, and each call's peak device memory above
    what was allocated before it.  At 18 shots the Laplacian cache is
    113 MB at KC 32 (more than the 50 MB L2) and 28 MB at KC 8, which
    holds 4x the checkpoints.  The two must agree within 1e-6 of max
    (recompute from a checkpoint is exact)."""
    import torch
    args = {kc: tuple(a[:, :-(-nt // kc) * kc].contiguous()
                      for a in (rows, dirs)) for kc in (32, 8)}
    outs, times, peak = {}, {32: [], 8: []}, {}
    for kc in (32, 8, 8, 32):
        outs[kc], ms = timed_ms(lambda: kernel(*args[kc], route="resident",
                                               KC=kc), repeats=2)
        times[kc].append(ms)
    for kc in (32, 8):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernel(*args[kc], route="resident", KC=kc)
        torch.cuda.synchronize()
        peak[kc] = (torch.cuda.max_memory_allocated() - base) / 2**30
    diffs = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
             for a, b in zip(outs[8], outs[32])]
    same = all(torch.equal(a, b) for a, b in zip(outs[8], outs[32]))
    print(f"B2 resident at KC 32 and KC 8 in turns (32, 8, 8, 32): KC 32 "
          f"{times[32][0]:.2f}, {times[32][1]:.2f} ms, peak {peak[32]:.3f} "
          f"GiB above its inputs; KC 8 {times[8][0]:.2f}, {times[8][1]:.2f} "
          f"ms, peak {peak[8]:.3f} GiB; outputs bit-equal: {same}, largest "
          f"difference {max(diffs):.3e} of max (tol 1e-6)")
    check(max(diffs) <= 1e-6, "B2 at KC 8 and KC 32 disagree")


MARK_CYCLES = 1_000_000  # the trailing marker kernel's spin, ~0.5 ms
LEAD_MARKS = 1024  # short marker kernels before the call (~1 us each)
TRACE_WAIT_S = 0.25  # host wait after a trace starts and before it stops


def device_records(fn) -> list[tuple[str, int, int]]:
    """The CUDA records (name, start ns, end ns) of one call of ``fn`` in
    a device trace (torch.profiler, CUDA activity only), counted between
    marker kernels (``torch.cuda._sleep``) on the same stream: the last
    of ``LEAD_MARKS`` short ones launched before the call and a long one
    launched after it.  So no record from outside the call is counted,
    and a trace's counts do not depend on the traces taken before it.

    The trace loses records in three ways (``trace_probe.py``): the
    last ones where it stops right after them (up to a few hundred of a
    25,000-kernel call, the trailing marker with them); the first ones
    where its GPU clock runs a few ms ahead of its host clock; and,
    whatever the waits, its first few, more as the process takes more
    traces.  The host waits ``TRACE_WAIT_S`` after the trace starts and
    before it stops, against the first two (at 0.05 s one trace of B3's
    per-step route, ~20,000 records, lost its trailing marker on an
    H100); the leading markers are spares against the third.  Fails unless the trailing marker is the
    trace's last record and a leading one is in the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_WAIT_S)
        for _ in range(LEAD_MARKS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        fn()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        time.sleep(TRACE_WAIT_S)
    records = [(e.name(), e.start_ns(), e.end_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    marks = sorted((t0, t1) for name, t0, t1 in records
                   if "spin_kernel" in name)
    last = max((t1 for _, _, t1 in records), default=None)
    check(len(marks) >= 2 and marks[-1][1] == last,
          f"the device trace lacks a marker kernel: {len(marks)} of "
          f"{LEAD_MARKS + 1} in {len(records)} records")
    if len(marks) < LEAD_MARKS + 1:
        print(f"  (device trace: {LEAD_MARKS + 1 - len(marks)} of the "
              f"{LEAD_MARKS} leading marker kernels not recorded)")
    lo, hi = marks[-2][1], marks[-1][0]
    return [(name, t0, t1) for name, t0, t1 in records
            if "spin_kernel" not in name and t0 >= lo and t1 <= hi]


def phase_trace(name: str, fn):
    """Device time of one call of ``fn`` by kernel name (the records
    between the markers of :func:`device_records`), its span from the
    first kernel's start to the last one's end, and the busy share of
    that span; returns the launches by name."""
    import collections
    ns_by = collections.Counter()
    n_by = collections.Counter()
    records = device_records(fn)
    for full, t0, t1 in records:
        key = full.replace("(anonymous namespace)::", "")
        key = key.removeprefix("void ").split("(")[0].split("<")[0]
        key = key.split("::")[-1].strip()[:40]
        ns_by[key] += t1 - t0
        n_by[key] += 1
    span = ((max(t1 for _, _, t1 in records) - min(t0 for _, t0, _ in records))
            / 1e6 if records else 0.0)
    busy = sum(ns_by.values()) / 1e6
    parts = ", ".join(f"{k} {v / 1e6:.3f} ms in {n_by[k]}"
                      for k, v in ns_by.most_common())
    print(f"{name}, device trace of one call: {parts}; span {span:.3f} ms, "
          f"busy {busy / max(span, 1e-9):.4f}")
    check(busy > 0, f"{name}: the device trace holds no kernel")
    return n_by


def elastic_case(dev, free_surface=None, workload="marmousi_elastic"):
    """An elastic workload's grid (its free surface unless
    ``free_surface`` says otherwise), its shots on its acquisition rows,
    true and starting media, without the workload's simulation: by
    default marmousi_elastic's (35 shots), or seam_elastic's (38 shots,
    sources on row 6, receivers on row 23)."""
    import torch
    from physicsbasedfwi2_tpu_torch.data.synthetic import (
        make_elastic_model, make_marmousi_like, smooth_model)
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.geo import Grid2D, elastic_line, ricker
    from physicsbasedfwi2_tpu_torch.ops.elastic import ElasticConfig
    c = get_workload(workload)
    grid = Grid2D(nz=c.nz, nx=c.nx, dx=c.dx, nt=c.nt, dt=c.dt,
                  pml_width=c.pml_width,
                  free_surface=(c.free_surface if free_surface is None
                                else free_surface))
    cfg = ElasticConfig(grid=grid, chunk=c.chunk, vmax_pml=5000.0)
    vp = make_marmousi_like(c.nz, c.nx, seed=c.seed, water_rows=c.water_rows)
    true = make_elastic_model(vp, water_rows=c.water_rows)
    start = [smooth_model(a, preserve_rows=c.water_rows) for a in true]
    acq = elastic_line(
        c.num_shots, c.num_receivers, c.nx, c.nz,
        src_row=c.extras.get("src_depth_row", c.water_rows + 1),
        rcv_row=c.extras.get("rcv_depth_row", c.water_rows + 1))
    geom = tuple(torch.as_tensor(a, dtype=torch.int32, device=dev)
                 for a in (acq.src_z, acq.src_x, acq.rcv_z, acq.rcv_x))

    def dev_(arrays):
        return tuple(torch.as_tensor(a, device=dev) for a in arrays)

    return (cfg, ricker(c.freq, c.nt, c.dt, device=dev), geom, dev_(true),
            dev_(start))


def _rel_meds(got, ref) -> float:
    """The largest relative L2 error over the five medium gradients."""
    return max(_rel_l2(a.double(), b.double()) for a, b in zip(got, ref))


def phase_b3(dev):
    """B3 and the ring forward against their plain versions at the
    elastic path's shapes: (1) the ring forward of all 35 shots, as the
    engine's setup runs it, its two routes timed in turns and held to bit
    equality, a device trace of one resident call, and its plan with the
    clusters resident; then B3 on 5 of them (every 7th), as a
    physics epoch draws them: (2) the ``l2`` misfit
    and (3) ``tnl1`` with residual signs fixed (observed rows + 3), at
    ACC_NT_EL of the 3334 steps, each held to the plain version's own
    float32 error against a float64 run of the same algorithm; (4)
    ``tnl1`` on the real misfit,
    held to the plain gradient's move under a 1e-7 relative change of
    its observed rows; (5) the loss at the true model.  (2)-(5) run on
    B3's resident route, the engine's at this shape; its two routes are
    timed in turns on the same inputs and held to bit equality."""
    import dataclasses

    import torch
    from physicsbasedfwi2_tpu_torch.ops import trace_normalize
    from physicsbasedfwi2_tpu_torch.ops.elastic_fused import (
        _layout, elastic_resident_plan, fused_elastic_loss_grad_meds,
        fused_elastic_loss_grad_meds_plain, prep_damp, prep_medium,
        scatter_rows_el, simulate_elastic_ring, simulate_elastic_ring_plain)
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import reset_launches
    cfg, wav, geom_all, true, start = elastic_case(dev)
    g = cfg.grid

    # (1) the ring forward: both routes in turns, bit for bit, then the
    # resident one (the engine's) against the plain version
    fwd_cluster_report(len(geom_all[0]), *_layout(cfg)[4:], "ring forward")
    ring_turns = route_turns("ring forward", lambda r: simulate_elastic_ring(
        *true, wav, *geom_all, cfg, route=r), g.nt, exact=True)
    (ovx, ovz), ms_rk = ring_turns["out"], ring_turns["ms"]
    n = phase_trace("ring forward (resident route)",
                    lambda: simulate_elastic_ring(*true, wav, *geom_all, cfg))
    check(n["el_fwd_resident"] == 1,
          "the resident ring forward is not one launch a call")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        pvx, pvz = simulate_elastic_ring_plain(*true, wav, *geom_all, cfg)
    torch.cuda.synchronize()
    ms_rp = (time.perf_counter() - t0) * 1e3
    scale = max(float(pvx.abs().max()), float(pvz.abs().max()))
    err_r = max(float((ovx - pvx).abs().max()), float((ovz - pvz).abs().max()))
    print(f"ring forward [{len(geom_all[0])} shots, nt {g.nt}]: max|err| "
          f"{err_r:.3e} of max {scale:.3e} (tol 1e-4 of max); kernel "
          f"{ms_rk:.2f} ms (resident), plain {ms_rp:.2f} ms")
    check(bool(torch.isfinite(ovx).all() and torch.isfinite(ovz).all()),
          "ring forward not finite")
    check(err_r <= 1e-4 * scale, "ring forward disagrees with its plain "
          "version")
    ring_cells = len(geom_all[0]) * (g.nz + 2 + g.pml_width) * (
        g.nx + 2 * g.pml_width)
    ring_io = 6 * 128 * 384 * 4 + nbytes(wav, *geom_all, ovx, ovz)
    pick = torch.arange(0, len(geom_all[0]), 7, device=dev)
    geom = tuple(a[pick].contiguous() for a in geom_all)
    ovx, ovz = ovx[pick], ovz[pick]
    ns, nr = geom[3].shape
    shape = f"[{ns} shots x {nr} receivers, nt {g.nt}]"
    el_cluster_report(ns)

    damp = prep_damp(cfg, dev)
    check(elastic_resident_plan(*damp.shape) is not None,
          "no resident plan holds marmousi_elastic's grid")
    meds = prep_medium(*start, cfg)
    rows = {"l2": tuple(scatter_rows_el(o, geom[3], cfg, KC=8)
                        for o in (ovx, ovz)),
            "tnl1": tuple(scatter_rows_el(trace_normalize(o), geom[3], cfg,
                                          KC=8) for o in (ovx, ovz))}

    def kernel(misfit, obs, m=meds, route=None, wav=wav, cfg=cfg):
        return fused_elastic_loss_grad_meds(m, damp, wav, *geom, cfg, *obs,
                                            KC=8, misfit=misfit, route=route)

    # both routes in turns on the same inputs, bit for bit; a device
    # trace of one call on each
    steps = 3 * rows["l2"][0].shape[1]  # forward, recompute, adjoint
    route_turns("B3 l2", lambda r: kernel("l2", rows["l2"], route=r), steps,
                exact=True)
    turns = route_turns("B3 tnl1", lambda r: kernel("tnl1", rows["tnl1"],
                                                    route=r),
                        steps, exact=True)
    for route in ("resident", "per_step"):
        n = phase_trace(f"B3 tnl1 ({route} route)",
                        lambda: kernel("tnl1", rows["tnl1"], route=route))
        if route == "resident":
            check(n["el_fwd_resident"] == 1 and n["el_rev_resident"] == 1,
                  "resident B3 is not one launch a sweep")
    layouts = b3_layout_turns(dev, kernel_args=(
        meds, damp, wav, *geom, cfg, *rows["tnl1"]), steps=steps)
    fn = fused_elastic_loss_grad_meds
    reset_launches(fn)

    def plain(misfit, obs, dtype=torch.float32, wav=wav, cfg=cfg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fused_elastic_loss_grad_meds_plain(
            meds, damp, wav, *geom, cfg, *obs, KC=8, misfit=misfit,
            dtype=dtype)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # (2), (3): the kernel as accurate as the plain version, at ACC_NT_EL
    # steps of the same traces
    cut = dict(wav=wav[:ACC_NT_EL].contiguous(), cfg=dataclasses.replace(
        cfg, grid=dataclasses.replace(g, nt=ACC_NT_EL)))
    rows_c = {"l2": tuple(scatter_rows_el(o[:, :ACC_NT_EL], geom[3],
                                          cut["cfg"], KC=8)
                          for o in (ovx, ovz)),
              "tnl1": tuple(scatter_rows_el(trace_normalize(
                  o[:, :ACC_NT_EL]), geom[3], cut["cfg"], KC=8)
                  for o in (ovx, ovz))}
    fixed = tuple((r + 3.0).contiguous() for r in rows_c["tnl1"])
    err = 0.0
    for name, misfit, obs in (("l2", "l2", rows_c["l2"]),
                              ("tnl1, residual signs fixed", "tnl1", fixed)):
        lk, gk = kernel(misfit, obs, **cut)
        (lp, gp), ms_p = plain(misfit, obs, **cut)
        (lr, gr), _ = plain(misfit, obs, torch.float64, **cut)
        lk, lp, lr = float(lk), float(lp), float(lr)
        rel_loss = abs(lk - lp) / abs(lp)
        err_k, err_p = _rel_meds(gk, gr), _rel_meds(gp, gr)
        err = max(err, max(float((a - b).abs().max()) for a, b in zip(gk, gp)))
        print(f"B3 {name} [{ns} shots x {nr} receivers, nt {ACC_NT_EL} of "
              f"{g.nt}]: loss {lk:.9g} vs plain {lp:.9g} (rel "
              f"{rel_loss:.2e}, tol 1e-5); largest gradient rel L2 vs plain "
              f"{_rel_meds(gk, gp):.2e}; against the plain version in "
              f"float64: kernel {err_k:.2e}, plain float32 {err_p:.2e} (tol "
              f"max(1e-4, 2x plain)); plain {ms_p:.2f} ms")
        check(math.isfinite(lk) and all(bool(torch.isfinite(a).all())
                                        for a in gk), f"B3 {name}: not finite")
        check(rel_loss <= 1e-5, f"B3 {name}: loss disagrees")
        check(abs(lk - lr) <= 1e-5 * abs(lr), f"B3 {name}: loss vs float64")
        check(err_k <= max(1e-4, 2.0 * err_p),
              f"B3 {name}: gradient less accurate than the plain version")

    # (4) the real tnl1 misfit (the main path's), timed in turns above
    (lk, gk), ms_k = kernel("tnl1", rows["tnl1"]), turns["ms"]
    (lp, gp), ms_p = plain("tnl1", rows["tnl1"])
    gen = torch.Generator(device=dev).manual_seed(0)
    pert = tuple((r * (1.0 + 1e-7 * torch.randn(r.shape, generator=gen,
                                                 device=dev))).contiguous()
                 for r in rows["tnl1"])
    (lq, gq), _ = plain("tnl1", pert)
    rel_self = _rel_meds(gq, gp)
    rel_loss_self = abs(float(lq) - float(lp)) / abs(float(lp))
    rel_g = _rel_meds(gk, gp)
    rel_loss = abs(float(lk) - float(lp)) / abs(float(lp))
    print(f"B3 tnl1 on the real misfit: loss {float(lk):.9g} vs plain "
          f"{float(lp):.9g} (rel {rel_loss:.2e}), largest gradient rel L2 "
          f"{rel_g:.2e}; under a 1e-7 change of its observed rows the plain "
          f"loss moves {rel_loss_self:.2e} and its gradient {rel_self:.2e} "
          f"(tol max(1e-5, 10x) and max(1e-4, 10x)); kernel {ms_k:.2f} ms, "
          f"plain {ms_p:.2f} ms")
    check(rel_loss <= max(1e-5, 10.0 * rel_loss_self),
          "B3 loss (real misfit) disagrees")
    check(rel_g <= max(1e-4, 10.0 * rel_self),
          "B3 gradient (real misfit) disagrees beyond the misfit's own "
          "sensitivity")

    # (5) obs from the ring-forward kernel, the misfit from B3
    meds_true = prep_medium(*true, cfg)
    for misfit in ("l2", "tnl1"):
        l_true, _ = kernel(misfit, rows[misfit], meds_true)
        print(f"B3 {misfit} loss at the true model: {float(l_true):.3e} "
              f"(tol 1e-9)")
        check(float(l_true) <= 1e-9, f"B3 {misfit} loss at the true model")
    print(f"B3 checks (2)-(5): {fn.launches} launches, resident "
          f"{fn.resident_launches}, per-step {fn.per_step_launches}")
    check(fn.per_step_launches == 0 and fn.resident_launches == fn.launches,
          "B3's checks did not run on the resident route")

    # free surface: 2 ring rows on top
    cells = ns * (g.nz + 2 + g.pml_width) * (g.nx + 2 * g.pml_width)
    field = damp.numel() * 4
    # media and damp in, five gradients out (kernel layout), the wavelet,
    # geometry, obs rows and the receiver mask in, the loss out
    b3_io = (11 * field + nbytes(wav, *geom) + 2 * nbytes(rows["tnl1"][0])
             + ns * damp.shape[1] * 4 + 4)
    return (
        {"max_abs_err": err, "ms": ms_k, "plain_ms": ms_p,
         "per_step_ms": turns["per_step_ms"], **layouts,
         **bound((FLOPS_B3 + FLOPS_B3_ADJ) * cells * g.nt, b3_io),
         "library_ms": None},
        {"max_abs_err": err_r, "ms": ms_rk, "plain_ms": ms_rp,
         "per_step_ms": ring_turns["per_step_ms"],
         **bound(FLOPS_B3 * ring_cells * g.nt, ring_io), "library_ms": None})


def b3_layout_turns(dev, kernel_args, steps: int) -> dict:
    """Layout 1's instance for 8-row bands (the media read through L1,
    the gradients in shared memory: SEAM's and real_data's layout, which
    no planner picks at 128 x 384) against the plan's layout 0 on the
    same ``tnl1`` inputs, on the resident route in turns (0, 1, 1, 0),
    bit for bit, with layout 1's clusters resident and ptxas lines.
    Returns both layouts' mean ms (comparison launches, not counted)."""
    import dataclasses
    from functools import partial

    import torch
    from physicsbasedfwi2_tpu_torch.ops import elastic_fused as ef
    nz8, nx128 = kernel_args[1].shape
    plans = {0: ef.elastic_resident_plan(nz8, nx128)}
    check(plans[0].layout == 0 and plans[0].band_rows == 8,
          "the 128 x 384 plan is not layout 0's 8-row bands")
    plans[1] = dataclasses.replace(plans[0], layout=1, smem_bytes=ef.el_smem(
        8, nx128, 1, reverse=True))
    ns = kernel_args[3].shape[0]
    el_cluster_report(ns, nz8, nx128, plans[1], "B3 layout 1, 8-row bands,")
    el_ptxas(8, 1)
    outs, times = {}, {0: [], 1: []}
    for layout in (0, 1, 1, 0):
        outs[layout], ms = timed_ms(lambda: ef._loss_grad_meds(
            partial(ef._loss_gmeds_cuda, route="resident",
                    plan=plans[layout]), *kernel_args, 8, "tnl1"),
            repeats=2)
        times[layout].append(ms)
    same = all(torch.equal(a, b) for a, b in zip(_flat(outs[0]),
                                                 _flat(outs[1])))
    ms0, ms1 = (sum(times[k]) / 2 for k in (0, 1))
    print(f"B3 tnl1 at {nz8} x {nx128}, 8-row bands, layouts in turns (0, "
          f"1, 1, 0): layout 0 {times[0][0]:.2f}, {times[0][1]:.2f} ms, "
          f"layout 1 {times[1][0]:.2f}, {times[1][1]:.2f} ms ("
          f"{ms1 / steps * 1e3:.3f} against {ms0 / steps * 1e3:.3f} us a "
          f"step of {steps}); outputs bit-equal: {same}")
    check(same, "B3's layouts 0 and 1 are not bit-equal")
    return {"layout0_r8_ms": ms0, "layout1_r8_ms": ms1}


def phase_slice(dev):
    import torch
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.train import train
    from physicsbasedfwi2_tpu_torch.ops import fwi_fused, scalar2
    cfg = get_workload("marmousi_acoustic",
                       save_dir=str(ROOT / "build" / "chip_smoke"))
    print(f"slice: marmousi_acoustic {cfg.nz}x{cfg.nx}, nt {cfg.nt}, "
          f"{cfg.num_shots} shots x {cfg.num_receivers} receivers, "
          f"{cfg.netG} filters {cfg.filters}")
    scalar2.reset_launches(scalar2.forward2, fwi_fused.fwi_l1_loss_grad)
    t0 = time.perf_counter()
    engine, history = train(cfg, epochs=3, quiet=True, device=dev)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"forward2": scalar2.forward2.launches,
                "fwi_l1_loss_grad": fwi_fused.fwi_l1_loss_grad.launches}
    routes = {k: (f.resident_launches, f.per_step_launches) for k, f in (
        ("forward2", scalar2.forward2),
        ("fwi_l1_loss_grad", fwi_fused.fwi_l1_loss_grad))}
    for rec in history:
        print("epoch", json.dumps(rec))
    epochs = ", ".join(f"{r['epoch_time']:.4f}" for r in history)
    print(f"slice: {total:.2f} s in all (engine setup included), "
          f"epochs {epochs} s, "
          f"launches {launches}, (resident, per-step) {routes}, physics "
          f"path {engine.physics_path}, "
          f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
          f"GiB")
    check(engine.physics_path == "fused-cuda",
          f"physics path {engine.physics_path}")
    check(launches["forward2"] >= 2, "B1 was not launched for obs + direct")
    check(launches["fwi_l1_loss_grad"] == 3, "B2 not launched once per epoch")
    check(routes["fwi_l1_loss_grad"] == (3, 0),
          "B2 did not take the resident route on every epoch")
    check(routes["forward2"][1] == 0, "B1 took the per-step route")
    for rec in history:
        for k, v in rec.items():
            if isinstance(v, float):
                check(math.isfinite(v), f"epoch {rec['epoch']}: {k}={v}")
    losses = [rec["loss_D"] for rec in history]
    check(len(set(losses)) == len(losses), f"loss_D does not move: {losses}")
    # the engine's own data must fit exactly at the true model
    loss_true, grad = engine.physics_value_and_grad(engine.wl.vp_true)
    print(f"slice: misfit at the true model {float(loss_true):.3e} "
          f"(tol 1e-6), gradient {tuple(grad.shape)}")
    check(float(loss_true) <= 1e-6, "engine misfit at the true model")
    check(tuple(grad.shape) == (cfg.nz, cfg.nx)
          and bool(torch.isfinite(grad).all()), "engine gradient")
    return launches


def phase_slice2(dev):
    import torch
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.engines import ElasticDIPEngine
    from physicsbasedfwi2_tpu_torch.engine.train import train
    from physicsbasedfwi2_tpu_torch.ops import elastic_fused
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import reset_launches
    cfg = get_workload("marmousi_elastic",
                       save_dir=str(ROOT / "build" / "chip_smoke"))
    print(f"slice 2: marmousi_elastic {cfg.nz}x{cfg.nx}, nt {cfg.nt}, "
          f"{cfg.num_shots} shots x {cfg.num_receivers} receivers "
          f"({cfg.shots_per_iter} per iteration), {cfg.netG} filters "
          f"{cfg.filters}, misfit {cfg.misfit}, stages {cfg.freq_stages}")
    torch.cuda.reset_peak_memory_stats(dev)
    b3 = elastic_fused.fused_elastic_loss_grad_meds
    ring = elastic_fused.simulate_elastic_ring
    reset_launches(b3, ring)
    t0 = time.perf_counter()
    engine = ElasticDIPEngine(cfg, device=dev)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    epochs = cfg.lstart + 3
    t0 = time.perf_counter()
    engine, history = train(cfg, epochs=epochs, quiet=True, engine=engine)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"fused_elastic_loss_grad": b3.launches,
                "simulate_elastic_ring": ring.launches}
    b3_routes = (b3.resident_launches, b3.per_step_launches)
    ring_routes = (ring.resident_launches, ring.per_step_launches)
    for rec in history[:2] + history[cfg.lstart - 1:]:
        print("epoch", json.dumps(rec))
    warm = [r["epoch_time"] for r in history[:cfg.lstart]]
    phys = [r["epoch_time"] for r in history[cfg.lstart:]]
    PHYSICS_EPOCH_S["marmousi_elastic"] = phys
    print(f"slice 2: engine setup {setup:.2f} s; {epochs} epochs in "
          f"{total:.2f} s; warmup epochs: first {warm[0]:.4f} s, median of "
          f"the rest {sorted(warm[1:])[len(warm[1:]) // 2]:.4f} s; physics "
          f"epochs {', '.join(f'{x:.4f}' for x in phys)} s; launches "
          f"{launches}, (resident, per-step) B3 {b3_routes}, ring forward "
          f"{ring_routes}; physics path "
          f"{engine.physics_path}; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    check(engine.physics_path == "fused-cuda",
          f"physics path {engine.physics_path}")
    check(launches["fused_elastic_loss_grad"] == 3,
          "B3 not launched once per physics epoch")
    check(b3_routes == (3, 0),
          "B3 did not take the resident route on every physics epoch")
    check(launches["simulate_elastic_ring"] >= 1,
          "the ring forward did not make the observed data")
    check(ring_routes[0] >= 1 and ring_routes[1] == 0,
          "the engine's ring forward did not take the resident route")
    for rec in history:
        for k, v in rec.items():
            if isinstance(v, float):
                check(math.isfinite(v), f"epoch {rec['epoch']}: {k}={v}")
    check(all(r["loss_D_MSE"] == 0.0 for r in history[:cfg.lstart]),
          "a warmup epoch ran physics")
    phys_loss = [r["loss_D_MSE"] for r in history[cfg.lstart:]]
    check(len(set(phys_loss)) > 1, f"loss_D_MSE does not move: {phys_loss}")
    check(all(r["freq_stage"] == 4.0 for r in history),
          "not on the 4 Hz stage")
    # the engine's own data must fit at the true model, true density
    # included (all 35 shots)
    loss_true, grad = engine.physics_value_and_grad(
        engine.true_m, fc=0.0, rho=engine.wl.true["rho"])
    print(f"slice 2: misfit at the true model {float(loss_true):.3e} (tol "
          f"1e-9), gradient {tuple(grad.shape)}")
    check(float(loss_true) <= 1e-9, "engine misfit at the true model")
    check(tuple(grad.shape) == (cfg.nz, cfg.nx, 2)
          and bool(torch.isfinite(grad).all()), "engine gradient")
    return launches


ACC_SHOTS = 4  # shots of the float64 comparisons of phases 7 and 8
# the depth of the comparisons against float64 plain references in
# phases 4, 8 and 17 (of 3334, 4001 and 2568 steps; multiples of the
# kernels' checkpoint intervals): the plain sweeps are host-bound, ~5-8
# ms a time step whatever the shots, and these comparisons took ~250 s
# of the script at the full depth, ~83 s at a third; a quarter keeps the
# whole script under 1150 s on the slower machines.  The kernels'
# timings, the real misfit's comparisons and the trained paths keep the
# full depth.
ACC_NT_EL = 832
ACC_NT_AC = 1024
ACC_NT_SEAM = 640
PHYSICS_EPOCH_S = {}  # physics epoch seconds by workload, this run


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if len(xs) % 2 else 0.5 * (
        xs[len(xs) // 2 - 1] + xs[len(xs) // 2])


def phase_robust(dev):
    """The robust recipe at full width: ``train(get_workload(
    "marmousi_elastic_robust"), epochs=lstart + 10)`` on an engine built
    first: 3 of the 35 shots held out, 30 warmup epochs, then 10 physics
    epochs on the 2.5 Hz stage under the step cap, with the drift
    guard's anchor ``loss_H`` at epoch 30 and ``loss_H`` at epoch 40 (the
    resident ring forward on the 3 held-out shots).  Then, on the card,
    a revert to a snapshot, and ``evaluate`` of the run's ``latest``
    checkpoint."""
    import torch
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.engines import ElasticDIPEngine
    from physicsbasedfwi2_tpu_torch.engine.test import evaluate
    from physicsbasedfwi2_tpu_torch.engine.train import _snapshot, train
    from physicsbasedfwi2_tpu_torch.ops import elastic_fused
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import reset_launches
    out_dir = ROOT / "build" / "chip_smoke"
    cfg = get_workload("marmousi_elastic_robust", save_dir=str(out_dir))
    print(f"slice 5: marmousi_elastic_robust {cfg.nz}x{cfg.nx}, nt {cfg.nt}, "
          f"{cfg.num_shots} shots ({cfg.holdout_shots} held out, "
          f"{cfg.shots_per_iter} per iteration), stages {cfg.freq_stages}, "
          f"step cap {cfg.step_cap} (final stage {cfg.step_cap_final}), "
          f"guard patience {cfg.guard_patience}, tol {cfg.guard_tol}, lr "
          f"ramp {cfg.guard_lr_ramp}, loss_H every {cfg.holdout_every}")
    torch.cuda.reset_peak_memory_stats(dev)
    b3 = elastic_fused.fused_elastic_loss_grad_meds
    ring = elastic_fused.simulate_elastic_ring
    reset_launches(b3, ring)
    t0 = time.perf_counter()
    engine = ElasticDIPEngine(cfg, device=dev)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    # Adam's step count and the step cap after each epoch
    steps, caps = {}, {}
    step_fn = engine.optimize_parameters

    def logged(epoch, **kw):
        out = step_fn(epoch, **kw)
        steps[epoch] = max(int(s["step"]) for s in engine.opt.state.values())
        if epoch > cfg.lstart:
            c = engine.last_step_cap
            caps[epoch] = (c["cap"], float(c["scale"]), float(c["move"]))
        return out

    engine.optimize_parameters = logged
    epochs = cfg.lstart + 10
    t0 = time.perf_counter()
    engine, history = train(cfg, epochs=epochs, quiet=True, engine=engine)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"fused_elastic_loss_grad": b3.launches,
                "simulate_elastic_ring": ring.launches}
    b3_routes = (b3.resident_launches, b3.per_step_launches)
    ring_routes = (ring.resident_launches, ring.per_step_launches)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    engine.optimize_parameters = step_fn
    for rec in history[:1] + history[cfg.lstart - 1:]:
        print("epoch", json.dumps(rec))
    warm = [r["epoch_time"] for r in history[:cfg.lstart]]
    phys = [r["epoch_time"] for r in history[cfg.lstart:]]
    print(f"slice 5: engine setup {setup:.2f} s; {epochs} epochs in "
          f"{total:.2f} s; warmup epochs: first {warm[0]:.4f} s, median of "
          f"the rest {_median(warm[1:]):.4f} s; physics epochs "
          f"{', '.join(f'{x:.4f}' for x in phys)} s (median "
          f"{_median(phys):.4f}); held-out shots "
          f"{engine._holdout_idx.tolist()}, pool of "
          f"{len(engine._train_pool)}; launches {launches}, (resident, "
          f"per-step) B3 {b3_routes}, ring forward {ring_routes}; physics "
          f"path {engine.physics_path}; peak memory {peak:.2f} GiB")
    for e, (cap, sc, mv) in sorted(caps.items()):
        print(f"slice 5 step cap, epoch {e}: cap {cap:g} m/s, uncapped move "
              f"{mv:.4f} m/s = {mv / cap:.3f} x cap, scale {sc:.4f}")
    check(engine.physics_path == "fused-cuda",
          f"physics path {engine.physics_path}")
    check(engine._holdout_idx.tolist() == [8, 17, 26]
          and len(engine._train_pool) == 32, "held-out shots")
    check(b3_routes == (10, 0) and launches["fused_elastic_loss_grad"] == 10,
          "B3 not launched once per physics epoch on the resident route")
    check(ring_routes == (3, 0) and launches["simulate_elastic_ring"] == 3,
          "the ring forward not launched at setup and for the 2 loss_H "
          "evaluations on the resident route")
    check(steps[cfg.lstart] == cfg.lstart and steps[cfg.lstart + 1] == 1
          and steps[epochs] == 10,
          f"not a fresh optimizer at epoch {cfg.lstart + 1}: {steps}")
    hs = [(r["epoch"], r["loss_H"]) for r in history if "loss_H" in r]
    check([e for e, _ in hs] == [cfg.lstart + 10]
          and all(math.isfinite(h) and h > 0 for _, h in hs),
          f"loss_H: {hs}")
    check(sorted(caps) == list(range(cfg.lstart + 1, epochs + 1))
          and all(math.isfinite(mv) and 0.0 < sc <= 1.0
                  for _, sc, mv in caps.values()), "step-cap scales")
    for rec in history:
        for k, v in rec.items():
            if isinstance(v, float):
                check(math.isfinite(v), f"epoch {rec['epoch']}: {k}={v}")
    check(all(r["freq_stage"] == 2.5 for r in history),
          "not on the 2.5 Hz stage")

    # loss_H alone: the 3-shot resident ring forward plus the misfit
    _, ms_h = timed_ms(lambda: engine.holdout_misfit(2.5))
    # the step cap's extra work a physics step: two decodes (no grad)
    with torch.no_grad():
        _, ms_dec = timed_ms(engine._decode)
    ref = PHYSICS_EPOCH_S.get("marmousi_elastic")
    print(f"slice 5: loss_H evaluation {ms_h:.2f} ms; a decode {ms_dec:.2f} "
          f"ms (the cap runs two a step); physics epoch median "
          f"{_median(phys):.4f} s against marmousi_elastic's "
          + (f"{_median(ref):.4f} s (phase 6, this run)" if ref else
             "(phase 6 not run)"))

    # the drift guard's revert on the card: bit for bit, a fresh
    # optimizer, and the next epoch at lr / guard_lr_ramp
    ref_v = engine.test()[0]["loss_V_MSE"]
    snap = _snapshot(engine)
    engine.optimize_parameters(epochs + 1, freq=2.5)
    moved = any(not torch.equal(v, snap[k])
                for k, v in engine.net.state_dict().items())
    engine.guard_revert(snap, epochs + 2)
    same = all(torch.equal(v, snap[k])
               for k, v in engine.net.state_dict().items())
    empty = len(engine.opt.state) == 0
    engine.optimize_parameters(epochs + 2, freq=2.5)
    lr = engine.opt.param_groups[0]["lr"]
    want = engine.lr_policy.lr_for_epoch(epochs + 2) / cfg.guard_lr_ramp
    if cfg.phase_lr_ramp > 0:
        want *= min(1.0, (epochs + 2 - cfg.lstart) / cfg.phase_lr_ramp)
    print(f"slice 5 guard_revert: parameters moved by an epoch {moved}, "
          f"restored torch.equal {same}, optimizer state empty {empty}; next "
          f"epoch's lr {lr:.6g} (lr / guard_lr_ramp {want:.6g})")
    check(moved and same and empty, "guard_revert did not restore the "
          "snapshot with a fresh optimizer")
    check(abs(lr - want) <= 1e-12, "the post-revert lr ramp")

    # fwi-test's evaluate of the run's latest checkpoint
    res = evaluate(cfg, epoch="latest", results_dir=str(out_dir / "results"),
                   device=dev)
    model = out_dir / "results" / cfg.name / "epoch_latest" / "model.npy"
    print(f"slice 5 evaluate(latest): {res} (the trained engine's "
          f"{ref_v:.9g}), {model.relative_to(ROOT)}")
    check(model.exists() and math.isfinite(res["loss_V_MSE"])
          and abs(res["loss_V_MSE"] - ref_v) <= 1e-5 * ref_v,
          "evaluate of the latest checkpoint")
    return launches


def phase_lbfgs(dev):
    """Slice 6 at full width: ``marmousi_elastic_lbfgs``'s engine (full-
    batch L-BFGS, the ``tnl2`` misfit on the "fast" path) and its misfit
    at the true model (its first physics epoch runs in phase 25, as
    ``adam_vs_lbfgs``'s L-BFGS arm), ``marmousi_acoustic`` with L-BFGS
    for 2 epochs, and one split-PML ``elastic_gradient`` on 5 shots."""
    import torch
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.engines import (
        AcousticDIPEngine, ElasticDIPEngine)
    from physicsbasedfwi2_tpu_torch.engine.train import train
    from physicsbasedfwi2_tpu_torch.ops import (
        elastic_fused, elastic_gradient, fwi_fused, scalar2,
        simulate_elastic, trace_normalize)
    out_dir = ROOT / "build" / "chip_smoke"
    cfg = get_workload("marmousi_elastic_lbfgs", save_dir=str(out_dir))
    print(f"slice 6: marmousi_elastic_lbfgs {cfg.nz}x{cfg.nx}, nt {cfg.nt}, "
          f"{cfg.num_shots} shots a closure, misfit {cfg.misfit}, optimizer "
          f"{cfg.optimizer} (memory {cfg.extras.get('lbfgs_memory', 10)}, "
          f"line search {cfg.extras.get('lbfgs_linesearch', 20)}), chunk "
          f"{cfg.chunk}, lstart {cfg.lstart}")
    b3 = elastic_fused.fused_elastic_loss_grad_meds
    ring = elastic_fused.simulate_elastic_ring
    scalar2.reset_launches(b3, ring)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    engine = ElasticDIPEngine(cfg, device=dev)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    print(f"slice 6: physics_path == \"fast\": "
          f"{engine.physics_path == 'fast'} ({engine.physics_path}); engine "
          f"setup {setup:.2f} s (the split-PML 35-shot obs of the workload "
          f"build, then the sponge operator's)")
    check(engine.physics_path == "fast", f"physics path {engine.physics_path}")

    # the misfit at the true model (true density) on all 35 shots, a
    # forward: zero, the obs coming from the same operator
    wl = engine.wl
    m_true = torch.stack([wl.true["vp"], wl.true["vs"]], -1)
    t0 = time.perf_counter()
    with torch.no_grad():
        loss_true = float(engine._physics_loss_raw(
            m_true, engine._train_pool, engine._stage_pack(0.0),
            rho=wl.true["rho"]))
    fwd_s = time.perf_counter() - t0
    print(f"slice 6: tnl2 misfit at the true model {loss_true:.3e} (tol "
          f"1e-9), a 35-shot forward and misfit {fwd_s:.3f} s")
    check(loss_true <= 1e-9, "tnl2 misfit at the true model")

    # the first physics epoch of this engine at full width (the line
    # search's value-and-gradient evaluations, each timed; every accepted
    # step's decrease) runs in phase 25, as adam_vs_lbfgs's L-BFGS arm
    check(b3.launches == 0 and ring.launches == 0,
          "a fused elastic kernel ran on the fast path")

    # marmousi_acoustic with L-BFGS: B2 once a value-and-gradient
    acfg = get_workload("marmousi_acoustic", optimizer="lbfgs",
                        save_dir=str(out_dir))
    b2 = fwi_fused.fwi_l1_loss_grad
    scalar2.reset_launches(scalar2.forward2, b2)
    aevals = []
    t0 = time.perf_counter()
    aengine = AcousticDIPEngine(acfg, device=dev)
    astep = aengine.optimize_parameters

    def alogged(epoch, **kw):
        out = astep(epoch, **kw)
        aevals.append(aengine.opt.evaluations)
        return out

    aengine.optimize_parameters = alogged
    aengine, ahist = train(acfg, epochs=2, quiet=True, engine=aengine)
    torch.cuda.synchronize()
    atotal = time.perf_counter() - t0
    launches = {"forward2": scalar2.forward2.launches,
                "fwi_l1_loss_grad": b2.launches}
    for rec in ahist:
        print("epoch", json.dumps(rec))
    secs = ", ".join(f"{r['epoch_time']:.4f}" for r in ahist)
    print(f"slice 6: marmousi_acoustic L-BFGS, 2 epochs in {atotal:.2f} s "
          f"(setup included), epochs {secs} s, "
          f"evaluations {aevals}; B2 launches {b2.launches} (resident "
          f"{b2.resident_launches}, per-step {b2.per_step_launches}), B1 "
          f"{scalar2.forward2.launches}")
    check(aengine.physics_path == "fused-cuda",
          f"acoustic L-BFGS path {aengine.physics_path}")
    check(b2.launches == sum(aevals) == b2.resident_launches,
          "B2 not launched once a value-and-gradient evaluation, resident")
    for rec in ahist:
        check(all(math.isfinite(v) for v in rec.values()
                  if isinstance(v, float)), f"acoustic L-BFGS {rec}")

    # one split-PML elastic_gradient ("xla" backend) on 5 shots
    geom = tuple(a[:5] for a in wl.geom)
    with torch.no_grad():
        obs = simulate_elastic(wl.true["vp"], wl.true["vs"], wl.true["rho"],
                               wl.wavelet, *geom, wl.cfg)
    ovx, ovz = trace_normalize(obs[0]), trace_normalize(obs[1])

    def tnl2(pred):
        return (torch.mean((trace_normalize(pred[0]) - ovx) ** 2)
                + torch.mean((trace_normalize(pred[1]) - ovz) ** 2))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    loss, grads = elastic_gradient(wl.start["vp"], wl.start["vs"],
                                   wl.start["rho"], tnl2, wl.wavelet, *geom,
                                   wl.cfg)
    torch.cuda.synchronize()
    eg_s = time.perf_counter() - t0
    eg_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"slice 6: elastic_gradient (split PML), 5 shots, "
          f"{wl.cfg.grid.nz}x{wl.cfg.grid.nx}, nt {wl.cfg.grid.nt}: "
          f"{eg_s:.3f} s, peak memory {eg_peak:.2f} GiB, loss "
          f"{float(loss):.6g}, |grad| max "
          f"{ {k: float(v.abs().max()) for k, v in grads.items()} }")
    check(set(grads) == {"vp", "vs", "rho"}
          and all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
                  for g in grads.values()) and float(loss) > 0,
          "elastic_gradient")
    return launches


def _grad_accuracy(name, shape, gk, gp, ms_k, ms_p, grads4,
                   at: str = f"{ACC_SHOTS} shots"):
    """Print and check a kernel gradient at the path's shape against the
    plain float32 version (1e-4 rel L2: float32 rounding in another
    order) and, at ACC_SHOTS shots (``at``: and a cut depth), against
    the plain version in float64: the kernel's relative L2 error at most
    2x the plain float32 version's own.  ``grads4``: the kernel's, the
    plain float32 and the plain float64 gradients there."""
    import torch
    k4, p4, r4 = grads4
    rel = _rel_l2(gk, gp)
    err_k, err_p = _rel_l2(k4.double(), r4), _rel_l2(p4.double(), r4)
    print(f"{name} gradient {shape}: rel L2 vs plain {rel:.2e} (tol 1e-4); "
          f"kernel {ms_k:.2f} ms, plain {ms_p:.2f} ms; against the plain "
          f"version in float64 at {at} (float64 sweeps over 18 "
          f"shots would add ~30 s): kernel {err_k:.2e}, plain float32 "
          f"{err_p:.2e} (tol 2x plain)")
    check(bool(torch.isfinite(gk).all()), f"{name} gradient not finite")
    check(rel <= 1e-4, f"{name} gradient disagrees with its plain version")
    check(err_k <= 2.0 * err_p,
          f"{name} gradient is less accurate than its plain version")
    return float((gk - gp).abs().max())


def _plain_ms(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_b4(dev):
    """B4a against B1 and its plain version (traces and checkpoints); B4b
    and the gradient of mean((pred - obs)^2) through acoustic_pallas2,
    obs from the true model, at the smooth starting model."""
    import torch
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import (
        acoustic_pallas2, backward2, backward2_plain, forward2, forward2_ckpt,
        forward2_ckpt_plain, scatter_rows)
    cfg, wav, geom, vp, vp0 = flagship_case(dev)
    g = cfg.grid
    shape = f"[18 shots, nt {g.nt}]"
    nt_pad = -(-g.nt // 32) * 32
    turns_a = route_turns("B4a forward2_ckpt", lambda r: forward2_ckpt(
        vp0, wav, *geom, cfg, route=r), nt_pad)
    (recs, ckpt), ms_k = turns_a["out"], turns_a["ms"]
    same_b1 = float((recs - forward2(vp0, wav, *geom, cfg)).abs().max())
    (recs_p, ckpt_p), ms_p = _plain_ms(
        lambda: forward2_ckpt_plain(vp0, wav, *geom, cfg))
    scale = float(recs_p.abs().max())
    err = float((recs - recs_p).abs().max())
    err_ck = float((ckpt - ckpt_p).abs().max()) / float(ckpt_p.abs().max())
    print(f"B4a forward2_ckpt {shape}, ckpt {tuple(ckpt.shape)}: vs B1 "
          f"max|diff| {same_b1:.3e} (the same step kernel: 0); vs plain "
          f"max|err| {err:.3e} of max {scale:.3e}, checkpoints {err_ck:.3e} "
          f"of max (tol 1e-5 of max); kernel {ms_k:.2f} ms, plain "
          f"{ms_p:.2f} ms")
    check(same_b1 == 0.0, "B4a traces differ from B1's")
    check(bool(torch.isfinite(recs).all() and torch.isfinite(ckpt).all()),
          "B4a output not finite")
    check(err <= 1e-5 * scale and err_ck <= 1e-5,
          "B4a disagrees with its plain version")
    b4a = {"max_abs_err": err, "ms": ms_k, "plain_ms": ms_p,
           "per_step_ms": turns_a["per_step_ms"]}

    obs = forward2(vp, wav, *geom, cfg)
    v = vp0.clone().requires_grad_(True)
    torch.mean((acoustic_pallas2(v, wav, *geom, cfg) - obs) ** 2).backward()
    gk_auto = v.grad

    def rows_of(pred):
        ybar = 2.0 * (pred - obs[:len(pred)].to(pred.dtype)) / pred.numel()
        return scatter_rows(ybar, geom[3][:len(pred)], nt=g.nt, nx=g.nx,
                            pml_width=g.pml_width)

    def grad4(fwd, bwd, **kw):
        g4 = tuple(a[:ACC_SHOTS] for a in geom)
        recs4, ck4 = fwd(vp0, wav, *g4, cfg, **kw)
        return bwd(vp0, wav, *g4, cfg, rows_of(recs4), ck4, **kw)

    rows_k = rows_of(recs)
    turns_b = route_turns("B4b backward2", lambda r: backward2(
        vp0, wav, *geom, cfg, rows_k, ckpt, route=r), 2 * nt_pad)
    gk, ms_bk = turns_b["out"], turns_b["ms"]
    # the same kernel on cotangents that differ in the last bit
    check(_rel_l2(gk_auto, gk) <= 1e-5,
          "acoustic_pallas2's gradient is not B4b's")
    gp, ms_bp = _plain_ms(lambda: backward2_plain(
        vp0, wav, *geom, cfg, rows_of(recs_p), ckpt_p))
    grads4 = (grad4(forward2_ckpt, backward2),
              grad4(forward2_ckpt_plain, backward2_plain),
              grad4(forward2_ckpt_plain, backward2_plain,
                    dtype=torch.float64))
    err_b = _grad_accuracy("B4b backward2 (acoustic_pallas2)", shape, gk, gp,
                           ms_bk, ms_bp, grads4)
    ns = len(geom[0])
    cells = ns * (g.nz + g.top_pad + g.pml_width) * (g.nx + 2 * g.pml_width)
    planes = 3 * 192 * 256 * 4
    io_a = planes + nbytes(wav, *geom[:3], recs, ckpt)
    io_b = planes + nbytes(wav, *geom[:3], rows_k, ckpt, gk)
    b4a.update(bound(FLOPS_B1 * cells * g.nt, io_a), library_ms=None)
    b4b = {"max_abs_err": err_b, "ms": ms_bk, "plain_ms": ms_bp,
           "per_step_ms": turns_b["per_step_ms"],
           **bound(FLOPS_B2_ADJ * cells * g.nt, io_b), "library_ms": None}
    return b4a, b4b


def phase_b56(dev):
    """B5 against its plain version and simulate_acoustic; B6 and the
    gradient of mean((pred - obs)^2) through acoustic_pallas, obs from
    the true model, at the smooth starting model; each kernel's two
    routes in turns, bit-equal (B6's checkpoints too), B6's peak memory
    and a device trace of one B6 call on each route."""
    import dataclasses

    import torch
    from physicsbasedfwi2_tpu_torch.ops import simulate_acoustic
    from physicsbasedfwi2_tpu_torch.ops.adjoint import (
        K_CKPT, _checkpoints_cuda, acoustic_pallas, acoustic_pallas_backward,
        acoustic_pallas_backward_plain)
    from physicsbasedfwi2_tpu_torch.ops.kernels import (
        acoustic_forward_pallas, acoustic_forward_pallas_plain, operands)
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import scatter_rows
    cfg, wav, geom, vp, vp0 = flagship_case(dev)
    g = cfg.grid
    shape = f"[18 shots, nt {g.nt}]"
    nt_pad = -(-g.nt // K_CKPT) * K_CKPT
    ac_cluster_report(len(geom[0]))
    turns5 = route_turns("B5 acoustic_forward_pallas",
                         lambda r: acoustic_forward_pallas(
                             vp0, wav, *geom, cfg, route=r), g.nt,
                         exact=True)
    recs, ms_k = turns5["out"], turns5["ms"]
    recs_p, ms_p = _plain_ms(lambda: acoustic_forward_pallas_plain(
        vp0, wav, *geom, cfg))
    scale = float(recs_p.abs().max())
    err = float((recs - recs_p).abs().max())
    with torch.no_grad():
        sim = simulate_acoustic(vp0, wav, *geom, cfg)
    err_sim = float((recs - sim).abs().max()) / float(sim.abs().max())
    print(f"B5 acoustic_forward_pallas {shape}: max|err| {err:.3e} of max "
          f"{scale:.3e} (tol 1e-5 of max); vs simulate_acoustic {err_sim:.3e} "
          f"of max (tol 5e-3: no ring, 1/dx associated differently); kernel "
          f"{ms_k:.2f} ms, plain {ms_p:.2f} ms")
    check(bool(torch.isfinite(recs).all()), "B5 traces not finite")
    check(err <= 1e-5 * scale, "B5 disagrees with its plain version")
    check(err_sim <= 5e-3, "B5 disagrees with simulate_acoustic")
    b5 = {"max_abs_err": err, "ms": ms_k, "plain_ms": ms_p,
          "per_step_ms": turns5["per_step_ms"]}

    # B6's forward sweep on each route: the same checkpoints
    kap, damp, _, amp, sz, sx, rrow = operands(
        vp0, wav, *geom[:3], cfg, nt_pad=nt_pad, gain="b6")
    cks = [_checkpoints_cuda(kap, damp, amp, sz, sx, rrow, g.dt / g.dx, r)
           for r in ("resident", "per_step")]
    same_ck = torch.equal(*cks)
    print(f"B6 checkpoints {tuple(cks[0].shape)}: resident and per-step "
          f"routes bit-equal: {same_ck}")
    check(same_ck and bool(torch.isfinite(cks[0]).all()),
          "B6's checkpoints differ between the routes")
    del cks

    obs = acoustic_forward_pallas(vp, wav, *geom, cfg)
    v = vp0.clone().requires_grad_(True)
    torch.mean((acoustic_pallas(v, wav, *geom, cfg) - obs) ** 2).backward()
    gk_auto = v.grad

    def rows_of(pred):
        ybar = 2.0 * (pred - obs[:len(pred)].to(pred.dtype)) / pred.numel()
        return scatter_rows(ybar, geom[3][:len(pred)], nt=g.nt, nx=g.nx,
                            pml_width=g.pml_width, KC=K_CKPT)

    # the float64 comparison at ACC_SHOTS shots and ACC_NT_AC steps, its
    # obs from B5 at that depth
    cfg4 = dataclasses.replace(cfg, grid=dataclasses.replace(g, nt=ACC_NT_AC))
    wav4 = wav[:ACC_NT_AC].contiguous()
    g4 = tuple(a[:ACC_SHOTS] for a in geom)
    obs4 = acoustic_forward_pallas(vp, wav4, *g4, cfg4)

    def grad4(fwd, bwd, **kw):
        pred = fwd(vp0, wav4, *g4, cfg4, **kw)
        ybar = 2.0 * (pred - obs4.to(pred.dtype)) / pred.numel()
        rows4 = scatter_rows(ybar, g4[3], nt=ACC_NT_AC, nx=g.nx,
                             pml_width=g.pml_width, KC=K_CKPT)
        return bwd(vp0, wav4, *g4, cfg4, rows4, **kw)

    rows_k = rows_of(recs)

    def b6(route=None):
        return acoustic_pallas_backward(vp0, wav, *geom, cfg, rows_k,
                                        route=route)

    turns6 = route_turns("B6 acoustic_pallas_backward", b6, 3 * nt_pad,
                         exact=True)
    gk, ms_bk = turns6["out"], turns6["ms"]
    for route in ("resident", "per_step"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        b6(route)
        torch.cuda.synchronize()
        print(f"B6 ({route} route): peak memory "
              f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB "
              f"above its inputs")
        phase_trace(f"B6 ({route} route)", lambda: b6(route))
    check(_rel_l2(gk_auto, gk) <= 1e-5,
          "acoustic_pallas's gradient is not B6's")
    gp, ms_bp = _plain_ms(lambda: acoustic_pallas_backward_plain(
        vp0, wav, *geom, cfg, rows_of(recs_p)))
    grads4 = (grad4(acoustic_forward_pallas, acoustic_pallas_backward),
              grad4(acoustic_forward_pallas_plain,
                    acoustic_pallas_backward_plain),
              grad4(acoustic_forward_pallas_plain,
                    acoustic_pallas_backward_plain, dtype=torch.float64))
    err_b = _grad_accuracy("B6 acoustic_pallas_backward (acoustic_pallas)",
                           shape, gk, gp, ms_bk, ms_bp, grads4,
                           at=f"{ACC_SHOTS} shots, nt {ACC_NT_AC}")
    ns = len(geom[0])
    cells = ns * (g.nz + g.top_pad + g.pml_width) * (g.nx + 2 * g.pml_width)
    planes = 5 * 192 * 256 * 4
    io5 = planes + nbytes(wav, *geom, recs)
    io6 = planes + nbytes(wav, *geom, rows_k, gk)
    b5.update(bound(FLOPS_B5 * cells * g.nt, io5), library_ms=None)
    b6 = {"max_abs_err": err_b, "ms": ms_bk, "plain_ms": ms_bp,
          "per_step_ms": turns6["per_step_ms"],
          **bound((FLOPS_B5 + FLOPS_B6_ADJ) * cells * g.nt, io6),
          "library_ms": None}
    return b5, b6


def phase_slice3(dev):
    """The differentiable propagators' path at full width: 3 model-pixel
    FWI iterations of the trace-normalized L1 loss (direct wave
    subtracted) through acoustic_pallas and through acoustic_pallas2."""
    import torch
    from physicsbasedfwi2_tpu_torch.data.synthetic import (
        SyntheticAcousticWorkload)
    from physicsbasedfwi2_tpu_torch.ops import (
        adjoint, kernels, normalized_trace_misfit, scalar2, select_acoustic,
        trace_normalize)
    counters = {"forward2_ckpt": scalar2.forward2_ckpt,
                "backward2": scalar2.backward2,
                "acoustic_forward_pallas": kernels.acoustic_forward_pallas,
                "acoustic_pallas_backward": adjoint.acoustic_pallas_backward}
    scalar2.reset_launches(*counters.values())
    t0 = time.perf_counter()
    wl = SyntheticAcousticWorkload.build(backend="pallas", device=dev)
    torch.cuda.synchronize()
    print(f"slice 3: workload (backend pallas: B5) {wl.obs.shape[0]} shots, "
          f"nt {wl.grid.nt}, built in {time.perf_counter() - t0:.2f} s")
    geom, cfg, wav = wl.geom, wl.cfg, wl.wavelet
    const = torch.full_like(wl.vp_true, 1500.0)
    auto = select_acoustic("auto")
    check(auto is adjoint.acoustic_pallas,
          f"select_acoustic('auto') on the card is {auto.__name__}")
    for name, prop, obs in (
            ("acoustic_pallas", auto, wl.obs),
            ("acoustic_pallas2", scalar2.acoustic_pallas2,
             scalar2.acoustic_pallas2(wl.vp_true, wav, *geom, cfg))):
        direct = prop(const, wav, *geom, cfg)
        obs_norm = trace_normalize(obs - direct)

        def loss_of(v):
            return normalized_trace_misfit(prop(v, wav, *geom, cfg),
                                           obs_norm, direct, kind="l1")

        with torch.no_grad():
            l_true = float(loss_of(wl.vp_true))
        vp = wl.vp_start.clone()
        torch.cuda.reset_peak_memory_stats(dev)
        losses, secs = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v = vp.clone().requires_grad_(True)
            loss = loss_of(v)
            loss.backward()
            grad = v.grad
            vp = vp - 20.0 * grad / (grad.abs().max() + 1e-20)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(loss.detach()))
            check(bool(torch.isfinite(grad).all()) and bool(grad.abs().max() > 0),
                  f"{name}: gradient not finite or zero")
        print(f"slice 3 {name}: loss at the true model {l_true:.3e} (tol "
              f"1e-6); losses {', '.join(f'{x:.6g}' for x in losses)}; "
              f"seconds per iteration {', '.join(f'{x:.4f}' for x in secs)}; "
              f"peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        check(l_true <= 1e-6, f"{name}: loss at the true model")
        check(all(math.isfinite(x) for x in losses), f"{name}: loss")
    launches = {k: fn.launches for k, fn in counters.items()}
    per_step = {k: fn.per_step_launches for k, fn in counters.items()}
    print(f"slice 3: launches {launches}, on the per-step route {per_step}")
    for k, n in launches.items():
        check(n >= 1, f"{k} was not launched on the slice's path")
        check(per_step[k] == 0, f"{k} left the resident route")
    return launches


# phase 10's time steps (of marmousi_acoustic's 4001): a depth cut that
# makes room for phase 25
XLA_NT = 1000


def phase_xla_engine(dev):
    """The acoustic engine's non-fused ("xla") path at full width, the
    time loop cut to ``XLA_NT`` steps."""
    import torch
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.train import train
    cfg = get_workload("marmousi_acoustic", backend="xla", nt=XLA_NT,
                       save_dir=str(ROOT / "build" / "chip_smoke"))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    engine, history = train(cfg, epochs=1, quiet=True, device=dev)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    for rec in history:
        print("epoch", json.dumps(rec))
    epochs = ", ".join(f"{r['epoch_time']:.4f}" for r in history)
    print(f"xla path: {total:.2f} s in all (engine setup included), epochs "
          f"{epochs} s, physics "
          f"path {engine.physics_path}, peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    check(engine.physics_path == "xla", f"physics path {engine.physics_path}")
    for rec in history:
        for k, v in rec.items():
            if isinstance(v, float):
                check(math.isfinite(v), f"epoch {rec['epoch']}: {k}={v}")
    loss_true, grad = engine.physics_value_and_grad(engine.wl.vp_true)
    print(f"xla path: misfit at the true model {float(loss_true):.3e} (tol "
          f"1e-6), gradient {tuple(grad.shape)}")
    check(float(loss_true) <= 1e-6, "xla engine misfit at the true model")
    check(tuple(grad.shape) == (cfg.nz, cfg.nx)
          and bool(torch.isfinite(grad).all()), "xla engine gradient")


def _rel_max(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _b7b_and_b4b_pair_sum(vp, wav, geom, cfg, rows, ckpt):
    """Resident B7b's dJ/dK [nz8, nx128] from B7a's checkpoints, and the
    pair-ordered sum (torch adds) of resident B4b's dJ/dK of each padded
    shot alone from the same checkpoints, put back into the shot layout:
    the same kernel, so the two must be equal."""
    import torch
    from physicsbasedfwi2_tpu_torch.ops import scalar2, scalar2b
    ops = scalar2b._common(vp, wav, *geom[:3], cfg, scalar2b.KC,
                           torch.float32)
    K, dp, dm, w, sz, sx, rr = ops
    ybar = torch.nn.functional.pad(
        rows, (0, 0, 0, 0, 0, w.shape[0] - rows.shape[0])).contiguous()
    gk7 = scalar2b._bwd_cuda(*ops, ybar, ckpt, route="resident")
    ck = scalar2b._from_pairs(ckpt)
    one = [slice(s, s + 1) for s in range(w.shape[0])]
    per = [scalar2._bwd_cuda(K, dp, dm, w[i], sz[i], sx[i], rr[i], ybar[i],
                             ck[i].contiguous(), w.shape[1],
                             route="resident") for i in one]
    return gk7, scalar2b._sum_pairs(torch.stack(per))


def phase_b7(dev):
    """B7a and B7b at the acoustic path's shapes: their resident and
    per-step routes in turns on the same inputs (1e-6 of max), each
    backward route from the other forward route's checkpoints, resident
    B7a against resident B4a at KC 16 and resident B7b against the
    pair-ordered sum of resident B4b's per-shot gradients on the same
    inputs (both torch.equal: the same kernels), both against their
    plain versions (the gradient of mean((pred - obs)^2), obs from the
    true model, at the smooth starting model; in float64 at 4 shots as
    phase 7), the plan's clusters resident, a device trace of one call
    on each route, and an odd shot count (5, padded to 6) on both
    routes."""
    import torch
    from physicsbasedfwi2_tpu_torch.ops import scalar2b
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import (
        _vp_grad, backward2, forward2, forward2_ckpt, scatter_rows)
    cfg, wav, geom, vp, vp0 = flagship_case(dev)
    g = cfg.grid
    ns = len(geom[0])
    shape = f"[{ns} shots, nt {g.nt}]"
    kc = scalar2b.KC
    nt_pad = -(-g.nt // kc) * kc
    cluster_report(ns, group=2)

    def fwd(route, gm=geom):
        return scalar2b.forward2b(vp0, wav, *gm, cfg, route=route)

    turns_a = route_turns("B7a forward2b", fwd, nt_pad)
    (recs, ckpt), ms_k = turns_a["out"], turns_a["ms"]
    ckpt_s = turns_a["per_step_out"][1]
    (recs4, ck16), ms_4a = timed_ms(lambda: forward2_ckpt(
        vp0, wav, *geom, cfg, KC=kc, route="resident"))
    same_a = (torch.equal(recs, recs4)
              and torch.equal(scalar2b._from_pairs(ckpt), ck16))
    (recs_p, ckpt_p), ms_p = _plain_ms(lambda: scalar2b.forward2b_plain(
        vp0, wav, *geom, cfg))
    scale = float(recs_p.abs().max())
    err = float((recs - recs_p).abs().max())
    err_ck = _rel_max(ckpt, ckpt_p)
    print(f"B7a forward2b {shape}, ckpt {tuple(ckpt.shape)}: resident "
          f"torch.equal to resident B4a at KC {kc} (traces and checkpoints) "
          f"{same_a}; vs plain max|err| {err:.3e} of max {scale:.3e}, "
          f"checkpoints {err_ck:.3e} of max (tol 1e-5 of max); resident "
          f"{ms_k:.2f} ms, per-step {turns_a['per_step_ms']:.2f} ms, resident "
          f"B4a at KC {kc} {ms_4a:.2f} ms, plain {ms_p:.2f} ms")
    check(bool(torch.isfinite(recs).all() and torch.isfinite(ckpt).all()),
          "B7a output not finite")
    check(same_a, "resident B7a is not resident B4a at KC 16")
    check(err <= 1e-5 * scale and err_ck <= 1e-5,
          "B7a disagrees with its plain version")
    b7a = {"max_abs_err": err, "ms": ms_k, "plain_ms": ms_p,
           "per_step_ms": turns_a["per_step_ms"]}

    obs = forward2(vp, wav, *geom, cfg)

    def rows_of(pred):
        ybar = 2.0 * (pred - obs[:len(pred)].to(pred.dtype)) / pred.numel()
        return scatter_rows(ybar, geom[3][:len(pred)], nt=g.nt, nx=g.nx,
                            pml_width=g.pml_width, KC=kc)

    def grad_n(fwd_fn, bwd_fn, n, **kw):
        gn = tuple(a[:n].contiguous() for a in geom)
        recs_n, ck_n = fwd_fn(vp0, wav, *gn, cfg, **kw)
        return bwd_fn(vp0, wav, *gn, cfg, rows_of(recs_n), ck_n, **kw)

    rows_k = rows_of(recs)
    turns_b = route_turns("B7b backward2b", lambda r: scalar2b.backward2b(
        vp0, wav, *geom, cfg, rows_k, ckpt, route=r), 2 * nt_pad)
    gk, ms_bk = turns_b["out"], turns_b["ms"]
    cross = {route: _rel_max(scalar2b.backward2b(
        vp0, wav, *geom, cfg, rows_k, ck, route=route), gk)
        for route, ck in (("resident", ckpt_s), ("per_step", ckpt))}
    gk7, gk4 = _b7b_and_b4b_pair_sum(vp0, wav, geom, cfg, rows_k, ckpt)
    same_b = torch.equal(gk7, gk4) and torch.equal(
        gk, _vp_grad(gk7, vp0, cfg, (g.dt / g.dx) ** 2))
    _, ms_4b = timed_ms(lambda: backward2(vp0, wav, *geom, cfg, rows_k, ck16,
                                          route="resident"))
    print(f"B7b backward2b {shape}: resident dJ/dK torch.equal to the "
          f"pair-ordered sum of resident B4b's per-shot dJ/dK {same_b}; "
          f"from the other forward route's checkpoints, resident "
          f"{cross['resident']:.2e} and per-step {cross['per_step']:.2e} of "
          f"max from resident (tol 1e-6); resident {ms_bk:.2f} ms, per-step "
          f"{turns_b['per_step_ms']:.2f} ms, resident B4b at KC {kc} "
          f"{ms_4b:.2f} ms")
    check(same_b, "resident B7b is not the pair sum of resident B4b")
    check(max(cross.values()) <= 1e-6,
          "B7b disagrees across the routes' checkpoints")
    gp, ms_bp = _plain_ms(lambda: scalar2b.backward2b_plain(
        vp0, wav, *geom, cfg, rows_of(recs_p), ckpt_p))
    grads4 = (grad_n(scalar2b.forward2b, scalar2b.backward2b, ACC_SHOTS),
              grad_n(scalar2b.forward2b_plain, scalar2b.backward2b_plain,
                     ACC_SHOTS),
              grad_n(scalar2b.forward2b_plain, scalar2b.backward2b_plain,
                     ACC_SHOTS, dtype=torch.float64))
    err_b = _grad_accuracy("B7b backward2b (acoustic_pallas2b)", shape, gk,
                           gp, ms_bk, ms_bp, grads4)

    # one call of each route in a device trace: resident B7a is one
    # fwd_resident launch, resident B7b one rev_resident and one
    # sum_pairs
    n = {}
    for route in ("resident", "per_step"):
        n["B7a", route] = phase_trace(f"B7a ({route} route)",
                                      lambda: fwd(route))
        n["B7b", route] = phase_trace(
            f"B7b ({route} route)", lambda: scalar2b.backward2b(
                vp0, wav, *geom, cfg, rows_k, ckpt, route=route))
    res_a, res_b = n["B7a", "resident"], n["B7b", "resident"]
    print(f"B7 resident, kernel launches of one call in its device trace: "
          f"B7a fwd_resident {res_a['fwd_resident']} of "
          f"{sum(res_a.values())}; B7b rev_resident {res_b['rev_resident']}, "
          f"sum_pairs {res_b['sum_pairs']} of {sum(res_b.values())}")
    check(res_a["fwd_resident"] == 1,
          "resident B7a is not one fwd_resident launch")
    check(res_b["rev_resident"] == 1 and res_b["sum_pairs"] == 1,
          "resident B7b is not one rev_resident and one sum_pairs launch")

    # an odd shot count: the last shot is repeated to make the pairs
    g5 = tuple(a[:5].contiguous() for a in geom)
    out5 = {r: fwd(r, g5) for r in ("resident", "per_step")}
    r5, c5 = out5["resident"]
    r5p, _ = scalar2b.forward2b_plain(vp0, wav, *g5, cfg)
    r45, c45 = forward2_ckpt(vp0, wav, *g5, cfg, KC=kc, route="resident")
    rows5 = rows_of(r5)
    gk75, gk45 = _b7b_and_b4b_pair_sum(vp0, wav, g5, cfg, rows5, c5)
    same5 = (torch.equal(r5, r45)
             and torch.equal(scalar2b._from_pairs(c5)[:5], c45)
             and torch.equal(gk75, gk45))
    gk5 = {r: grad_n(scalar2b.forward2b, scalar2b.backward2b, 5, route=r)
           for r in ("resident", "per_step")}
    gp5 = grad_n(scalar2b.forward2b_plain, scalar2b.backward2b_plain, 5)
    e5r = max(_rel_max(r5, out5["per_step"][0]),
              _rel_max(c5, out5["per_step"][1]),
              _rel_max(gk5["per_step"], gk5["resident"]))
    e5, e5g = _rel_max(r5, r5p), _rel_l2(gk5["resident"], gp5)
    print(f"B7 at 5 shots (padded to 6): ckpt {tuple(c5.shape)}; resident "
          f"torch.equal to resident B4a / the pair sum of resident B4b "
          f"{same5}; routes {e5r:.2e} of max apart (tol 1e-6); resident "
          f"traces {e5:.2e} of max from plain (tol 1e-5), gradient rel L2 "
          f"{e5g:.2e} (tol 1e-4)")
    check(tuple(c5.shape[:1]) == (3,) and same5 and e5r <= 1e-6
          and e5 <= 1e-5 and e5g <= 1e-4,
          "B7 at an odd shot count disagrees")

    cells = ns * (g.nz + g.top_pad + g.pml_width) * (g.nx + 2 * g.pml_width)
    planes = 3 * 192 * 256 * 4
    io_a = planes + nbytes(wav, *geom[:3], recs, ckpt)
    io_b = planes + nbytes(wav, *geom[:3], rows_k, ckpt, gk)
    b7a.update(bound(FLOPS_B1 * cells * g.nt, io_a), library_ms=None)
    b7b = {"max_abs_err": err_b, "ms": ms_bk, "plain_ms": ms_bp,
           "per_step_ms": turns_b["per_step_ms"],
           **bound(FLOPS_B2_ADJ * cells * g.nt, io_b), "library_ms": None}
    return b7a, b7b


def phase_slice4_pairs(dev):
    """The shot-pair propagator's path at full width: model-pixel FWI
    iterations of the trace-normalized L1 loss (direct wave subtracted)
    through acoustic_pallas2b, 3 at 18 shots and 1 at 17, every B7
    launch on the resident route."""
    import torch
    from physicsbasedfwi2_tpu_torch.ops import (
        normalized_trace_misfit, scalar2, scalar2b, trace_normalize)
    cfg, wav, geom, vp_true, vp0 = flagship_case(dev)
    prop = scalar2b.acoustic_pallas2b
    counters = {"forward2b": scalar2b.forward2b,
                "backward2b": scalar2b.backward2b}
    scalar2.reset_launches(*counters.values())
    torch.cuda.reset_peak_memory_stats(dev)
    const = torch.full_like(vp_true, 1500.0)
    for ns in (18, 17):
        gm = tuple(a[:ns].contiguous() for a in geom)
        with torch.no_grad():
            direct = prop(const, wav, *gm, cfg)
            obs_norm = trace_normalize(prop(vp_true, wav, *gm, cfg) - direct)

        def loss_of(v):
            return normalized_trace_misfit(prop(v, wav, *gm, cfg), obs_norm,
                                           direct, kind="l1")

        with torch.no_grad():
            l_true = float(loss_of(vp_true))
        vp = vp0.clone()
        losses, secs = [], []
        for _ in range(3 if ns == 18 else 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v = vp.clone().requires_grad_(True)
            loss = loss_of(v)
            loss.backward()
            grad = v.grad
            vp = vp - 20.0 * grad / (grad.abs().max() + 1e-20)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(loss.detach()))
            check(bool(torch.isfinite(grad).all()) and bool(grad.abs().max() > 0),
                  f"acoustic_pallas2b ({ns} shots): gradient not finite or zero")
        print(f"slice 4 acoustic_pallas2b, {ns} shots: loss at the true model "
              f"{l_true:.3e} (tol 1e-6); losses "
              f"{', '.join(f'{x:.6g}' for x in losses)}; seconds per iteration "
              f"{', '.join(f'{x:.4f}' for x in secs)}")
        check(l_true <= 1e-6, f"acoustic_pallas2b ({ns} shots): loss at the "
              f"true model")
        check(all(math.isfinite(x) for x in losses), "acoustic_pallas2b loss")
    launches = {k: fn.launches for k, fn in counters.items()}
    per_step = {k: fn.per_step_launches for k, fn in counters.items()}
    print(f"slice 4 pairs: launches {launches}, on the per-step route "
          f"{per_step}, peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    for k, n in launches.items():
        check(n >= 1, f"{k} was not launched on the slice's path")
        check(per_step[k] == 0, f"{k} left the resident route")
    return launches


def device_launches(fn, key: str) -> tuple[int, int]:
    """(launches of the kernels whose name holds ``key``, all kernel
    launches) of one call of fn() in a device trace (the records between
    the markers of :func:`device_records`; memory copies and sets not
    counted)."""
    names = [name for name, _, _ in device_records(fn)
             if "mem" not in name.lower()]
    return sum(key in name for name in names), len(names)


def phase_b8(dev):
    """B8 at marmousi_elastic's shape with an absorbing top, 35 shots: the
    path (one call, counts read around it), then its resident and
    per-step routes timed in turns and held to bit equality, its plan
    with the clusters resident, a device trace of one resident call, the
    resident route against the ring forward's (the same instance) and
    against the plain version, and each route's kernel launches in a
    device trace of one call."""
    import torch
    from physicsbasedfwi2_tpu_torch.ops.elastic_fused import (
        _layout, simulate_elastic_ring)
    from physicsbasedfwi2_tpu_torch.ops.elastic_fwd import (
        elastic_forward_pallas, elastic_forward_pallas_plain)
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import reset_launches
    cfg, wav, geom, true, _ = elastic_case(dev, free_surface=False)
    g = cfg.grid
    ns = len(geom[0])
    b8 = elastic_forward_pallas

    def run(route=None):
        return b8(*true, wav, *geom, cfg, route=route)

    reset_launches(b8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vx, vz = run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = b8.launches
    print(f"slice 4 elastic_forward_pallas [{ns} shots, nt {g.nt}, absorbing "
          f"top]: {launches} launch (resident {b8.resident_launches}), first "
          f"call {first_s:.3f} s")
    check(launches == 1 and b8.resident_launches == 1,
          "B8 was not launched once on its path's resident route")
    check(bool(torch.isfinite(vx).all() and torch.isfinite(vz).all()),
          "B8 traces not finite")
    fwd_cluster_report(ns, *_layout(cfg)[4:], "B8")
    turns = route_turns("B8", run, g.nt, exact=True)
    (kx, kz), ms_k = turns["out"], turns["ms"]
    phase_trace("B8 (resident route)", run)
    rx, rz = simulate_elastic_ring(*true, wav, *geom, cfg)
    (px, pz), ms_p = _plain_ms(lambda: elastic_forward_pallas_plain(
        *true, wav, *geom, cfg))
    scale = max(float(px.abs().max()), float(pz.abs().max()))
    same_ring = torch.equal(kx, rx) and torch.equal(kz, rz)
    err = max(float((kx - px).abs().max()), float((kz - pz).abs().max()))
    n_res = device_launches(run, "el_fwd_resident")
    n_step = device_launches(lambda: run("per_step"), "el_fwd_")
    print(f"B8 resident vs the ring forward's resident route on the same "
          f"inputs: bit-equal {same_ring}; vs plain max|err| {err:.3e} of "
          f"max {scale:.3e} (tol 1e-5 of max); kernel {ms_k:.2f} ms, plain "
          f"{ms_p:.2f} ms; device trace, kernel launches of one call (its "
          f"own of all): resident {n_res[0]} of {n_res[1]}, per-step "
          f"{n_step[0]} of {n_step[1]}")
    check(same_ring, "B8 and the ring forward's resident route differ")
    check(err <= 1e-5 * scale, "B8 disagrees with its plain version")
    check(n_res[0] == 1, "B8's resident route is not one kernel launch a "
          "call")
    # the per-step route launches 2 kernels a step
    check(n_step[0] == 2 * g.nt, "B8 per-step launch count")
    cells = ns * (g.nz + g.top_pad + g.pml_width) * (g.nx + 2 * g.pml_width)
    # five media and damp on the kernel's grid, the wavelet and geometry
    # in; the two traces out
    io = 6 * 144 * 384 * 4 + nbytes(wav, *geom, kx, kz)
    return launches, {"max_abs_err": err, "ms": ms_k, "plain_ms": ms_p,
                      "per_step_ms": turns["per_step_ms"],
                      **bound(FLOPS_B3 * cells * g.nt, io),
                      "library_ms": None}


def phase_b2_wavelet(dev):
    """B2's dJ/dwavelet (want_wavelet_grad) at phase 3's shape on the
    misfit whose residuals keep their signs, against the plain version
    in float32 and float64; B2 timed with and without it."""
    import torch
    from physicsbasedfwi2_tpu_torch.ops import trace_normalize
    from physicsbasedfwi2_tpu_torch.ops.fwi_fused import (
        fwi_l1_loss_grad, fwi_l1_loss_grad_plain, scatter_rows)
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import forward2
    cfg, wav, geom, vp, vp0 = flagship_case(dev)
    g = cfg.grid
    dir_rows = forward2(torch.full_like(vp, 1500.0), wav, *geom, cfg,
                        return_rows=True)
    cols = geom[3].long() + g.pml_width
    obs = forward2(vp, wav, *geom, cfg) - torch.gather(
        dir_rows, 2, cols[:, None, :].expand(-1, g.nt, -1))
    obs_rows = scatter_rows(trace_normalize(obs), geom[3], nt=g.nt, nx=g.nx,
                            pml_width=g.pml_width)
    dir_pad = torch.nn.functional.pad(
        dir_rows, (0, 0, 0, obs_rows.shape[1] - g.nt)).contiguous()
    off = (obs_rows + 3.0).contiguous()
    args = (vp0, wav, *geom, cfg, off, dir_pad)
    turns = route_turns("B2 with dJ/dwavelet", lambda r: fwi_l1_loss_grad(
        *args, want_wavelet_grad=True, route=r), 3 * off.shape[1])
    (_, _, wk), ms_on = turns["out"], turns["ms"]
    _, ms_off = timed_ms(lambda: fwi_l1_loss_grad(*args))
    _, _, wp = fwi_l1_loss_grad_plain(*args, want_wavelet_grad=True)
    _, _, wr = fwi_l1_loss_grad_plain(*args, want_wavelet_grad=True,
                                      dtype=torch.float64)
    err_k, err_p = _rel_l2(wk.double(), wr), _rel_l2(wp.double(), wr)
    err = float((wk - wp).abs().max())
    print(f"B2 dJ/dwavelet [18 shots, nt {g.nt}, residual signs fixed]: "
          f"{tuple(wk.shape)}, max|err| vs plain {err:.3e} of max "
          f"{float(wp.abs().max()):.3e}; against the plain version in "
          f"float64: kernel {err_k:.2e}, plain float32 {err_p:.2e} (tol "
          f"max(1e-5, 2x plain)); B2 with it {ms_on:.2f} ms, without "
          f"{ms_off:.2f} ms")
    check(tuple(wk.shape) == (len(geom[0]), g.nt)
          and bool(torch.isfinite(wk).all()), "B2 dJ/dwavelet shape")
    check(err_k <= max(1e-5, 2.0 * err_p),
          "B2 dJ/dwavelet is less accurate than its plain version")
    return err


def phase_engine_paths(dev):
    """The acoustic engine's continuation stages (marmousi_acoustic_real)
    and AutoWav (marmousi_acoustic_wav) at full width."""
    import torch
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.train import train
    from physicsbasedfwi2_tpu_torch.ops import fwi_fused, scalar2
    for name, kw, epochs in (
            ("marmousi_acoustic_real", dict(stage_max_epochs=2), 6),
            ("marmousi_acoustic_wav", {}, 3)):
        cfg = get_workload(name, save_dir=str(ROOT / "build" / "chip_smoke"),
                           **kw)
        scalar2.reset_launches(scalar2.forward2, fwi_fused.fwi_l1_loss_grad)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        engine, history = train(cfg, epochs=epochs, quiet=True, device=dev)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = {"forward2": scalar2.forward2.launches,
                    "fwi_l1_loss_grad": fwi_fused.fwi_l1_loss_grad.launches}
        for rec in history:
            print("epoch", json.dumps(rec))
        secs = ", ".join(f"{r['epoch_time']:.4f}" for r in history)
        print(f"{name}: {cfg.num_shots} shots, wavelet "
              f"{tuple(engine.wl.wavelet.shape)}, stages "
              f"{[r['freq_stage'] for r in history]}; {total:.2f} s in all "
              f"(engine setup included), epochs {secs} s; "
              f"launches {launches}, physics path {engine.physics_path}, peak "
              f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        check(engine.physics_path == "fused-cuda",
              f"{name}: physics path {engine.physics_path}")
        check(launches["fwi_l1_loss_grad"] == epochs,
              f"{name}: B2 not launched once per epoch")
        check(fwi_fused.fwi_l1_loss_grad.resident_launches == epochs,
              f"{name}: B2 did not take the resident route on every epoch")
        for rec in history:
            for k, v in rec.items():
                if isinstance(v, float):
                    check(math.isfinite(v), f"{name} epoch {rec['epoch']}: "
                          f"{k}={v}")
        if cfg.freq_stages:
            check(len({r["freq_stage"] for r in history}) >= 2,
                  f"{name} did not cross two continuation stages")
        if cfg.wavelet_from_data:
            check(tuple(engine.wl.wavelet.shape) == (cfg.num_shots, cfg.nt),
                  f"{name}: wavelet not per shot")


def _seam_kernels(dev):
    """B3 and the ring forward at seam_elastic's grid (120 x 324 at dx 30
    m, free surface, 144 x 384 in kernel layout, nt 2568; sources on row
    6, receivers on row 23): the ring forward of all 38 shots on its two
    routes in turns, held to bit equality, with its plan and the clusters
    resident; then B3 on 4 of the shots (every 10th), as a physics epoch
    draws them: its plan (16 bands of 9 rows, layout 1) with the clusters
    resident and each instance's ptxas line, its two routes timed in
    turns and held to bit equality, a device trace of one resident call,
    and on the resident route ``tnl1``
    with residual signs fixed (at ACC_NT_SEAM of the 2568 steps) against
    the plain version's own float32 error, the real misfit against the
    plain version's move under a 1e-7 change, and the loss at the true
    model, beside the bound."""
    import dataclasses

    import torch
    from physicsbasedfwi2_tpu_torch.ops import trace_normalize
    from physicsbasedfwi2_tpu_torch.ops.elastic_fused import (
        _layout, elastic_forward_plan, elastic_resident_plan,
        fused_elastic_loss_grad_meds, fused_elastic_loss_grad_meds_plain,
        prep_damp, prep_medium, scatter_rows_el, simulate_elastic_ring,
        simulate_elastic_ring_plain)
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import reset_launches
    cfg, wav, geom_all, true, start = elastic_case(dev,
                                                   workload="seam_elastic")
    g = cfg.grid
    nz8, nx128 = _layout(cfg)[4:]
    ns_all = len(geom_all[0])
    src_row, rcv_row = int(geom_all[0][0]), int(geom_all[2][0, 0])
    print(f"phase 17: seam_elastic's grid {g.nz} x {g.nx} at dx {g.dx:g} m, "
          f"free surface {g.free_surface}, kernel layout {nz8} x {nx128}, "
          f"nt {g.nt}, {ns_all} shots x {geom_all[3].shape[1]} receivers, "
          f"sources on row {src_row}, receivers on row {rcv_row}; B3 plan "
          f"{elastic_resident_plan(nz8, nx128)}, forward plan "
          f"{elastic_forward_plan(nz8, nx128)}")
    check((nz8, nx128) == (144, 384) and g.free_surface
          and (src_row, rcv_row) == (6, 23), "SEAM's grid and rows")
    plan = elastic_resident_plan(nz8, nx128)
    check(plan is not None and (plan.band_rows, plan.layout) == (9, 1),
          "B3's plan at SEAM's grid is not 9-row bands of layout 1")
    check(elastic_forward_plan(nz8, nx128).band_rows == 9,
          "the ring forward's plan at SEAM's grid is not 9-row bands")

    # the ring forward, all 38 shots, as the engine's setup runs it
    fwd_cluster_report(ns_all, nz8, nx128, "SEAM ring forward")
    ring_turns = route_turns(
        "SEAM ring forward", lambda r: simulate_elastic_ring(
            *true, wav, *geom_all, cfg, route=r), g.nt, exact=True)
    (ovx, ovz), ms_ring = ring_turns["out"], ring_turns["ms"]
    check(bool(torch.isfinite(ovx).all() and torch.isfinite(ovz).all()),
          "SEAM ring forward not finite")
    pick = torch.arange(0, ns_all, 10, device=dev)
    geom = tuple(a[pick].contiguous() for a in geom_all)
    ovx, ovz = ovx[pick], ovz[pick]
    with torch.no_grad():
        pvx, pvz = simulate_elastic_ring_plain(*true, wav, *geom, cfg)
    scale = max(float(pvx.abs().max()), float(pvz.abs().max()))
    err_r = max(float((ovx - pvx).abs().max()), float((ovz - pvz).abs().max()))
    ns, nr = geom[3].shape
    print(f"SEAM ring forward, shots {pick.tolist()} against the plain "
          f"version: max|err| {err_r:.3e} of max {scale:.3e} (tol 1e-4 of "
          f"max)")
    check(err_r <= 1e-4 * scale, "SEAM ring forward disagrees with its "
          "plain version")

    damp = prep_damp(cfg, dev)
    meds = prep_medium(*start, cfg)
    rows = tuple(scatter_rows_el(trace_normalize(o), geom[3], cfg, KC=8)
                 for o in (ovx, ovz))
    fn = fused_elastic_loss_grad_meds

    def kernel(obs, m=meds, route=None, wav=wav, cfg=cfg):
        return fn(m, damp, wav, *geom, cfg, *obs, KC=8, misfit="tnl1",
                  route=route)

    # B3's plan, its clusters resident, its instances; both routes in
    # turns on the real misfit, bit for bit (comparison launches)
    el_cluster_report(ns, nz8, nx128, what="SEAM B3")
    el_ptxas(9, 1)
    steps = 3 * rows[0].shape[1]  # forward, recompute, adjoint
    turns = route_turns("SEAM B3 tnl1", lambda r: kernel(rows, route=r),
                        steps, exact=True)
    n = phase_trace("SEAM B3 tnl1 (resident route)", lambda: kernel(rows))
    check(n["el_fwd_resident"] == 1 and n["el_rev_resident_l1"] == 1
          and n["el_band_media"] == 1,
          "resident SEAM B3 is not layout 1's one launch a sweep")
    reset_launches(fn)

    def plain(obs, dtype=torch.float32, wav=wav, cfg=cfg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fused_elastic_loss_grad_meds_plain(
            meds, damp, wav, *geom, cfg, *obs, KC=8, misfit="tnl1",
            dtype=dtype)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    shape = f"[{ns} shots x {nr} receivers, nt {g.nt}, resident route]"
    names = ("lam", "l2m", "muxz", "bx", "bz")

    def fields(got, ref):
        return ", ".join(f"{k} {_rel_l2(a.double(), b.double()):.2e}"
                         for k, a, b in zip(names, got, ref))

    def accuracy(what, obs, **cut):
        """The kernel against the plain version in float32 and float64
        on the observed rows ``obs`` (``cut``: a cut depth's wavelet and
        config): the kernel as accurate as the plain version (its
        gradients' relative L2 error against float64 at most max(1e-4,
        2x the plain float32's)), the loss to 1e-5."""
        lk, gk = kernel(obs, **cut)
        (lp, gp), ms_p = plain(obs, **cut)
        (lr, gr), _ = plain(obs, torch.float64, **cut)
        lk, lp, lr = float(lk), float(lp), float(lr)
        err_k, err_p = _rel_meds(gk, gr), _rel_meds(gp, gr)
        print(f"SEAM B3 tnl1, {what} {shape}: loss {lk:.9g} vs plain "
              f"{lp:.9g} (rel {abs(lk - lp) / abs(lp):.2e}, tol 1e-5), vs "
              f"float64 {lr:.9g}; gradient rel L2 vs plain float32: "
              f"{fields(gk, gp)}; against the plain version in float64: "
              f"kernel {err_k:.2e} ({fields(gk, gr)}), plain float32 "
              f"{err_p:.2e} ({fields(gp, gr)}) (tol max(1e-4, 2x plain))")
        check(math.isfinite(lk) and all(bool(torch.isfinite(a).all())
                                        for a in gk),
              f"SEAM B3 {what}: not finite")
        check(abs(lk - lp) <= 1e-5 * abs(lp), f"SEAM B3 {what}: loss")
        check(abs(lk - lr) <= 1e-5 * abs(lr),
              f"SEAM B3 {what}: loss vs float64")
        check(err_k <= max(1e-4, 2.0 * err_p),
              f"SEAM B3 {what}: gradient less accurate than the plain "
              f"version")
        return gk, gp, ms_p

    # residual signs fixed (observed rows + 3) at ACC_NT_SEAM steps of the
    # same traces, then the real misfit, the main path's (timed in turns
    # above)
    cut = dict(wav=wav[:ACC_NT_SEAM].contiguous(), cfg=dataclasses.replace(
        cfg, grid=dataclasses.replace(g, nt=ACC_NT_SEAM)))
    gf, gpf, _ = accuracy(
        f"residual signs fixed, nt {ACC_NT_SEAM} of {g.nt},",
        tuple((scatter_rows_el(trace_normalize(o[:, :ACC_NT_SEAM]), geom[3],
                               cut["cfg"], KC=8) + 3.0).contiguous()
              for o in (ovx, ovz)), **cut)
    err = max(float((a - b).abs().max()) for a, b in zip(gf, gpf))
    gk, gp, ms_p = accuracy("on the real misfit", rows)
    ms_k = turns["ms"]
    # how far the plain gradient moves under a 1e-7 change of the
    # observed rows: the misfit's own sensitivity (L1 signs that follow
    # rounding would show here)
    gen = torch.Generator(device=dev).manual_seed(0)
    pert = tuple((r * (1.0 + 1e-7 * torch.randn(r.shape, generator=gen,
                                                 device=dev))).contiguous()
                 for r in rows)
    (_, gq), _ = plain(pert)
    print(f"SEAM B3 tnl1 on the real misfit: the kernel's largest gradient "
          f"rel L2 vs plain float32 {_rel_meds(gk, gp):.2e}; under a 1e-7 "
          f"change of its observed rows the plain gradient moves "
          f"{_rel_meds(gq, gp):.2e}")
    l_true, _ = kernel(rows, prep_medium(*true, cfg))
    print(f"SEAM B3 tnl1 loss at the true model: {float(l_true):.3e} (tol "
          f"1e-9)")
    check(float(l_true) <= 1e-9, "SEAM B3 loss at the true model")
    print(f"SEAM B3: {fn.launches} launches, resident "
          f"{fn.resident_launches}, per-step {fn.per_step_launches}")
    check(fn.launches > 0 and fn.resident_launches == fn.launches,
          "SEAM B3 did not run on the resident route")

    # free surface: 2 ring rows on top
    cells = (g.nz + 2 + g.pml_width) * (g.nx + 2 * g.pml_width)
    b3_io = (11 * damp.numel() * 4 + nbytes(wav, *geom)
             + 2 * nbytes(rows[0]) + ns * nx128 * 4 + 4)
    b3_bound = bound((FLOPS_B3 + FLOPS_B3_ADJ) * ns * cells * g.nt, b3_io)
    ring_io = 6 * damp.numel() * 4 + nbytes(wav, *geom_all) + 2 * (
        ns_all * g.nt * geom_all[3].shape[1] * 4)
    ring_bound = bound(FLOPS_B3 * ns_all * cells * g.nt, ring_io)
    print(f"SEAM B3 {shape}: {ms_k:.2f} ms a call ({ms_k / steps * 1e3:.3f} "
          f"us a step of {steps}; per-step route {turns['per_step_ms']:.2f} "
          f"ms), plain {ms_p:.2f} "
          f"ms; bound {b3_bound['bound_ms']:.3f} ms ({b3_bound['bound_by']}: "
          f"{ns} x {cells} cells x {g.nt} steps x "
          f"{FLOPS_B3 + FLOPS_B3_ADJ} flop); ring forward, {ns_all} shots: "
          f"resident {ms_ring:.2f} ms, per-step "
          f"{ring_turns['per_step_ms']:.2f} ms, bound "
          f"{ring_bound['bound_ms']:.3f} ms ({ring_bound['bound_by']})")
    return ({"seam_ms": ms_k, "seam_per_step_ms": turns["per_step_ms"],
             "seam_bound_ms": b3_bound["bound_ms"], "seam_max_abs_err": err},
            {"seam_ms": ms_ring, "seam_per_step_ms": ring_turns["per_step_ms"],
             "seam_bound_ms": ring_bound["bound_ms"]})


def _seam_train(dev):
    """``seam_elastic_robust`` at full width for lstart + 6 epochs, a
    ``loss_H`` every 3rd epoch: the setup split into the workload build,
    the engine (the ring forward of the observed data) and the EPRECOND
    illumination (once, at the first physics step), each physics epoch's
    seconds and B3 launches (one, resident), every gradient finite, the
    peak memory, and the misfit at the true model."""
    import torch
    from physicsbasedfwi2_tpu_torch.engine import engines as t_engines
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.train import train
    from physicsbasedfwi2_tpu_torch.ops import elastic_fused
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import reset_launches
    out_dir = ROOT / "build" / "chip_smoke"
    cfg = get_workload("seam_elastic_robust", save_dir=str(out_dir),
                       holdout_every=3)
    print(f"phase 17: seam_elastic_robust {cfg.nz}x{cfg.nx}, nt {cfg.nt}, "
          f"{cfg.num_shots} shots ({cfg.holdout_shots} held out, "
          f"{cfg.shots_per_iter} per iteration), {cfg.netG} filters "
          f"{cfg.filters}, misfit {cfg.misfit}, stages {cfg.freq_stages}, "
          f"grad_illum_eps {cfg.grad_illum_eps}, step cap {cfg.step_cap}, "
          f"loss_H every {cfg.holdout_every}")
    b3 = elastic_fused.fused_elastic_loss_grad_meds
    ring = elastic_fused.simulate_elastic_ring
    reset_launches(b3, ring)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wl = t_engines.elastic_workload(cfg, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = t_engines.ElasticDIPEngine(cfg, workload=wl, device=dev)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    setup_ring = ring.launches
    illum_s, finite, b3_by_epoch = [], [], {}
    real_illum = t_engines.elastic_illumination

    def timed_illum(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_illum(*args, **kw)
        torch.cuda.synchronize()
        illum_s.append(time.perf_counter() - t0)
        return out

    step_fn = engine.optimize_parameters
    processed = engine._processed_value_and_grad

    def logged(epoch, **kw):
        before = b3.resident_launches
        out = step_fn(epoch, **kw)
        b3_by_epoch[epoch] = b3.resident_launches - before
        return out

    def checked(*args, **kw):
        loss, gm = processed(*args, **kw)
        finite.append(math.isfinite(float(loss))
                      and bool(torch.isfinite(gm).all()))
        return loss, gm

    t_engines.elastic_illumination = timed_illum
    engine.optimize_parameters = logged
    engine._processed_value_and_grad = checked
    epochs = cfg.lstart + 6
    try:
        t0 = time.perf_counter()
        engine, history = train(cfg, epochs=epochs, quiet=True,
                                engine=engine)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        t_engines.elastic_illumination = real_illum
        engine.optimize_parameters = step_fn
        engine._processed_value_and_grad = processed
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    launches = {"fused_elastic_loss_grad": b3.launches,
                "simulate_elastic_ring": ring.launches}
    for rec in history[:1] + history[cfg.lstart - 1:]:
        print("epoch", json.dumps(rec))
    warm = [r["epoch_time"] for r in history[:cfg.lstart]]
    phys = [r["epoch_time"] for r in history[cfg.lstart:]]
    hs = [(r["epoch"], r["loss_H"]) for r in history if "loss_H" in r]
    reverts = [r["guard_revert"] for r in history if "guard_revert" in r]
    print(f"phase 17 seam_elastic_robust: setup {build_s + engine_s:.2f} s = "
          f"workload build {build_s:.2f} s (split-PML simulate_elastic, "
          f"{engine.n_shots} shots) + engine {engine_s:.2f} s (ring forward "
          f"of the observed data, {setup_ring} launch, and the generator), "
          f"then the illumination {', '.join(f'{x:.2f}' for x in illum_s)} "
          f"s at the first physics step; {epochs} epochs in {total:.2f} s; "
          f"warmup epochs: first {warm[0]:.4f} s, median of the rest "
          f"{_median(warm[1:]):.4f} s; physics epochs "
          f"{', '.join(f'{x:.4f}' for x in phys)} s (median "
          f"{_median(phys):.4f}) with B3 resident launches "
          f"{[b3_by_epoch[e] for e in range(cfg.lstart + 1, epochs + 1)]}; "
          f"loss_H {hs}; guard reverts at {reverts}; held-out shots "
          f"{engine._holdout_idx.tolist()}, pool of "
          f"{len(engine._train_pool)}; launches {launches} (B3 resident "
          f"{b3.resident_launches}, per-step {b3.per_step_launches}; ring "
          f"forward resident {ring.resident_launches}, per-step "
          f"{ring.per_step_launches}); peak memory {peak:.2f} GiB")
    check(engine.physics_path == "fused-cuda",
          f"physics path {engine.physics_path}")
    check(len(illum_s) == 1, f"the illumination ran {len(illum_s)} times")
    check(all(b3_by_epoch[e] == 0 for e in range(1, cfg.lstart + 1))
          and all(b3_by_epoch[e] == 1
                  for e in range(cfg.lstart + 1, epochs + 1)),
          "B3 not launched once a physics epoch")
    check(b3.launches == b3.resident_launches == 6
          and b3.per_step_launches == 0,
          "SEAM's B3 did not take the resident route on every epoch")
    check(len(finite) == 6 and all(finite), f"gradients finite: {finite}")
    check(ring.per_step_launches == 0
          and ring.launches == 2 + len(hs),
          "the ring forward not launched resident at setup, for the "
          "guard's anchor and each loss_H")
    check(len(hs) >= 1 and all(math.isfinite(h) and h > 0 for _, h in hs),
          f"loss_H: {hs}")
    for rec in history:
        for k, v in rec.items():
            if isinstance(v, float):
                check(math.isfinite(v), f"epoch {rec['epoch']}: {k}={v}")
    # the engine's own data fit at the true model, true density
    # included, on the training pool (B3, resident)
    loss_true, grad = engine.physics_value_and_grad(
        engine.true_m, fc=0.0, rho=engine.wl.true["rho"])
    print(f"phase 17 seam_elastic_robust: misfit at the true model "
          f"{float(loss_true):.3e} (tol 1e-9), {len(engine._train_pool)} "
          f"shots")
    check(float(loss_true) <= 1e-9, "SEAM engine misfit at the true model")
    check(bool(torch.isfinite(grad).all()), "SEAM engine gradient")
    return launches


def _mcdip_train(dev):
    """``mcdip_uq`` at full width for lstart + 3 epochs (B3 resident on
    each physics epoch, dropout masks on every training decode), then
    ``mc_realizations(32)`` timed, the same seed twice and another seed,
    and ``evaluate(realizations=32)`` of the run's ``latest``
    checkpoint."""
    import numpy as np
    import torch
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.test import evaluate
    from physicsbasedfwi2_tpu_torch.engine.train import train
    from physicsbasedfwi2_tpu_torch.models import blocks
    from physicsbasedfwi2_tpu_torch.ops import elastic_fused
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import reset_launches
    out_dir = ROOT / "build" / "chip_smoke"
    cfg = get_workload("mcdip_uq", save_dir=str(out_dir))
    print(f"phase 17: mcdip_uq {cfg.nz}x{cfg.nx}, nt {cfg.nt}, "
          f"{cfg.num_shots} shots ({cfg.shots_per_iter} per iteration), "
          f"{cfg.netG} filters {cfg.filters}, dropout {cfg.dropout}")
    b3 = elastic_fused.fused_elastic_loss_grad_meds
    ring = elastic_fused.simulate_elastic_ring
    reset_launches(b3, ring)
    draws = []
    real_mask = blocks.dropout_mask

    def counted(x, keep, generator):
        draws.append(x.shape[0])
        return real_mask(x, keep, generator)

    blocks.dropout_mask = counted
    epochs = cfg.lstart + 3
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        t0 = time.perf_counter()
        engine, history = train(cfg, epochs=epochs, quiet=True, device=dev)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        blocks.dropout_mask = real_mask
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    launches = {"fused_elastic_loss_grad": b3.launches,
                "simulate_elastic_ring": ring.launches}
    for rec in history[:1] + history[cfg.lstart - 1:]:
        print("epoch", json.dumps(rec))
    phys = [r["epoch_time"] for r in history[cfg.lstart:]]
    print(f"phase 17 mcdip_uq: {epochs} epochs in {total:.2f} s (setup "
          f"included); physics epochs {', '.join(f'{x:.4f}' for x in phys)} "
          f"s; dropout masks drawn {len(draws)} (6 sites x {epochs} training "
          f"decodes); launches {launches} (B3 resident "
          f"{b3.resident_launches}, per-step {b3.per_step_launches}); peak "
          f"memory {peak:.2f} GiB")
    check(engine.physics_path == "fused-cuda",
          f"physics path {engine.physics_path}")
    check(b3.launches == b3.resident_launches == 3,
          "mcdip_uq's B3 not resident once a physics epoch")
    check(ring.launches >= 1 and ring.per_step_launches == 0,
          "mcdip_uq's ring forward not resident")
    check(len(draws) == 6 * epochs and set(draws) == {1},
          "not one set of masks a training decode")
    for rec in history:
        for k, v in rec.items():
            if isinstance(v, float):
                check(math.isfinite(v), f"epoch {rec['epoch']}: {k}={v}")

    torch.cuda.reset_peak_memory_stats(dev)
    _, ms_mc = timed_ms(lambda: engine.mc_realizations(32), repeats=3)
    mc_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    a = engine.mc_realizations(32, seed=0)
    b = engine.mc_realizations(32, seed=0)
    c = engine.mc_realizations(32, seed=1)
    print(f"phase 17 mc_realizations(32): {ms_mc:.2f} ms (one batched "
          f"decoder pass, to numpy), peak memory {mc_peak:.2f} GiB; shape "
          f"{a.shape}; seed 0 twice equal {np.array_equal(a, b)}, seeds 0 "
          f"and 1 differ {not np.array_equal(a, c)}")
    check(a.shape == (32, cfg.nz, cfg.nx, 2) and np.isfinite(a).all(),
          "mc_realizations shape")
    check(np.array_equal(a, b) and not np.array_equal(a, c),
          "mc_realizations: one seed, one ensemble; two seeds, two")

    res = evaluate(cfg, epoch="latest", realizations=32,
                   results_dir=str(out_dir / "results"), device=dev)
    res_dir = out_dir / "results" / cfg.name / "epoch_latest"
    std = np.load(res_dir / "mc_std.npy")
    mean = np.load(res_dir / "mc_mean.npy")
    w = cfg.water_rows
    pinned = bool(np.all(std[:w] == 0))
    # below the pinned rows a cell keeps one value in every sample only
    # where every sample sits on the field's physical bound (the clip)
    flat = [(k, z, x) for z, x, k in zip(*np.nonzero(std[w:] == 0))]
    on_bound = [bool(mean[w + z, x, k] in (engine.clip_min[k],
                                           engine.clip_max[k]))
                for k, z, x in flat]
    by_field = [sum(k == f for k, _, _ in flat) for f in range(2)]
    print(f"phase 17 evaluate(latest, realizations=32): {res}; mc_std "
          f"{std.shape}: 0 in the {w} pinned rows {pinned}; below them "
          f"> 0 in {float((std[w:] > 0).mean()):.6f} of the cells, 0 in "
          f"{len(flat)} (vp {by_field[0]}, vs {by_field[1]}; rows "
          f"{sorted({w + z for _, z, _ in flat})[:12]}), {sum(on_bound)} of "
          f"them on a clip bound in every sample; mean "
          f"{float(std[w:].mean()):.4f}, max {float(std.max()):.4f}")
    check(set(res) == {"realizations", "mc_std_mean", "loss_V_MSE"}
          and res["realizations"] == 32, "evaluate's metrics")
    check(pinned and all(on_bound) and len(flat) < 0.01 * std[w:].size,
          "mc_std is not 0 in the pinned rows and > 0 below them (but on "
          "the clip bounds)")
    check(not (res_dir / "model.npy").exists(),
          "evaluate wrote a model with realizations")
    return launches


def phase_config5(dev):
    """BASELINE config 5 (SEAM elastic FWI, MC-dropout uncertainty): B3
    and the ring forward at SEAM's grid, ``seam_elastic_robust`` and
    ``mcdip_uq`` at full width.  Returns the paths' launches and the
    kernels' SEAM numbers."""
    import collections
    b3, ring = _seam_kernels(dev)
    launches = collections.Counter(_seam_train(dev))
    launches.update(_mcdip_train(dev))
    return launches, b3, ring


# the acoustic engine's grid and acquisition fields: the five phase-18
# configs share marmousi_acoustic's values of each
ACOUSTIC_BUILD = ("nz", "nx", "dx", "nt", "dt", "pml_width", "freq",
                  "num_shots", "num_receivers", "seed", "chunk")
SGHMC_LSTART = 2  # mcdip_uq's warmup epochs under SGHMC (the recipe: 30)
# phase 19's depth: epochs of each engine (the registered recipes run
# hundreds to thousands), the pretraining's (the recipe: 300), GanFWI's
# sampler steps; the latent inversion and GanFWI cut further to make
# room for phase 25
PRETRAIN_EPOCHS = 30
LATENT_EPOCHS = 3
CLASSIC_AC_EPOCHS = 1
CLASSIC_AC_NT = 1000  # classic_fwi_acoustic's time steps (of 4001)
# the multi-sample engine's time steps (of marmousi_acoustic's 4001): a
# depth cut that makes room for phases 22, 23 and 25
MULTI_NT = 600
CLASSIC_EL_EPOCHS = 1
IMPEDANCE_EPOCHS = 3
ENCODED_EPOCHS = 2
GAN_STEPS = 2


def _vae_logvar(engine):
    """The VAE engine's encoder logvar [1, latent] of its input."""
    import torch
    with torch.no_grad():
        return engine.net.encoder(engine.shots_in).chunk(2, dim=-1)[1]


def _acoustic_run(dev, wl, twin, name, epochs, phase=18, **overrides):
    """``train(get_workload(name, **overrides), epochs=epochs)`` on a
    copy of the shared workload ``wl`` (validated on ``twin``): prints the
    epochs, the peak memory and B1's and B2's launches, checks the fused
    path, B2 resident once an epoch, B1 resident and every number finite.
    ``phase`` labels the lines.  A VAE engine's latent draws are checked
    before it trains
    (:func:`_vae_draws`), and its encoder logvar is read before every
    step: the registered VAE recipe's first Adam step (lr 0.01, a step of
    lr * sign(gradient) in every weight) moves the logvar through the
    encoder's Dense over ~95k features by lr times their summed magnitude
    (tests/test_torch_acoustic_zoo.py), far enough that a training
    decode's exp(logvar / 2) can overflow float32.  So a VAE epoch may be
    non-finite only if its own or an earlier epoch decoded from a logvar
    above 2 ln(FLT_MAX).
    Returns (engine, history, launches)."""
    import dataclasses
    import torch
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.engines import AcousticDIPEngine
    from physicsbasedfwi2_tpu_torch.engine.train import train
    from physicsbasedfwi2_tpu_torch.ops import fwi_fused, scalar2
    cfg = get_workload(name, save_dir=str(ROOT / "build" / "chip_smoke"),
                       **overrides)
    base = get_workload("marmousi_acoustic")
    check(all(getattr(cfg, f) == getattr(base, f) for f in ACOUSTIC_BUILD),
          f"{name}: not marmousi_acoustic's grid and acquisition")
    b1, b2 = scalar2.forward2, fwi_fused.fwi_l1_loss_grad
    scalar2.reset_launches(b1, b2)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    engine = AcousticDIPEngine(cfg, workload=dataclasses.replace(wl),
                               val_workload=twin, device=dev)
    what = name + "".join(f" {k}={v}" for k, v in overrides.items())
    lv_in = {}  # epoch -> the largest logvar its training decode used
    if engine.is_vae:
        _vae_draws(engine, what)
        step = engine.optimize_parameters

        def logged(epoch, **kw):
            lv_in[epoch] = float(_vae_logvar(engine).max())
            return step(epoch, **kw)

        engine.optimize_parameters = logged
    engine, history = train(cfg, epochs=epochs, quiet=True, engine=engine)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    launches = {"forward2": b1.launches, "fwi_l1_loss_grad": b2.launches}
    for rec in history:
        print("epoch", json.dumps(rec))
    secs = ", ".join(f"{r['epoch_time']:.4f}" for r in history)
    print(f"phase {phase} {what}: {cfg.netG}, optimizer {cfg.optimizer}; "
          f"{total:.2f} s in all (engine setup included), epochs {secs} s; "
          f"peak memory {peak:.2f} GiB; launches {launches} (B1 resident "
          f"{b1.resident_launches}, B2 resident {b2.resident_launches})")
    check(engine.physics_path == "fused-cuda",
          f"{what}: physics path {engine.physics_path}")
    check(b2.launches == b2.resident_launches == epochs,
          f"{what}: B2 not resident once an epoch")
    check(b1.launches >= 2 and b1.per_step_launches == 0,
          f"{what}: B1 not resident for obs + direct")
    overflow = 2 * math.log(torch.finfo(torch.float32).max)
    if lv_in:
        print(f"phase {phase} {what}: max logvar entering each step "
              f"{[f'{v:.4g}' for v in lv_in.values()]} (exp(logvar / 2) "
              f"overflows float32 above {overflow:.4g})")
    for rec in history:
        bad = [k for k, v in rec.items()
               if isinstance(v, float) and not math.isfinite(v)]
        over = [e for e, v in lv_in.items()
                if e <= rec["epoch"] and v > overflow]
        check(not bad or over, f"{what} epoch {rec['epoch']}: non-finite "
              f"{bad}")
        if bad:
            print(f"phase {phase} {what} epoch {rec['epoch']}: non-finite {bad}; "
                  f"epoch {over[0]} decoded from logvar "
                  f"{lv_in[over[0]]:.4g} (the recipe's overflow)")
    return engine, history, launches


def _vae_draws(engine, what: str) -> None:
    """Two training decodes of a VAE engine from the same weights differ
    (latent noise from its generator on the card); two ``test()`` calls
    (z = mu) are equal.  (The draws advance the engine's latent
    generator.)"""
    import numpy as np
    import torch
    gen = engine._latent_gen
    with torch.no_grad():
        a, b = (engine.net(engine.shots_in, deterministic=False,
                           generator=gen)[0] for _ in range(2))
    (va, ma), (vb, mb) = engine.test(), engine.test()
    print(f"phase 18 {what}: latent generator on {gen.device}; two "
          f"training decodes differ by {float((a - b).abs().max()):.3e} "
          f"(max); two test() calls equal {np.array_equal(ma, mb)}, "
          f"loss_V_MSE {va['loss_V_MSE']:.6g}")
    check(gen.device.type == "cuda", f"{what}: latent noise not on the card")
    check(not torch.equal(a, b), f"{what}: training decodes equal")
    check(np.array_equal(ma, mb) and va == vb,
          f"{what}: test() is not deterministic")


def _unet_net_timing(engine, what="phase 18 Unet22") -> None:
    """One forward of the engine's generator, and one forward + backward,
    at full width (the engine's [1, 4001, 200, 18] input), timed with CUDA
    events; ``what`` labels the line."""
    import torch
    net, x = engine.net, engine.shots_in
    w = torch.randn(1, engine.cfg.nz, engine.cfg.nx, 1, device=x.device,
                    generator=torch.Generator(device=x.device).manual_seed(0))

    def forward():
        with torch.no_grad():
            return net(x)[0]

    def forward_backward():
        net.zero_grad(set_to_none=True)
        (net(x)[0] * w).sum().backward()

    field, ms_f = timed_ms(forward, repeats=5)
    torch.cuda.reset_peak_memory_stats(x.device)
    _, ms_fb = timed_ms(forward_backward, repeats=5)
    peak = torch.cuda.max_memory_allocated(x.device) / 2**30
    n_par = sum(p.numel() for p in net.parameters())
    print(f"{what} generator at full width, input "
          f"{tuple(x.shape)}, {n_par} weights: forward {ms_f:.2f} ms, "
          f"forward + backward {ms_fb:.2f} ms, peak memory "
          f"{peak:.2f} GiB; field {tuple(field.shape)}")
    check(tuple(field.shape) == (1, engine.cfg.nz, engine.cfg.nx, 1)
          and bool(torch.isfinite(field).all()), f"{what} field")
    net.zero_grad(set_to_none=True)


def _sgmcmc_noise(dev) -> None:
    """One SGLD and one SGHMC step on a 1e6-element parameter on the card
    with a zero gradient: the update is the noise alone, so its sample
    std is sqrt(2 lr T) (SGHMC: sqrt(2 a lr T)) within 1 %, its mean
    within 3 sigma / sqrt(n) of 0; a parameter without a gradient moves
    the same way."""
    import torch
    from physicsbasedfwi2_tpu_torch.optim import sghmc, sgld
    n, lr = 10**6, 1e-3
    for name, make, sigma in (
            ("SGLD", lambda p: sgld([p], lr, seed=0), math.sqrt(2 * lr)),
            ("SGHMC", lambda p: sghmc([p], lr, seed=0),
             math.sqrt(2 * 0.05 * lr))):
        p = torch.nn.Parameter(torch.zeros(n, device=dev))
        p.grad = torch.zeros_like(p)
        opt = make(p)
        opt.step()
        q = torch.nn.Parameter(torch.zeros(n, device=dev))  # .grad None
        make(q).step()
        std, mean = float(p.detach().std()), float(p.detach().mean())
        print(f"phase 18 {name} step, {n} elements on "
              f"{opt.generator.device}: update std {std:.6e} against "
              f"{sigma:.6e} ({std / sigma - 1:+.2e}), mean {mean:+.3e} "
              f"(3 sigma / sqrt(n) = {3 * sigma / math.sqrt(n):.3e}); "
              f"without a gradient equal {torch.equal(p, q)}")
        check(opt.generator.device.type == "cuda",
              f"{name}: generator not on the card")
        check(abs(std / sigma - 1) < 0.01, f"{name}: noise std {std}")
        check(abs(mean) < 3 * sigma / math.sqrt(n), f"{name}: mean {mean}")
        check(torch.equal(p, q), f"{name}: a parameter without a gradient "
              "does not move as one with a zero gradient")


def _mcdip_sghmc(dev):
    """``mcdip_uq`` under SGHMC with its warmup cut to ``SGHMC_LSTART``
    epochs, then 2 physics epochs: B3 resident once a physics epoch, the
    ring forward resident at setup.  SGHMC at the recipe's lr 1e-3 does
    not normalise the step as Adam does, and temperature 1 adds noise of
    std sqrt(2 a lr) = 0.01 a step: the first physics step, and over the
    recipe's 30 warmup epochs the noise alone, throw the decoded model
    onto its clip bounds (vp 1500-4700, vs 0-2700 m/s, the same in both
    packages).  There a decode can put vs above vp in a few cells, where
    the 2D bulk modulus lambda + mu = rho (vp^2 - vs^2) is negative and
    the explicit scheme blows up.  With the warmup cut, every epoch up to
    the first physics one decodes from a model near its start and must be
    finite.  The last epoch's B3 loss may be non-finite only where that
    epoch's model has cells with vs > vp and B3's plain version, run again
    on the card on the same model, shots and data, is non-finite too; the
    model and validation losses must stay finite."""
    import torch
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.engines import ElasticDIPEngine
    from physicsbasedfwi2_tpu_torch.engine.train import train
    from physicsbasedfwi2_tpu_torch.ops import elastic_fused
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import reset_launches
    from physicsbasedfwi2_tpu_torch.optim import SGHMC
    cfg = get_workload("mcdip_uq", optimizer="sghmc", lstart=SGHMC_LSTART,
                       save_dir=str(ROOT / "build" / "chip_smoke"))
    b3 = elastic_fused.fused_elastic_loss_grad_meds
    ring = elastic_fused.simulate_elastic_ring
    reset_launches(b3, ring)
    epochs = cfg.lstart + 2
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    engine = ElasticDIPEngine(cfg, device=dev)
    kernel_vg = engine._fused_value_and_grad
    calls = []  # per physics epoch: (model, shots, data, loss)

    def recorded(m, shot_idx, pd, rho=None):
        loss, grad = kernel_vg(m, shot_idx, pd, rho)
        calls.append((m.clone(), shot_idx.clone(), pd, float(loss)))
        return loss, grad

    engine._fused_value_and_grad = recorded
    engine, history = train(cfg, epochs=epochs, quiet=True, engine=engine)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    launches = {"fused_elastic_loss_grad": b3.launches,
                "simulate_elastic_ring": ring.launches}
    for rec in history:
        print("epoch", json.dumps(rec))
    phys = [r["epoch_time"] for r in history[cfg.lstart:]]
    n_vs_vp = [int((m[..., 1] > m[..., 0]).sum()) for m, *_ in calls]
    print(f"phase 18 mcdip_uq optimizer=sghmc, warmup cut to {cfg.lstart} "
          f"epochs: {epochs} epochs in {total:.2f} s (setup included); "
          f"physics epochs {', '.join(f'{x:.4f}' for x in phys)} s; "
          f"cells with vs > vp in each physics decode {n_vs_vp}; launches "
          f"{launches} (B3 resident {b3.resident_launches}, ring forward "
          f"resident {ring.resident_launches}); peak memory {peak:.2f} GiB")
    check(isinstance(engine.opt, SGHMC)
          and engine.opt.generator.device.type == "cuda",
          "mcdip_uq: not SGHMC with its noise on the card")
    check(engine.physics_path == "fused-cuda",
          f"physics path {engine.physics_path}")
    check(b3.launches == b3.resident_launches == 2 and len(calls) == 2,
          "mcdip_uq under SGHMC: B3 not resident once a physics epoch")
    check(ring.launches >= 1 and ring.per_step_launches == 0,
          "mcdip_uq under SGHMC: ring forward not resident")
    for rec in history:
        bad = [k for k, v in rec.items()
               if isinstance(v, float) and not math.isfinite(v)]
        check(not bad or (bad == ["loss_D_MSE"] and rec["epoch"] == epochs),
              f"mcdip_uq under SGHMC epoch {rec['epoch']}: non-finite {bad}")
    m, idx, pd, loss = calls[-1]
    if not math.isfinite(loss):
        kernel = elastic_fused.fused_elastic_loss_grad_meds
        elastic_fused.fused_elastic_loss_grad_meds = \
            elastic_fused.fused_elastic_loss_grad_meds_plain
        try:
            lp, _ = kernel_vg(m, idx, pd)
        finally:
            elastic_fused.fused_elastic_loss_grad_meds = kernel
        print(f"phase 18 mcdip_uq under SGHMC: the last epoch's B3 loss "
              f"{loss} on a model with vp {float(m[..., 0].min()):.0f}-"
              f"{float(m[..., 0].max()):.0f}, vs {float(m[..., 1].min()):.0f}"
              f"-{float(m[..., 1].max()):.0f} m/s and {n_vs_vp[-1]} cells "
              f"with vs > vp; its plain version's loss {float(lp)}")
        check(n_vs_vp[-1] > 0 and not math.isfinite(float(lp)),
              "B3's non-finite loss is not its plain version's, or has no "
              "cell with vs > vp")
    return launches


_SHARED_ACOUSTIC: dict = {}


def _shared_acoustic(dev, phase: int):
    """``marmousi_acoustic``'s synthetic workload and its validation twin
    (``validate_on_twin``) on the card, built at the first call and kept
    for the acoustic engines of phases 18 and 21 (each trains on a
    copy)."""
    import torch
    from physicsbasedfwi2_tpu_torch.data.synthetic import (
        SyntheticAcousticWorkload)
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    if dev not in _SHARED_ACOUSTIC:
        base = get_workload("marmousi_acoustic")
        kw = {f: getattr(base, f) for f in ACOUSTIC_BUILD if f != "seed"}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wl = SyntheticAcousticWorkload.build(**kw, seed=base.seed,
                                             device=dev)
        twin = SyntheticAcousticWorkload.build(**kw, seed=base.seed + 101,
                                               device=dev)
        torch.cuda.synchronize()
        _SHARED_ACOUSTIC[dev] = wl, twin
        print(f"phase {phase}: marmousi_acoustic's workload and its twin "
              f"{base.nz}x{base.nx}, nt {base.nt}, {base.num_shots} shots x "
              f"{base.num_receivers} receivers, built once in "
              f"{time.perf_counter() - t0:.2f} s for the acoustic engines")
    return _SHARED_ACOUSTIC[dev]


def phase_config2(dev):
    """BASELINE config 2 (Unet22) and the acoustic generator zoo at full
    width on one shared workload, then SGLD and SGHMC.  Returns the
    paths' launches."""
    import collections
    wl, twin = _shared_acoustic(dev, 18)
    launches = collections.Counter()

    engine, hist, n = _acoustic_run(dev, wl, twin, "marmousi_acoustic_unet",
                                    3)
    launches.update(n)
    losses = [r["loss_D"] for r in hist]
    check(losses[-1] <= 1.01 * losses[0],
          f"Unet22: loss_D neither falls nor stays level: {losses}")
    _unet_net_timing(engine)
    del engine
    for name in ("marmousi_acoustic_vae", "marmousi_acoustic_nf",
                 "marmousi_acoustic_vaeflow"):
        _, _, n = _acoustic_run(dev, wl, twin, name, 3)
        launches.update(n)
    for overrides in ({"netG": "Auto22CBAM"}, {"optimizer": "sgld"}):
        _, _, n = _acoustic_run(dev, wl, twin, "marmousi_acoustic", 2,
                                **overrides)
        launches.update(n)
    launches.update(_mcdip_sghmc(dev))
    _sgmcmc_noise(dev)
    return launches



def _all_kernels() -> dict:
    """Every kernel wrapper with a launch counter, by the kernels line's
    names."""
    from physicsbasedfwi2_tpu_torch.ops import kernel_wrappers
    return kernel_wrappers()


def _train19(dev, what, cfg, epochs, build):
    """``train(cfg, epochs=epochs, engine=build())`` on the card: prints
    the engine's setup seconds, each epoch's seconds and record, the peak
    memory and the physics path, and checks that every number is finite.
    Returns (engine, history)."""
    import torch
    from physicsbasedfwi2_tpu_torch.engine.train import train
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = build()
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    check(engine.device == dev, f"{what}: engine on {engine.device}")
    engine, history = train(cfg, epochs=epochs, quiet=True, engine=engine)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    for rec in history:
        print("epoch", json.dumps(rec))
    secs = ", ".join(f"{r['epoch_time']:.4f}" for r in history)
    print(f"phase 19 {what}: {cfg.nz}x{cfg.nx}, nt {cfg.nt}, "
          f"{cfg.num_shots} shots x {cfg.num_receivers} receivers; physics "
          f"path {engine.physics_path}; setup {setup:.2f} s; epochs {secs} "
          f"s; peak memory {peak:.2f} GiB")
    for rec in history:
        for k, v in rec.items():
            if isinstance(v, float):
                check(math.isfinite(v), f"{what} epoch {rec['epoch']}: "
                      f"{k}={v}")
    return engine, history


def _nondeterministic_ops(fn) -> list[str]:
    """The ops that ``torch.use_deterministic_algorithms(True,
    warn_only=True)`` names while ``fn()`` runs: each warning's first
    sentence, once."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(". ")[0][:200] for w in caught
                   if "determinis" in str(w.message)})


def _weight_grads(dev, cfg, in_shape, n_inputs=1):
    """(net, grads): ``cfg.netG`` built as its engine builds it for inputs
    [1, *in_shape] (``n_inputs`` of them, random, from a seeded generator
    on the card), and a function that returns the weight gradients of one
    forward + backward of a fixed random projection of its output."""
    import torch
    from physicsbasedfwi2_tpu_torch.models import define_generator
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = [torch.randn(1, *in_shape, device=dev, generator=gen)
          for _ in range(n_inputs)]
    net = define_generator(
        cfg.netG, out_shape=(cfg.nz, cfg.nx), in_shape=in_shape,
        latent_dim=cfg.latent_dim, filters=cfg.filters,
        time_decimation=cfg.time_decimation, dropout=0.0,
        head=cfg.elastic_head,
        generator=torch.Generator().manual_seed(cfg.seed)).to(dev)
    with torch.no_grad():
        w = torch.randn(net(*xs)[0].shape, device=dev, generator=gen)

    def grads():
        net.zero_grad(set_to_none=True)
        (net(*xs)[0] * w).sum().backward()
        return [p.grad.clone() for p in net.parameters()]

    return net, grads


def _generator_determinism(dev) -> None:
    """The generators' and the pretraining's backward repeat on the card:
    the ops that the deterministic-algorithms check names on them (one
    pretraining epoch of config 4's ModelVae, then one forward + backward
    of Unet22 and Auto22 at ``marmousi_acoustic``'s [1, 4001, 200, 18]
    and of AutoElMar22 at ``marmousi_elastic``'s two [1, 3334, 298, 35]
    inputs), and each net's weight gradients taken twice on the same
    inputs, held to ``torch.equal``."""
    import torch
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.pretrain import (
        make_model_bank, pretrain_model_vae)
    ac = get_workload("marmousi_acoustic")
    el = get_workload("marmousi_elastic")
    lat = get_workload("latent_inversion")
    ac_in = (ac.nt, ac.num_receivers, ac.num_shots)
    nets = {
        "Unet22": _weight_grads(dev, get_workload("marmousi_acoustic_unet"),
                                ac_in),
        ac.netG: _weight_grads(dev, ac, ac_in),
        el.netG: _weight_grads(dev, el, (el.nt, el.num_receivers,
                                         el.num_shots), n_inputs=2)}
    bank = make_model_bank(16, lat.nz, lat.nx, water_rows=6, seed=3)

    def run():
        pretrain_model_vae(bank, latent_dim=lat.latent_dim,
                           filters=lat.filters, epochs=1, batch_size=8,
                           lr=2e-3, device=dev)
        for _, grads in nets.values():
            grads()

    named = _nondeterministic_ops(run)
    print(f"phase 19 ops named by torch.use_deterministic_algorithms(True, "
          f"warn_only=True) on the pretraining and the generators' forward "
          f"+ backward: {named or 'none'}")
    for name, (net, grads) in nets.items():
        a, b = grads(), grads()
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        print(f"phase 19 {name}: {len(a)} weight gradients taken twice on "
              f"the same inputs, torch.equal: {same}")
        check(same, f"{name}: the weight gradients do not repeat")
        net.zero_grad(set_to_none=True)


def _config4(dev, out_dir):
    """BASELINE config 4 at its registered size through
    ``experiments/run_latent_flagship.py`` (the recipe's two stages), its
    pretraining's epochs cut from 300 to ``PRETRAIN_EPOCHS`` and its
    inversion's from 400 to ``LATENT_EPOCHS``: the VAE pretraining on a
    48-model bank, run once more from the same seed and held equal, the
    latent inversion through the frozen decoder, its checkpoint (the
    latent alone) and ``evaluate`` of it, then GanFWI's SGLD over the
    same decoder and workload."""
    import numpy as np
    import torch
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.engines import (
        LatentInversionEngine)
    from physicsbasedfwi2_tpu_torch.engine.ganfwi import GanFWI
    from physicsbasedfwi2_tpu_torch.engine.pretrain import (
        make_model_bank, pretrain_model_vae)
    from physicsbasedfwi2_tpu_torch.engine.test import evaluate
    from physicsbasedfwi2_tpu_torch.experiments.run_latent_flagship import (
        run_latent_flagship)
    from physicsbasedfwi2_tpu_torch.models import apply_velocity_output
    cfg = get_workload("latent_inversion", save_dir=str(out_dir))
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist, engine, history = run_latent_flagship(
        cfg, epochs=LATENT_EPOCHS, pretrain_epochs=PRETRAIN_EPOCHS,
        device=dev)
    torch.cuda.synchronize()
    secs_tool = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    net, norm = engine.net, engine.decoder_norm
    # the tool's pretraining again (its bank: 48 models from seed 3)
    bank = make_model_bank(48, cfg.nz, cfg.nx, water_rows=6, seed=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net2, _, hist2 = pretrain_model_vae(
        bank, latent_dim=cfg.latent_dim, filters=cfg.filters,
        epochs=PRETRAIN_EPOCHS, batch_size=8, lr=2e-3, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    sd, sd2 = net.state_dict(), net2.state_dict()
    weights = all(torch.equal(sd[k], sd2[k]) for k in sd)
    print(f"phase 19 config 4 pretraining, the tool's and once more from "
          f"seed 0: recon-loss histories equal {hist == hist2}, weights "
          f"torch.equal {weights}; first {[f'{h:.9g}' for h in hist[-3:]]}, "
          f"second {[f'{h:.9g}' for h in hist2[-3:]]} (last 3 epochs)")
    check(hist == hist2 and weights,
          "two pretrainings from one seed differ")
    print(f"phase 19 config 4 pretraining: ModelVae {cfg.nz}x{cfg.nx}, "
          f"filters {cfg.filters}, latent {cfg.latent_dim}, 48 models, "
          f"batch 8, {PRETRAIN_EPOCHS} epochs in {secs:.2f} s "
          f"({secs / PRETRAIN_EPOCHS:.4f} s an epoch of 6 steps); recon "
          f"loss {hist[0]:.6f} -> {hist[-1]:.6f}; norm {norm}")
    check(all(math.isfinite(h) for h in hist) and hist[-1] < hist[0],
          f"pretraining's recon loss does not fall: {hist[0]} -> {hist[-1]}")

    for rec in history:
        print("epoch", json.dumps(rec))
    epoch_s = ", ".join(f"{r['epoch_time']:.4f}" for r in history)
    print(f"phase 19 run_latent_flagship (latent_inversion {cfg.nz}x"
          f"{cfg.nx}, nt {cfg.nt}, {cfg.num_shots} shots x "
          f"{cfg.num_receivers} receivers; physics path "
          f"{engine.physics_path}): {PRETRAIN_EPOCHS} pretraining and "
          f"{LATENT_EPOCHS} inversion epochs in {secs_tool:.2f} s; epochs "
          f"{epoch_s} s; peak memory {peak:.2f} GiB")
    check(engine.device == dev, f"latent_inversion: engine on "
          f"{engine.device}")
    for rec in history:
        for k, v in rec.items():
            if isinstance(v, float):
                check(math.isfinite(v), f"latent_inversion epoch "
                      f"{rec['epoch']}: {k}={v}")
    losses = [r["loss_D_MSE"] for r in history]
    check(min(losses[1:]) < losses[0],
          f"latent_inversion: loss_D_MSE does not fall below epoch 1's: "
          f"{losses}")
    with np.load(out_dir / cfg.name / "latest_net_G.npz") as zf:
        check(zf.files == ["['z']"], f"latent checkpoint keys {zf.files}")
    z = engine.params["z"].detach().clone()
    fresh = LatentInversionEngine(cfg, decoder_net=net, decoder_norm=norm,
                                  device=dev)
    res = evaluate(cfg, epoch="latest", results_dir=str(out_dir / "results"),
                   engine=fresh)
    same = torch.equal(fresh.params["z"], z)
    print(f"phase 19 latent_inversion evaluate(latest): {res}; z restored "
          f"{same}: {z.cpu().numpy().round(5).tolist()}")
    check(same and math.isfinite(res["loss_V_MSE"]),
          "evaluate did not restore z")

    wl = engine.wl
    true_b = wl.vp_true[None, :, :, None]

    def decode(zz):
        return apply_velocity_output(net.decode(zz), true_b, vmin=norm[0],
                                     vmax=norm[1],
                                     water_vel=cfg.water_vel)[0, :, :, 0]

    gan = GanFWI(decode, cfg.latent_dim, wl, sampler="sgld", lr=1e-3,
                 seed=cfg.seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_losses, samples = gan.sample(GAN_STEPS, burn_in=1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"phase 19 GanFWI (SGLD, lr 1e-3) over the pretrained decoder: "
          f"{GAN_STEPS} steps in {secs:.2f} s; losses "
          f"{[f'{x:.6g}' for x in g_losses]}; samples {samples.shape}; "
          f"noise generator on {gan.opt.generator.device}")
    check(all(math.isfinite(x) for x in g_losses)
          and samples.shape == (GAN_STEPS - 1, cfg.nz, cfg.nx),
          "GanFWI: a loss not finite or the samples' shape")


def _round_trip19(dev, engine, path) -> None:
    """save_engine / restore_engine on the card: a fresh engine of the
    same config restores the weights and the optimizer state to the bit."""
    import torch
    from physicsbasedfwi2_tpu_torch.engine.checkpoint import (
        restore_engine, save_engine)
    from physicsbasedfwi2_tpu_torch.engine.engines import create_engine
    save_engine(engine, str(path), epoch=3)
    fresh = create_engine(engine.cfg, device=dev)
    epoch = restore_engine(fresh, str(path))
    a, b = engine.weights.state_dict(), fresh.weights.state_dict()
    weights = a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                           for k in a)
    sa, sb = engine.opt.state_dict(), fresh.opt.state_dict()
    moments = [torch.equal(x[k], y[k]) for x, y in
               zip(sa["state"].values(), sb["state"].values()) for k in x]
    print(f"phase 19 save_engine/restore_engine ({engine.cfg.name}, "
          f"{type(engine.opt).__name__}): epoch {epoch}; {len(a)} weight "
          f"tensors equal {weights}; {len(moments)} optimizer state tensors "
          f"equal {all(moments)}; lr {sb['param_groups'][0]['lr']}; "
          f"{path.stat().st_size} bytes")
    check(epoch == 3 and weights and moments and all(moments)
          and sa["param_groups"] == sb["param_groups"],
          "the checkpoint round trip changed the state")


def phase_other_engines(dev):
    """BASELINE config 4 and the rest of the physics engines at full
    width (plain PyTorch: no kernel launch); classic acoustic FWI and the
    encoded engine on marmousi_acoustic's grid each on a copy of one
    workload (and the encoded engine on one validation twin), built
    once; the multi-sample engine on two workloads of its own at its cut
    nt."""
    import dataclasses
    import torch
    from physicsbasedfwi2_tpu_torch.data.synthetic import (
        SyntheticAcousticWorkload)
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.engines import (
        AcousticDIPEngine, ClassicFWIEngine, ImpedanceDIPEngine,
        MultiSampleAcousticDIPEngine)
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import reset_launches
    out_dir = ROOT / "build" / "chip_smoke"
    counters = _all_kernels()
    reset_launches(*counters.values())
    print(f"phase 19 on {card_line()}")
    t_phase = time.perf_counter()
    _generator_determinism(dev)
    _config4(dev, out_dir)

    base = get_workload("marmousi_acoustic")
    kw = {f: getattr(base, f) for f in ACOUSTIC_BUILD if f != "seed"}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wl = SyntheticAcousticWorkload.build(**kw, seed=base.seed, device=dev)
    twin = SyntheticAcousticWorkload.build(**kw, seed=base.seed + 101,
                                           device=dev)
    torch.cuda.synchronize()
    print(f"phase 19: marmousi_acoustic's workload and its twin built once "
          f"in {time.perf_counter() - t0:.2f} s for "
          f"marmousi_acoustic_encoded")

    cfg = get_workload("classic_fwi_acoustic", save_dir=str(out_dir),
                       nt=CLASSIC_AC_NT)
    check(all(getattr(cfg, f) == getattr(base, f) for f in ACOUSTIC_BUILD
              if f != "nt"),
          "classic_fwi_acoustic: not marmousi_acoustic's grid")
    _train19(dev, "classic_fwi_acoustic", cfg, CLASSIC_AC_EPOCHS,
             lambda: ClassicFWIEngine(cfg, workload=SyntheticAcousticWorkload
                                      .build(**dict(kw, nt=CLASSIC_AC_NT),
                                             seed=base.seed, device=dev),
                                      device=dev))

    cfg = get_workload("classic_fwi_elastic", save_dir=str(out_dir))
    holder = {}

    def classic_el():
        holder["e"] = ClassicFWIEngine(cfg, device=dev)
        holder["vs0"] = holder["e"].params["vs"].detach().clone()
        return holder["e"]

    engine, _ = _train19(dev, "classic_fwi_elastic", cfg, CLASSIC_EL_EPOCHS,
                         classic_el)
    moved = float((engine.params["vs"].detach() - holder["vs0"]).abs().max())
    print(f"phase 19 classic_fwi_elastic: {cfg.shots_per_iter} of "
          f"{engine.n_shots} shots a step; vs moved by up to {moved:.4f} m/s")
    check(engine.physics_path == "fast" and moved > 0,
          "classic_fwi_elastic: not the fast path, or vs did not move")

    cfg = get_workload("marmousi_impedance", save_dir=str(out_dir))
    engine, _ = _train19(dev, "marmousi_impedance", cfg, IMPEDANCE_EPOCHS,
                         lambda: ImpedanceDIPEngine(cfg, device=dev))
    _round_trip19(dev, engine, out_dir / "impedance_state.pt")

    cfg = get_workload("marmousi_acoustic_encoded", save_dir=str(out_dir))
    check(all(getattr(cfg, f) == getattr(base, f) for f in ACOUSTIC_BUILD),
          "marmousi_acoustic_encoded: not marmousi_acoustic's grid")
    engine, _ = _train19(dev, "marmousi_acoustic_encoded", cfg,
                         ENCODED_EPOCHS,
                         lambda: AcousticDIPEngine(
                             cfg, workload=dataclasses.replace(wl),
                             val_workload=twin, device=dev))
    check(engine.physics_path == "encoded",
          f"encoded: physics path {engine.physics_path}")

    cfg = get_workload("marmousi_acoustic", save_dir=str(out_dir),
                       engine="acoustic_dip_multi", lstart=1, nt=MULTI_NT)
    cut = dict(kw, nt=MULTI_NT)
    engine, hist = _train19(
        dev, "acoustic_dip_multi (marmousi_acoustic, 2 samples, lstart 1)",
        cfg, 2, lambda: MultiSampleAcousticDIPEngine(
            cfg, workloads=[SyntheticAcousticWorkload.build(
                                **cut, seed=base.seed + s, device=dev)
                            for s in (0, 1)],
            device=dev))
    check("loss_M" in hist[0] and "loss_D" in hist[1],
          "multi-sample: not loss_M then loss_D")

    launches = {k: fn.launches for k, fn in counters.items()}
    torch.cuda.synchronize()
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s; kernel "
          f"launches {launches}")
    check(not any(launches.values()),
          f"phase 19 launched kernels: {launches}")


def _train20(dev, what, cfg, epochs):
    """``train(cfg, epochs=epochs)`` from ``cfg.dataroot`` on the card:
    prints the engine's setup seconds, the epochs and the peak memory,
    and checks that every number is finite and the path is fused.
    Returns (engine, history)."""
    import torch
    from physicsbasedfwi2_tpu_torch.engine.engines import create_engine
    from physicsbasedfwi2_tpu_torch.engine.train import train
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = create_engine(cfg, device=dev)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    engine, history = train(cfg, epochs=epochs, quiet=True, engine=engine)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    for rec in history[:2] + history[-3:]:
        print("epoch", json.dumps(rec))
    secs = [r["epoch_time"] for r in history]
    print(f"phase 20 {what} from {cfg.dataroot}: physics path "
          f"{engine.physics_path}; engine setup {setup:.2f} s (the tree "
          f"read, no simulation of the observed data); epochs: first "
          f"{secs[0]:.4f} s, last {len(secs[-3:])} "
          f"{', '.join(f'{x:.4f}' for x in secs[-3:])} s; peak memory "
          f"{peak:.2f} GiB")
    check(engine.physics_path == "fused-cuda" and engine.wl.from_disk,
          f"{what}: path {engine.physics_path}, from disk "
          f"{engine.wl.from_disk}")
    for rec in history:
        for k, v in rec.items():
            if isinstance(v, float):
                check(math.isfinite(v), f"{what} epoch {rec['epoch']}: "
                      f"{k}={v}")
    return engine, history


def _real_data_model(cfg):
    """real_data's true model inside its clip bounds: the canonical
    Marmousi-structured vp at 150 x 300 mapped linearly from [1500, 4700]
    onto [3000, 6000] m/s (no water below clip_min), vs and rho pinned at
    881 and 1010 as the config's bounds pin them; and its starting model
    (vp smoothed)."""
    import numpy as np
    from physicsbasedfwi2_tpu_torch.data.marmousi import canonical_marmousi_vp
    from physicsbasedfwi2_tpu_torch.data.synthetic import smooth_model
    (v0, vs, rho), (v1, _, _) = cfg.clip_min, cfg.clip_max
    vp = canonical_marmousi_vp(cfg.nz, cfg.nx)
    vp = (v0 + (vp - 1500.0) * (v1 - v0) / 3200.0).astype(np.float32)
    true = (vp, np.full_like(vp, vs), np.full_like(vp, rho))
    start = (smooth_model(vp), true[1], true[2])
    return true, start


def _real_data_b3(dev, engine, true):
    """The ring forward and B3 at real_data's grid (150 x 300 at dx 30 m,
    absorbing top, 192 x 384 in kernel layout, nt 2001: 16 bands of 12
    rows in layout 1), before training: each plan with its clusters
    resident and each instance's ptxas line; the ring forward of the
    true model on the 12 shots, its two routes timed in turns and held
    to bit equality, the resident route against the plain version on 2
    shots; B3 on those 2 shots of the prepped tree on its resident
    route: the loss and gradient on the real misfit at the starting
    model against the plain version in float32 and float64, and the
    loss at the true model; then B3's two routes timed in turns on the
    engine's 4 shots a physics epoch and held to bit equality, and a
    device trace of one resident call.  Returns
    the kernels line's ``real_data_*`` fields of B3 and of the ring
    forward (comparison launches, not counted)."""
    import torch
    from physicsbasedfwi2_tpu_torch.ops import trace_normalize
    from physicsbasedfwi2_tpu_torch.ops.elastic_fused import (
        _layout, elastic_forward_plan, elastic_resident_plan,
        fused_elastic_loss_grad_meds, fused_elastic_loss_grad_meds_plain,
        prep_damp, prep_medium, scatter_rows_el, simulate_elastic_ring,
        simulate_elastic_ring_plain)
    wl, cfg = engine.wl, engine.wl.cfg
    g = cfg.grid
    nz8, nx128 = _layout(cfg)[4:]
    check((nz8, nx128) == (192, 384) and not g.free_surface,
          "real_data's kernel layout")
    plan = elastic_resident_plan(nz8, nx128)
    fplan = elastic_forward_plan(nz8, nx128)
    check(plan is not None and (plan.band_rows, plan.layout) == (12, 1)
          and fplan is not None and (fplan.band_rows, fplan.layout)
          == (12, 1), "real_data's plans are not 12-row bands of layout 1")
    el_ptxas(12, 1)
    true_t = tuple(torch.as_tensor(a, device=dev) for a in true)

    # the ring forward: the true model's 12 shots, both routes in turns
    ns_all = wl.geom[0].shape[0]
    fwd_cluster_report(ns_all, nz8, nx128, "real_data ring forward")
    ring_turns = route_turns(
        "real_data ring forward", lambda r: simulate_elastic_ring(
            *true_t, wl.wavelet, *wl.geom, cfg, route=r), g.nt, exact=True)
    two = torch.tensor([0, 6], device=dev)
    geom2 = tuple(a[two].contiguous() for a in wl.geom)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        pvx, pvz = simulate_elastic_ring_plain(*true_t, wl.wavelet, *geom2,
                                               cfg)
    torch.cuda.synchronize()
    ms_rp = (time.perf_counter() - t0) * 1e3
    ovx, ovz = (o[two] for o in ring_turns["out"])
    scale = max(float(pvx.abs().max()), float(pvz.abs().max()))
    err_r = max(float((ovx - pvx).abs().max()), float((ovz - pvz).abs().max()))
    check(all(bool(torch.isfinite(o).all()) for o in ring_turns["out"]),
          "real_data ring forward not finite")
    check(err_r <= 1e-4 * scale, "real_data ring forward disagrees with its "
          "plain version")
    cells = (g.nz + 2 * g.pml_width) * (g.nx + 2 * g.pml_width)
    nr = wl.geom[3].shape[1]
    ring_io = 6 * nz8 * nx128 * 4 + nbytes(wl.wavelet, *wl.geom) + 2 * (
        ns_all * g.nt * nr * 4)
    ring_b = bound(FLOPS_B3 * ns_all * cells * g.nt, ring_io)
    print(f"phase 20 real_data ring forward [{ns_all} shots x {nr} "
          f"receivers, nt {g.nt}]: resident {ring_turns['ms']:.2f} ms, "
          f"per-step {ring_turns['per_step_ms']:.2f} ms, bound "
          f"{ring_b['bound_ms']:.3f} ms ({ring_b['bound_by']}: {ns_all} x "
          f"{cells} cells x {g.nt} steps x {FLOPS_B3} flop); against plain "
          f"on shots [0, 6]: max|err| {err_r:.3e} of max {scale:.3e} (tol "
          f"1e-4 of max); plain {ms_rp:.2f} ms")

    damp = prep_damp(cfg, dev)
    start = prep_medium(*(wl.start[k] for k in ("vp", "vs", "rho")), cfg)
    fn = fused_elastic_loss_grad_meds

    def case(pick):
        geom = tuple(a[pick].contiguous() for a in wl.geom)
        rows = tuple(scatter_rows_el(trace_normalize(o[pick]), geom[3], cfg,
                                     KC=8) for o in (wl.obs_vx, wl.obs_vz))
        return geom, rows

    geom, rows = case(two)

    def kernel(m, geom=geom, rows=rows, route=None):
        return fn(m, damp, wl.wavelet, *geom, cfg, *rows, KC=8,
                  misfit=engine.cfg.misfit, route=route)

    def plain(dtype):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fused_elastic_loss_grad_meds_plain(
            start, damp, wl.wavelet, *geom, cfg, *rows, KC=8,
            misfit=engine.cfg.misfit, dtype=dtype)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    before = (fn.launches, fn.resident_launches)
    lk, gk = kernel(start)
    (lp, gp), ms_p = plain(torch.float32)
    (lr, gr), _ = plain(torch.float64)
    lk, lp, lr = float(lk), float(lp), float(lr)
    err_k, err_p = _rel_meds(gk, gr), _rel_meds(gp, gr)
    err = max(float((a - b).abs().max()) for a, b in zip(gk, gp))
    l_true, _ = kernel(prep_medium(*true_t, cfg))
    print(f"phase 20 real_data B3 {engine.cfg.misfit}, 2 shots x "
          f"{geom[3].shape[1]} receivers, nt {g.nt}, resident route: loss "
          f"{lk:.9g} vs plain {lp:.9g} (rel {abs(lk - lp) / abs(lp):.2e}, "
          f"tol 1e-5), float64 {lr:.9g}; gradient rel L2 against float64: "
          f"kernel {err_k:.2e}, plain float32 {err_p:.2e} (tol max(1e-4, 2x "
          f"plain)); max|kernel - plain| {err:.3e}; loss at the true model "
          f"{float(l_true):.3e} (tol 1e-9); plain {ms_p:.2f} ms")
    check(math.isfinite(lk) and all(bool(torch.isfinite(a).all())
                                    for a in gk), "real_data B3: not finite")
    check(abs(lk - lp) <= 1e-5 * abs(lp) and abs(lk - lr) <= 1e-5 * abs(lr),
          "real_data B3: loss")
    check(err_k <= max(1e-4, 2.0 * err_p), "real_data B3: gradient less "
          "accurate than the plain version")
    check(float(l_true) <= 1e-9, "real_data B3: loss at the true model")
    check((fn.launches - before[0], fn.resident_launches - before[1])
          == (2, 2), "real_data B3 did not take the resident route")

    # the engine's call: shots_per_iter shots of the pool, both routes
    geom4, rows4 = case(torch.arange(engine.cfg.shots_per_iter, device=dev))
    ns = geom4[0].shape[0]
    el_cluster_report(ns, nz8, nx128, what="real_data B3")
    steps = 3 * rows4[0].shape[1]  # forward, recompute, adjoint
    turns = route_turns("real_data B3", lambda r: kernel(
        start, geom4, rows4, route=r), steps, exact=True)
    n = phase_trace("real_data B3 (resident route)",
                    lambda: kernel(start, geom4, rows4))
    check(n["el_fwd_resident"] == 1 and n["el_rev_resident_l1"] == 1
          and n["el_band_media"] == 1,
          "resident real_data B3 is not layout 1's one launch a sweep")
    io = (11 * damp.numel() * 4 + nbytes(wl.wavelet, *geom4)
          + 2 * nbytes(rows4[0]) + ns * nx128 * 4 + 4)
    b = bound((FLOPS_B3 + FLOPS_B3_ADJ) * ns * cells * g.nt, io)
    print(f"phase 20 real_data B3, {ns} shots (a physics epoch's call): "
          f"resident {turns['ms']:.2f} ms ({turns['ms'] / steps * 1e3:.3f} "
          f"us a step of {steps}), per-step {turns['per_step_ms']:.2f} ms; "
          f"bound {b['bound_ms']:.3f} ms ({b['bound_by']}: {ns} x {cells} "
          f"cells x {g.nt} steps x {FLOPS_B3 + FLOPS_B3_ADJ} flop)")
    return ({"real_data_ms": turns["ms"],
             "real_data_per_step_ms": turns["per_step_ms"],
             "real_data_bound_ms": b["bound_ms"],
             "real_data_plain_ms_2_shots": ms_p,
             "real_data_max_abs_err": err},
            {"real_data_ms": ring_turns["ms"],
             "real_data_per_step_ms": ring_turns["per_step_ms"],
             "real_data_bound_ms": ring_b["bound_ms"],
             "real_data_plain_ms_2_shots": ms_rp,
             "real_data_max_abs_err": err_r})


def phase_dataroot(dev):
    """Training from a dataroot at full width (see the module docstring,
    phase 20).  Returns (launches by kernel, each launched kernel's
    launches by route, B3's and the ring forward's real_data fields)."""
    import collections
    import shutil
    import tempfile
    import numpy as np
    import torch
    from physicsbasedfwi2_tpu_torch.data import native_loader, native_su, prep
    from physicsbasedfwi2_tpu_torch.data.marmousi import (
        canonical_marmousi_vp, write_segy_grid)
    from physicsbasedfwi2_tpu_torch.engine.race import main as race_main
    from physicsbasedfwi2_tpu_torch.experiments.make_realdata_su import (
        write_su_gather)
    from physicsbasedfwi2_tpu_torch.engine import test as t_test
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.geo import elastic_line, ricker
    from physicsbasedfwi2_tpu_torch.geo import Grid2D
    from physicsbasedfwi2_tpu_torch.ops.elastic import ElasticConfig
    from physicsbasedfwi2_tpu_torch.ops.elastic_fused import (
        simulate_elastic_ring)
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import reset_launches
    counters = _all_kernels()
    launches = collections.Counter()
    routes = collections.defaultdict(collections.Counter)

    def path(what, fn):
        """Run ``fn()`` with every count set to 0 just before it, add its
        launches to the phase's, and return (its result, its counts)."""
        reset_launches(*counters.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {k: (fn.launches, fn.resident_launches,
                      fn.per_step_launches) for k, fn in counters.items()}
        launches.update({k: c[0] for k, c in counts.items()})
        for k, (_, res, per) in counts.items():
            routes[k].update(resident=res, per_step=per)
        ran = {k: c for k, c in counts.items() if c[0]}
        print(f"phase 20 {what}: {secs:.2f} s; launches (all, resident, "
              f"per-step) {ran}")
        return out, counts

    print(f"phase 20 on {card_line()}")
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dataroot_"))
    out_dir = ROOT / "build" / "chip_smoke"
    try:
        t0 = time.perf_counter()
        segy = tmp / "marm751x2301.segy"
        write_segy_grid(str(segy), canonical_marmousi_vp(751, 2301))
        print(f"phase 20: canonical Marmousi 751 x 2301 written as SEG-Y in "
              f"{time.perf_counter() - t0:.2f} s ({segy.stat().st_size} "
              f"bytes)")

        # the acoustic tree through B1, then marmousi_acoustic from it
        ac = tmp / "marm_acoustic"
        _, n = path("prep --physics acoustic (151 x 200, 18 shots x 200 "
                    "receivers, nt 4001: train and test trees)",
                    lambda: prep.main(["--grid", str(segy), "--out", str(ac),
                                       "--physics", "acoustic"]))
        check(n["forward2"] == (3, 3, 0), f"acoustic prep: B1 {n['forward2']}"
              f" (want the direct wave, train and test, all resident)")
        files = sorted(str(p) for p in ac.glob("*/0.npy"))
        loader = native_loader.PrefetchNpyLoader(files, n_threads=2)
        same = [np.array_equal(a, np.load(f)) for a, f in zip(loader, files)]
        native = loader._h is not None
        loader.close()
        print(f"phase 20: native npy loader built {native_loader.native_available()}"
              f", taken {native}; {len(files)} files of the tree equal to "
              f"numpy's {all(same)}")
        check(native and len(same) == 6 and all(same),
              "the native npy loader was not built, taken or equal")
        cfg = get_workload("marmousi_acoustic", dataroot=str(ac),
                           save_dir=str(out_dir), name="dataroot_acoustic")
        (engine, hist), n = path(
            "marmousi_acoustic, 3 epochs from the acoustic tree",
            lambda: _train20(dev, "marmousi_acoustic", cfg, 3))
        check(n["fwi_l1_loss_grad"] == (3, 3, 0),
              f"marmousi_acoustic from disk: B2 {n['fwi_l1_loss_grad']}")
        twin = engine.val_wl
        check(twin is not None and twin.from_disk
              and not torch.equal(twin.vp_true, engine.wl.vp_true),
              "the validation twin is not the tree's test sample")
        (loss_true, _), _ = path(
            "marmousi_acoustic misfit at the true model",
            lambda: engine.physics_value_and_grad(engine.wl.vp_true))
        print(f"phase 20 marmousi_acoustic from disk: misfit at the true "
              f"model {float(loss_true):.3e} (tol 1e-6); twin loss_V_MSE "
              f"{hist[-1]['loss_V_MSE']:.6g}")
        check(float(loss_true) <= 1e-6, "acoustic misfit at the true model")

        # the elastic tree through the ring forward, then marmousi_elastic
        el = tmp / "marm_elastic"
        _, n = path("prep --physics elastic (100 x 300, 35 shots x 298 "
                    "receivers, nt 3334)",
                    lambda: prep.main(["--grid", str(segy), "--out", str(el),
                                       "--physics", "elastic", "--nz", "100",
                                       "--nx", "300"]))
        check(n["simulate_elastic_ring"] == (1, 1, 0),
              f"elastic prep: ring forward {n['simulate_elastic_ring']}")
        cfg = get_workload("marmousi_elastic", dataroot=str(el),
                           save_dir=str(out_dir), name="dataroot_elastic")
        (engine, _), n = path(
            f"marmousi_elastic, lstart {cfg.lstart} + 3 epochs from the "
            f"elastic tree",
            lambda: _train20(dev, "marmousi_elastic", cfg, cfg.lstart + 3))
        check(n["fused_elastic_loss_grad"] == (3, 3, 0)
              and n["simulate_elastic_ring"][0] == 0,
              f"marmousi_elastic from disk: B3 "
              f"{n['fused_elastic_loss_grad']}, ring forward "
              f"{n['simulate_elastic_ring']}")
        (loss_true, _), _ = path(
            "marmousi_elastic misfit at the true model (35 shots)",
            lambda: engine.physics_value_and_grad(
                engine.true_m, fc=0.0, rho=engine.wl.true["rho"]))
        print(f"phase 20 marmousi_elastic from disk: misfit at the true "
              f"model {float(loss_true):.3e} (tol 1e-9)")
        check(float(loss_true) <= 1e-9, "elastic misfit at the true model")

        # real_data: SU gathers from the ring forward, ingested, trained
        rcfg = get_workload("real_data", save_dir=str(out_dir))
        true, start = _real_data_model(rcfg)
        grid = Grid2D(nz=rcfg.nz, nx=rcfg.nx, dx=rcfg.dx, nt=rcfg.nt,
                      dt=rcfg.dt, pml_width=rcfg.pml_width,
                      free_surface=rcfg.free_surface)
        ecfg = ElasticConfig(grid=grid, chunk=rcfg.chunk, vmax_pml=5000.0)
        acq = elastic_line(rcfg.num_shots, rcfg.num_receivers, rcfg.nx,
                           rcfg.nz, src_row=rcfg.extras["src_depth_row"],
                           rcv_row=rcfg.extras["rcv_depth_row"])
        su = tmp / "su"
        su.mkdir()

        def write_gathers():
            geom = tuple(torch.as_tensor(a, dtype=torch.int32, device=dev)
                         for a in (acq.src_z, acq.src_x, acq.rcv_z,
                                   acq.rcv_x))
            vx, vz = simulate_elastic_ring(
                *(torch.as_tensor(a, device=dev) for a in true),
                ricker(rcfg.freq, rcfg.nt, rcfg.dt, device=dev), *geom, ecfg)
            for comp, gathers in (("x", vx), ("y", vz)):
                for k, gth in enumerate(gathers.cpu().numpy(), 1):
                    write_su_gather(su / f"seis_{comp}.su.shot{k}", gth.T,
                                    round(rcfg.dt * 1e6))

        _, n = path(f"real_data SU gathers ({rcfg.num_shots} shots x "
                    f"{rcfg.num_receivers} receivers, nt {rcfg.nt}, absorbing "
                    f"top) from the ring forward", write_gathers)
        check(n["simulate_elastic_ring"] == (1, 1, 0),
              f"real_data gathers: ring forward {n['simulate_elastic_ring']}"
              f" (want one resident launch)")
        rd = tmp / "real_data"
        (rd / "trainC").mkdir(parents=True)
        np.save(rd / "trainC" / "0.npy", np.stack(start) / 100.0)
        reads = native_su.native_reads
        path("prep --su-obs (no trainB: field data)",
             lambda: prep.main(["--su-obs", str(su), "--out", str(rd)]))
        reads = native_su.native_reads - reads
        print(f"phase 20: native SU reader built "
              f"{native_su.native_available()}, read {reads} of "
              f"{2 * rcfg.num_shots} files")
        check(reads == 2 * rcfg.num_shots, "the native SU reader was not "
              "taken")
        rcfg = rcfg.replace(dataroot=str(rd), name="dataroot_real_data")
        from physicsbasedfwi2_tpu_torch.engine.engines import create_engine
        b3_real, ring_real = _real_data_b3(
            dev, create_engine(rcfg, device=dev), true)
        (engine, hist), n = path(
            f"real_data, lstart {rcfg.lstart} + 3 epochs from the SU tree",
            lambda: _train20(dev, "real_data", rcfg, rcfg.lstart + 3))
        check(n["fused_elastic_loss_grad"] == (3, 3, 0),
              f"real_data: B3 {n['fused_elastic_loss_grad']} (want every "
              f"launch resident)")
        check(all(math.isfinite(r["loss_D_MSE"]) for r in hist),
              "real_data: a loss is not finite")

        # fwi-test and fwi-race from the trees
        res, _ = path("fwi-test --dataroot (marmousi_acoustic, latest)",
                      lambda: t_test.main([
                          "--workload", "marmousi_acoustic", "--name",
                          "dataroot_acoustic", "--save-dir", str(out_dir),
                          "--results-dir", str(tmp / "results"),
                          "--dataroot", str(ac)]))
        metrics = json.loads((tmp / "results" / "dataroot_acoustic"
                              / "epoch_latest" / "metrics.json").read_text())
        check(math.isfinite(metrics["loss_V_MSE"]), "fwi-test's metrics")
        path("fwi-race --dataroot (marmousi_elastic_robust, seeds 0 and 1, "
             "probes of 2 epochs, 3 in all)",
             lambda: race_main([
                 "--workload", "marmousi_elastic_robust", "--dataroot",
                 str(el), "--seeds", "0,1", "--probe-epochs", "2",
                 "--epochs", "3", "--save-dir", str(out_dir),
                 "--set", "lstart=1", "--set", "holdout_every=1",
                 "--set", "freq_stages=(2.5,)"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    routes = {k: dict(routes[k]) for k in launches if launches[k]}
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s; kernel launches "
          f"{dict(launches)}, by route {routes}")
    return launches, routes, b3_real, ring_real


# phase 21: the supervised baselines' registered configs, their epochs
# (the recipes run 100), CycleGAN's steps, the DIP runs of the new U-Nets
SUP_WORKLOADS = ("pix2pix_baseline", "unet_ssim_baseline", "pix2pix_bd",
                 "pix2pix_bde", "fno_baseline")
SUP_EPOCHS = 2
SUP_TRAIN, SUP_TEST = 64, 4   # patches a letter in trainA..E, testA..C
PATCH = 128                   # unet_128: the pix2pix U-Net's 128 x 128
CYCLE_STEPS = 10
DIP21_NETS = ("ASPP", "ResUNET", "UNet3Plus", "R2U", "R2AttU", "Multi")
DIP21_EPOCHS = 2
# the Marmousi Born run's time steps, cut from marmousi_acoustic's 4001:
# forward-mode AD runs ~10 ms a time step on the card (PERF.md §6, PR 17)
BORN_MARMOUSI_NT = 500


def _write_patches(root: Path) -> None:
    """Phase 21's dataroot: 128 x 128 float32 npy patches from numpy seed
    0, ``trainA`` .. ``trainE`` with 64 each and ``testA`` .. ``testC``
    with 4.  A is uniform in [0.1, 1), smoothed by a 5 x 5 box; each other
    letter is a fixed pointwise map of it (B = A^2, C = 1 - A, D =
    sqrt(A), E = 0.5 A + 0.3), so every pairing is learnable."""
    import numpy as np
    rng = np.random.default_rng(0)
    maps = {"A": lambda a: a, "B": lambda a: a * a, "C": lambda a: 1 - a,
            "D": np.sqrt, "E": lambda a: 0.5 * a + 0.3}
    for phase, letters, count in (("train", "ABCDE", SUP_TRAIN),
                                  ("test", "ABC", SUP_TEST)):
        for L in letters:
            (root / f"{phase}{L}").mkdir(parents=True)
        for i in range(count):
            a = rng.uniform(0.1, 1.0, (PATCH + 4, PATCH + 4))
            a = sum(a[dz:dz + PATCH, dx:dx + PATCH] for dz in range(5)
                    for dx in range(5)) / 25.0
            for L in letters:
                np.save(root / f"{phase}{L}" / f"{i:03d}.npy",
                        maps[L](a).astype(np.float32))


def _supervised21(dev, root: Path) -> None:
    """The five supervised workloads at their registered configs from
    ``root`` through ``train()`` (the card by default), every kernel
    counter 0; a checkpoint round trip and ``fwi-train`` once."""
    import torch
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.train import main as train_main
    from physicsbasedfwi2_tpu_torch.engine.train import train
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import reset_launches
    counters = _all_kernels()
    reset_launches(*counters.values())
    out_dir = ROOT / "build" / "chip_smoke"
    engines = {}
    for w in SUP_WORKLOADS:
        cfg = get_workload(w, dataroot=str(root), save_dir=str(out_dir))
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine, hist = train(cfg, epochs=SUP_EPOCHS, quiet=True)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        check(engine.device == dev, f"{w}: engine on {engine.device}")
        for rec in hist:
            print("epoch", json.dumps(rec))
            for k, v in rec.items():
                check(math.isfinite(v), f"{w} epoch {rec['epoch']}: {k}={v}")
        # the test twin holds A, B and C: pix2pix_bd/_bde (D targets) do
        # not validate
        check(("loss_V_L1" in hist[-1]) == (w not in ("pix2pix_bd",
                                                       "pix2pix_bde")),
              f"{w}: validation {sorted(hist[-1])}")
        n_w = sum(p.numel() for p in engine.net.parameters())
        n_in = next(m for m in engine.net.modules()
                    if isinstance(m, torch.nn.Conv2d)).in_channels
        d_w = (sum(p.numel() for p in engine.disc.parameters())
               if engine.use_gan else 0)
        steps = SUP_TRAIN // cfg.batch_size
        secs = ", ".join(f"{r['epoch_time']:.3f}" for r in hist)
        ms = min(r["epoch_time"] for r in hist) / steps * 1e3
        val = [f"{r['loss_V_L1']:.5f}" for r in hist if "loss_V_L1" in r]
        print(f"phase 21 {w}: {cfg.netG} ({type(engine.net).__name__}, "
              f"{n_w} weights; discriminator {d_w}), input channels "
              f"{n_in}, batch {cfg.batch_size}, {steps} "
              f"steps an epoch; {total:.2f} s in all (engine setup "
              f"included), epochs {secs} s ({ms:.2f} ms a step in the "
              f"fastest); loss_G {[round(r['loss_G'], 5) for r in hist]}"
              + (f", loss_D {[round(r['loss_D'], 5) for r in hist]}"
                 if engine.use_gan else "")
              + f"; loss_V_L1 {val or 'none (no test twin)'}; peak memory "
              f"{peak:.3f} GiB")
        engines[w] = engine
    ran = {k: fn.launches for k, fn in counters.items() if fn.launches}
    check(not ran, f"supervised workloads launched kernels: {ran}")
    # a checkpoint round trip on the card, to the bit
    engine = engines["pix2pix_baseline"]
    before = {k: v.clone() for k, v in engine.net.state_dict().items()}
    path = engine.save_networks("chip_smoke_rt")
    with torch.no_grad():
        for p in engine.net.parameters():
            p.add_(1.0)
    engine.load_networks("chip_smoke_rt")
    same = all(torch.equal(v, before[k])
               for k, v in engine.net.state_dict().items())
    print(f"phase 21 pix2pix_baseline save_networks/load_networks "
          f"({Path(path).name}, {Path(path).stat().st_size} bytes, the "
          f"generator alone): torch.equal {same}")
    check(same, "supervised checkpoint round trip")
    t0 = time.perf_counter()
    train_main(["--workload", "fno_baseline", "--dataroot", str(root),
                "--epochs", "1", "--name", "chip_smoke_fwi_train",
                "--save-dir", str(out_dir)])
    ck = out_dir / "chip_smoke_fwi_train" / "latest_net_G.npz"
    print(f"phase 21 fwi-train --workload fno_baseline --dataroot (1 epoch "
          f"on the card): {time.perf_counter() - t0:.2f} s; {ck.name} "
          f"written {ck.exists()}")
    check(ck.exists(), "fwi-train wrote no checkpoint")


def _cyclegan21(dev, root: Path) -> None:
    """CycleGAN at the upstream widths (ngf 64, resnet_9blocks) on the
    phase's 128 x 128 A and B patches: ``CYCLE_STEPS`` steps timed."""
    import numpy as np
    import torch
    from physicsbasedfwi2_tpu_torch.engine.cyclegan import CycleGanEngine
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = CycleGanEngine(base=64, n_blocks=9, in_shape=(PATCH, PATCH))
    check(eng.device == dev, f"CycleGAN on {eng.device}")
    setup = time.perf_counter() - t0

    def patch(letter, i):
        return torch.from_numpy(np.load(
            root / f"train{letter}" / f"{i:03d}.npy"))[None, :, :, None]

    secs, recs = [], []
    for i in range(CYCLE_STEPS):
        a, b = patch("A", i), patch("B", i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        recs.append(eng.optimize_parameters(a, b))   # syncs on the losses
        secs.append(time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    out = eng.translate(patch("A", 0))
    n_w = sum(p.numel() for net in (eng.G, eng.F, eng.DA, eng.DB)
              for p in net.parameters())
    print(f"phase 21 CycleGAN (ngf 64, resnet_9blocks, 2-layer PatchGANs, "
          f"{n_w} weights) at {PATCH} x {PATCH}: setup {setup:.2f} s; "
          f"{CYCLE_STEPS} steps, ms a step {[round(1e3 * x, 2) for x in secs]}"
          f" (median of the last {CYCLE_STEPS - 1}: "
          f"{1e3 * _median(secs[1:]):.2f}); loss_G "
          f"{[round(r['loss_G'], 4) for r in recs]}, loss_D "
          f"{[round(r['loss_D'], 4) for r in recs]}; peak memory "
          f"{peak:.3f} GiB; pools hold {len(eng.pool_A.images)} and "
          f"{len(eng.pool_B.images)} images")
    check(all(math.isfinite(v) for r in recs for v in r.values()),
          "CycleGAN losses not finite")
    check(tuple(out.shape) == (1, PATCH, PATCH, 1)
          and bool(torch.isfinite(out).all()), "CycleGAN translate")


def _dip21(dev):
    """The supervised family's U-Nets as acoustic DIP generators at full
    width on phase 18's shared workload.  Returns their launches."""
    import collections
    wl, twin = _shared_acoustic(dev, 21)
    launches = collections.Counter()
    for netg in DIP21_NETS:
        engine, _, n = _acoustic_run(dev, wl, twin, "marmousi_acoustic",
                                     DIP21_EPOCHS, phase=21, netG=netg)
        launches.update(n)
        _unet_net_timing(engine, f"phase 21 {netg}")
        del engine
    return launches


def _determinism21(dev) -> None:
    """Weight gradients of UNet3Plus and MultiScaleUNet at
    ``marmousi_acoustic``'s [1, 4001, 200, 18], and of ResnetGenerator
    (resnet_9blocks) and FNO2d at the supervised 128 x 128 x 1, each
    taken twice on the same inputs and held to ``torch.equal``; the ops
    the deterministic-algorithms check names on them."""
    import torch
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    ac = get_workload("marmousi_acoustic")
    ac_in = (ac.nt, ac.num_receivers, ac.num_shots)
    img = (PATCH, PATCH, 1)
    nets = {
        "UNet3Plus": _weight_grads(dev, ac.replace(netG="UNet3Plus"), ac_in),
        "MultiScaleUNet": _weight_grads(dev, ac.replace(netG="Multi"),
                                        ac_in),
        "ResnetGenerator": _weight_grads(
            dev, get_workload("pix2pix_baseline", netG="resnet_9blocks"),
            img),
        "FNO2d": _weight_grads(dev, get_workload("fno_baseline"), img)}
    named = _nondeterministic_ops(lambda: [g() for _, g in nets.values()])
    print(f"phase 21 ops named by torch.use_deterministic_algorithms(True, "
          f"warn_only=True) on the four nets' forward + backward: "
          f"{named or 'none'}")
    for name, (net, grads) in nets.items():
        a, b = grads(), grads()
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        print(f"phase 21 {name}: {len(a)} weight gradients taken twice on "
              f"the same inputs, torch.equal: {same}")
        check(same, f"{name}: the weight gradients do not repeat")
        net.zero_grad(set_to_none=True)


def _born21(dev) -> None:
    """``born_acoustic`` on the card against a central difference of
    ``simulate_acoustic`` at the JAX test's case (40 x 50, nt 250, 2
    shots) and timed; one call timed at the Marmousi grid (151 x 200, 2
    shots, nt ``BORN_MARMOUSI_NT``); ``born_elastic`` once at a small
    shape."""
    import numpy as np
    import torch
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.geo import Grid2D, ricker, surface_line
    from physicsbasedfwi2_tpu_torch.ops import (
        AcousticConfig, simulate_acoustic)
    from physicsbasedfwi2_tpu_torch.ops.born import (
        born_acoustic, born_elastic)
    from physicsbasedfwi2_tpu_torch.ops.elastic import (
        ElasticConfig, simulate_elastic)

    def case(nz, nx, nt, dx, dt, pml, vmax, rows, ns=2):
        grid = Grid2D(nz=nz, nx=nx, dx=dx, nt=nt, dt=dt, pml_width=pml)
        cfg = AcousticConfig(grid=grid, chunk=25, vmax_pml=vmax)
        acq = surface_line(ns, nx // ns, nx, src_depth=2, rcv_depth=2)
        geom = [torch.as_tensor(np.asarray(a), device=dev)
                for a in (acq.src_z, acq.src_x, acq.rcv_z, acq.rcv_x)]
        wav = ricker(10.0, nt, dt).to(dev)
        vp = torch.full((nz, nx), 1800.0, device=dev)
        dvp = torch.zeros_like(vp)
        dvp[rows] = 1.0
        return vp, dvp, wav, geom, cfg

    vp, dvp, wav, geom, cfg = case(40, 50, 250, 10.0, 0.002, 14, 2500.0,
                                   (slice(22, 28), slice(20, 35)))
    (bg, scat), ms = timed_ms(lambda: born_acoustic(vp, dvp, wav, *geom,
                                                    cfg), repeats=1)
    eps = 2.0
    with torch.no_grad():
        plain = simulate_acoustic(vp, wav, *geom, cfg)
        fd = (simulate_acoustic(vp + eps * dvp, wav, *geom, cfg)
              - simulate_acoustic(vp - eps * dvp, wav, *geom, cfg)) / (
            2 * eps)
    err = float((fd - scat).abs().max() / scat.abs().max())
    bg_err = float((bg - plain).abs().max() / plain.abs().max())
    print(f"phase 21 born_acoustic (40 x 50, nt 250, 2 shots x "
          f"{geom[2].shape[1]} receivers, on {scat.device}): {ms:.1f} ms a "
          f"call; scattered against a central difference (eps 2 m/s) "
          f"{err:.3e} of max (tol 0.05); background against "
          f"simulate_acoustic {bg_err:.3e} of max (tol 1e-5)")
    check(scat.is_cuda and err < 0.05 and bg_err <= 1e-5,
          "born_acoustic on the card")
    base = get_workload("marmousi_acoustic")
    vp, dvp, wav, geom, cfg = case(
        base.nz, base.nx, BORN_MARMOUSI_NT, base.dx, base.dt,
        base.pml_width, 5000.0, (slice(20, 40), slice(80, 120)))
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, scat = born_acoustic(vp, dvp, wav, *geom, cfg)   # one call
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"phase 21 born_acoustic at the Marmousi grid ({base.nz} x "
          f"{base.nx}, dx {base.dx:g} m, nt {BORN_MARMOUSI_NT} of "
          f"{base.nt}, 2 shots x "
          f"{geom[2].shape[1]} receivers): {ms:.1f} ms a call "
          f"({1e3 * ms / BORN_MARMOUSI_NT:.1f} us a time step); peak memory "
          f"{peak:.3f} GiB; scattered max {float(scat.abs().max()):.3e}")
    check(bool(torch.isfinite(scat).all()) and float(scat.abs().max()) > 0,
          "born_acoustic at the Marmousi grid")
    grid = Grid2D(nz=36, nx=48, dx=15.0, nt=64, dt=0.0015, pml_width=8,
                  free_surface=False)
    ecfg = ElasticConfig(grid=grid, chunk=16, vmax_pml=4000.0)
    vp = torch.full((36, 48), 2500.0, device=dev)
    vs, rho = vp / 1.8, torch.full_like(vp, 2000.0)
    dvp, dvs = torch.zeros_like(vp), torch.zeros_like(vp)
    dvp[18:24, 16:32] = 50.0
    dvs[20:26, 12:30] = 20.0
    geom = [torch.as_tensor(a, device=dev) for a in (
        np.array([5, 5], np.int32), np.array([10, 30], np.int32),
        np.full((2, 10), 5, np.int32),
        np.tile(np.linspace(3, 44, 10, dtype=np.int32), (2, 1)))]
    ewav = ricker(12.0, 64, 0.0015).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (bx, bz), (sx, sz) = born_elastic(vp, vs, rho, dvp, dvs, ewav, *geom,
                                      ecfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    with torch.no_grad():
        px, _ = simulate_elastic(vp, vs, rho, ewav, *geom, ecfg)
    e_bg = float((bx - px).abs().max() / px.abs().max())
    print(f"phase 21 born_elastic (36 x 48, nt 64, 2 shots x 10 receivers): "
          f"{secs:.2f} s; background vx against simulate_elastic {e_bg:.3e} "
          f"of max; scattered max vx {float(sx.abs().max()):.3e}, vz "
          f"{float(sz.abs().max()):.3e}")
    check(e_bg <= 1e-5 and bool(torch.isfinite(sx).all())
          and float(sx.abs().max()) > 0, "born_elastic on the card")


def phase_supervised(dev):
    """The supervised/GAN family (see the module docstring, phase 21).
    Returns the DIP runs' kernel launches."""
    import shutil
    import tempfile
    print(f"phase 21 on {card_line()}")
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_patches_"))
    try:
        t0 = time.perf_counter()
        _write_patches(tmp)
        print(f"phase 21: dataroot of {PATCH} x {PATCH} float32 patches "
              f"(train A-E x {SUP_TRAIN}, test A-C x {SUP_TEST}) written in "
              f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        _supervised21(dev, tmp)
        print(f"phase 21: supervised workloads {time.perf_counter() - t0:.1f}"
              f" s")
        t0 = time.perf_counter()
        _cyclegan21(dev, tmp)
        print(f"phase 21: CycleGAN {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    launches = _dip21(dev)
    print(f"phase 21: DIP runs {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _determinism21(dev)
    print(f"phase 21: determinism {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _born21(dev)
    print(f"phase 21: Born {time.perf_counter() - t0:.1f} s")
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s; kernel launches "
          f"{dict(launches)}")
    return launches


# phase 22's depth cuts: the Hessian's time loop (of the registered
# 4001 and 3334 steps; the acoustic cut stays above the water layer's
# two-way time, ~410 steps, under which the generator, whose water rows
# are pinned, moves no recorded sample; the elastic line lies below the
# water), and the closure scan's steps in the graph-replay comparison
HESS_NT_AC = 450
HESS_NT2_AC = 675  # the second cut, for the memory a time step adds
HESS_NT_EL = 100
HVP_CD_EPS = 1e-7  # the central difference's step along a unit v, float64
HVP_CD_EPS_M = 1e-3  # the same in model space (m/s along a unit v)
HVP_CD_TOL = 1e-4  # its relative L2 error against the float64 HVP
TRAJ_TAGS = (10, 20, 30, 40)


def _surface22(engine, out: Path, name: str, *extra: str):
    """A 3 x 3 surface on [-0.3, 0.3]^2 through the landscape CLI's
    ``main`` on ``engine`` (with ``--vtp``): (result, seconds, losses,
    npz arrays); checks the losses finite and the .vtp's counts."""
    import xml.etree.ElementTree as ET
    import numpy as np
    import torch
    from physicsbasedfwi2_tpu_torch.landscape import cli
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cli.main(["--workload", engine.cfg.name, "--x=-0.3:0.3:3",
                    "--y=-0.3:0.3:3", "--vtp", "--out", str(out), "--name",
                    name, *extra], engine=engine)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    with np.load(out / f"{name}_surface.npz") as z:
        arrays = {k: z[k] for k in z.files}
    surf = arrays["losses"]
    check(surf.shape == (3, 3) and bool(np.isfinite(surf).all()),
          f"{name}: losses {surf}")
    piece = ET.parse(out / f"{name}_surface.vtp").getroot().find(
        "PolyData/Piece")
    check(int(piece.get("NumberOfPoints")) == 9
          and int(piece.get("NumberOfPolys")) == 4,
          f"{name}: .vtp has {piece.get('NumberOfPoints')} points and "
          f"{piece.get('NumberOfPolys')} quads")
    return res, secs, surf, arrays


def _center22(engine, surf, what: str) -> None:
    """The surface's centre against a direct evaluation of the physics
    loss at the unperturbed weights, timed."""
    import torch
    from physicsbasedfwi2_tpu_torch.landscape import cli
    decode, misfit, data = cli.physics_loss(engine)
    params = {k: w.detach() for k, w in engine.net.named_parameters()}
    with torch.no_grad():
        direct, ms = timed_ms(lambda: misfit(decode(params, data), data),
                              repeats=1)
    direct = float(direct)
    print(f"phase 22 {what}: centre {surf[1, 1]!r} against a direct "
          f"evaluation {direct!r}; one point (decode + misfit) {ms:.1f} ms")
    check(abs(float(surf[1, 1]) - direct) <= 1e-6 * abs(direct),
          f"{what}: the centre is not the loss at the weights")


def _replay22(dev, engine) -> None:
    """``simulate_acoustic`` without autograd at the workload's full
    grid, shots and nt (the workload build's call): the
    explicit-parameter scan replayed as CUDA graphs against the closure
    scan's loop, in turns (graphs, loop, loop, graphs), to the bit."""
    import torch
    from physicsbasedfwi2_tpu_torch.ops import acoustic
    wl = engine.wl
    args = (wl.vp_true, wl.wavelet, *wl.geom, wl.cfg)
    secs = {True: [], False: []}
    outs = {}
    with torch.no_grad():
        for explicit in (True, False, False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[explicit] = acoustic._simulate(*args, explicit=explicit)
            torch.cuda.synchronize()
            secs[explicit].append(time.perf_counter() - t0)
    same = torch.equal(outs[True], outs[False])
    print(f"phase 22 simulate_acoustic without autograd ({wl.cfg.grid.nz}x"
          f"{wl.cfg.grid.nx}, {int(wl.geom[0].shape[0])} shots, nt "
          f"{wl.cfg.grid.nt}), in turns: CUDA-graph chunks "
          f"{', '.join(f'{t:.3f}' for t in secs[True])} s, closure scan "
          f"{', '.join(f'{t:.3f}' for t in secs[False])} s; torch.equal "
          f"{same}")
    check(same, "the graph replay differs from the loop")


def _cut22(engine, nt: int):
    """``cli.physics_loss(engine, differentiable=True)`` with the
    misfit's time loop cut to its first ``nt`` steps (a depth cut): the
    wavelet and observed gathers cut, the acoustic ones normalized again
    over the cut; the generator still reads the full gathers."""
    import dataclasses
    import torch
    from physicsbasedfwi2_tpu_torch.landscape import cli
    from physicsbasedfwi2_tpu_torch.ops import (
        simulate_acoustic, trace_normalize)
    from physicsbasedfwi2_tpu_torch.ops.elastic_fused import (
        simulate_elastic_ring_plain)
    decode, _, data = cli.physics_loss(engine, differentiable=True)
    wl = engine.wl
    cfg = dataclasses.replace(wl.cfg, grid=dataclasses.replace(wl.cfg.grid,
                                                               nt=nt))
    if engine.cfg.engine == "elastic_dip":
        idx = torch.arange(engine.cfg.shots_per_iter or engine.cfg.num_shots,
                           device=engine.device)
        pd = data["phys"]
        data = dict(data, phys={"wav": pd["wav"][..., :nt],
                                "ovx": pd["ovx"][:, :nt],
                                "ovz": pd["ovz"][:, :nt]})

        def misfit(m, d):
            return engine._physics_loss_raw(
                m, idx, d["phys"],
                sim=lambda *a: simulate_elastic_ring_plain(*a[:-1], cfg))
    else:
        data = dict(data, obs_norm=trace_normalize(wl.obs[:, :nt]))

        def misfit(vp, d):
            pred = simulate_acoustic(vp, wl.wavelet[..., :nt], *wl.geom, cfg)
            return torch.mean((trace_normalize(pred) - d["obs_norm"]) ** 2)
    return decode, misfit, data


def _hessian22(dev, engine, nt: int, steps: int, what: str,
               model_space: bool = False, nt2: int | None = None) -> None:
    """Lanczos (``steps`` HVPs) on ``engine``'s physics loss in float64,
    its time loop cut to ``nt`` steps at the full grid, shots and
    generator (:func:`_cut22`), through the composite HVP, each HVP
    timed with its peak memory; with ``nt2`` one more HVP at that cut,
    whose peak against the first's gives the memory a time step adds;
    then an HVP held against a central difference of two float64
    gradients along the same unit vector: Lanczos's first, or with
    ``model_space`` the misfit's alone along a unit vector in model
    space at the decoded model (a step along a unit v crosses some of
    the elastic generator's leaky-ReLU kinks at every step a float64
    difference resolves: ROADMAP Queue C)."""
    import torch
    from physicsbasedfwi2_tpu_torch.landscape import (
        composite_hvp, lanczos_extreme_eigs)
    f64 = torch.float64
    params = {k: w.detach().to(f64) for k, w in engine.net.named_parameters()}

    def cut(n):
        decode, misfit, data = _cut22(engine, n)
        data = {k: (v.to(f64) if torch.is_tensor(v) else v)
                for k, v in data.items()}
        return (lambda q: decode(q, data)), (lambda m: misfit(m, data))

    dec, mis = cut(nt)

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated(dev) / 2**30)

    calls = []

    def hvp_fn(p, v):
        out, secs, peak = timed(lambda: composite_hvp(dec, mis, p, v))
        calls.append((v, out, secs, peak))
        return out

    (lo, hi, ritz), s_l, _ = timed(lambda: lanczos_extreme_eigs(
        None, params, steps=steps, hvp_fn=hvp_fn,
        generator=torch.Generator(device=dev).manual_seed(0)))
    secs = [c[2] for c in calls]
    mean = sum(secs) / len(secs)
    label = (engine.cfg.misfit if engine.cfg.engine == "elastic_dip"
             else "trace-normalized l2")
    print(f"phase 22 {what} Hessian ({label} misfit, nt {nt} of "
          f"{engine.cfg.nt}, float64): Lanczos steps {steps}: eig_min "
          f"{lo!r}, eig_max {hi!r} in {s_l:.2f} s; composite HVPs "
          f"{', '.join(f'{s:.2f}' for s in secs)} s, peaks "
          f"{', '.join(f'{c[3]:.4f}' for c in calls)} GiB; at the full nt "
          f"{engine.cfg.nt} ~{mean * engine.cfg.nt / nt:.0f} s an HVP "
          f"(extrapolated linearly in nt from {mean:.2f} s at {nt})")
    check(len(calls) == steps and math.isfinite(hi) and math.isfinite(lo),
          f"{what}: {len(calls)} HVPs, Ritz values {ritz}")
    if nt2 is not None:
        dec2, mis2 = cut(nt2)
        _, s2, peak2 = timed(lambda: composite_hvp(dec2, mis2, params,
                                                   calls[0][0]))
        peak = calls[0][3]
        per_step = (peak2 - peak) / (nt2 - nt)
        full = peak + per_step * (engine.cfg.nt - nt)
        s_full = s2 * engine.cfg.nt / nt2
        print(f"phase 22 {what}: a composite HVP at nt {nt2} {s2:.2f} s, "
              f"peak {peak2:.4f} GiB against {peak:.4f} GiB at nt {nt}: "
              f"{per_step * 2**10:.3f} MiB a time step; at the full nt "
              f"{engine.cfg.nt} ~{full:.1f} GiB and ~{s_full:.0f} s an HVP "
              f"(extrapolated linearly in nt)")
        check(full < 80.0, f"{what}: the HVP would not fit the card at the "
              f"full nt")

    v, hv = calls[0][0], calls[0][1]
    loss, at, eps = (lambda q: mis(dec(q))), params, HVP_CD_EPS
    if model_space:
        eps = HVP_CD_EPS_M
        with torch.no_grad():
            at = {"m": dec(params)}
        gen = torch.Generator(device=dev).manual_seed(22)
        v = {"m": torch.randn(at["m"].shape, generator=gen, device=dev,
                              dtype=f64)}
        v["m"] /= torch.linalg.vector_norm(v["m"])
        loss = (lambda q: mis(q["m"]))
        hv, s_hvp, peak = timed(lambda: composite_hvp(
            lambda q: q["m"], mis, at, v))
        print(f"phase 22 {what}: the misfit's HVP in model space "
              f"{s_hvp:.2f} s, peak {peak:.2f} GiB")

    def grad(sign):
        with torch.enable_grad():
            q = {k: (w + sign * eps * v[k]).requires_grad_()
                 for k, w in at.items()}
            gs = torch.autograd.grad(loss(q), list(q.values()),
                                     allow_unused=True)
        return {k: torch.zeros_like(w) if g is None else g
                for (k, w), g in zip(q.items(), gs)}

    (gp, gm), s_cd, _ = timed(lambda: (grad(1.0), grad(-1.0)))
    num = sum(torch.sum((hv[k] - (gp[k] - gm[k]) / (2 * eps)) ** 2)
              for k in hv)
    den = sum(torch.sum(h * h) for h in hv.values())
    err = float(torch.sqrt(num / den))
    print(f"phase 22 {what}: the "
          f"{'model-space' if model_space else 'first'} HVP (|Hv| "
          f"{float(torch.sqrt(den)):.4e}) against a central difference of "
          f"two gradients (eps "
          f"{eps:g} along its unit v; {s_cd:.2f} s): relative L2 "
          f"error {err:.3e} (tol {HVP_CD_TOL:g})")
    check(float(den) > 0 and err <= HVP_CD_TOL,
          f"{what}: the HVP is not the central difference")


def phase_landscape(dev):
    """The landscape CLI on the card (see the module docstring, phase
    22).  Returns its kernel launches."""
    import collections
    import dataclasses
    import shutil
    import tempfile
    import numpy as np
    import torch
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.engines import (
        AcousticDIPEngine, ElasticDIPEngine)
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import reset_launches
    print(f"phase 22 on {card_line()}")
    t_phase = time.perf_counter()
    counters = _all_kernels()
    b1, ring = counters["forward2"], counters["simulate_elastic_ring"]
    launches = collections.Counter()

    def take(*names):
        """The launches of ``names`` since the last take (every other
        kernel's must be 0), then every count set to 0."""
        got = {k: counters[k].launches for k in counters}
        check(all(v == 0 for k, v in got.items() if k not in names),
              f"phase 22: a kernel off the landscape's path ran: {got}")
        reset_launches(*counters.values())
        return {k: got[k] for k in names}

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_landscape_"))
    try:
        # the acoustic surface, on phase 18's shared workload
        wl, twin = _shared_acoustic(dev, 22)
        cfg = get_workload("marmousi_acoustic", save_dir=str(tmp))
        reset_launches(*counters.values())
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        ac = AcousticDIPEngine(cfg, workload=dataclasses.replace(wl),
                               val_workload=twin, device=dev)
        setup = time.perf_counter() - t0
        res, secs, surf, _ = _surface22(ac, tmp, "acoustic")
        resident = b1.resident_launches
        n = take("forward2")
        launches.update(n)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"phase 22 marmousi_acoustic surface: {res}; setup {setup:.2f} "
              f"s, 9 points in {secs:.2f} s ({secs / 9 * 1e3:.0f} ms a "
              f"point, main's whole call), peak memory {peak:.2f} GiB; "
              f"launches {n} (B1 resident {resident})")
        check(n["forward2"] == resident == 2,
              "B1 not resident twice at the acoustic setup")
        _center22(ac, surf, "marmousi_acoustic")
        _replay22(dev, ac)

        # the elastic surface and the trajectory
        cfg = get_workload("marmousi_elastic", save_dir=str(tmp))
        reset_launches(*counters.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        el = ElasticDIPEngine(cfg, device=dev)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        check(el.physics_path == "fused-cuda",
              f"elastic physics path {el.physics_path}")
        resident = ring.resident_launches
        n = take("simulate_elastic_ring")
        launches.update(n)
        print(f"phase 22 marmousi_elastic setup {setup:.2f} s; ring forward "
              f"{n} (resident {resident})")
        torch.cuda.reset_peak_memory_stats(dev)
        res, secs, surf, _ = _surface22(el, tmp, "elastic")
        resident, per_step = ring.resident_launches, ring.per_step_launches
        n = take("simulate_elastic_ring")
        launches.update(n)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"phase 22 marmousi_elastic surface: {res}; 9 points in "
              f"{secs:.2f} s ({secs / 9 * 1e3:.0f} ms a point, main's whole "
              f"call), peak memory {peak:.2f} GiB; ring forward {n} "
              f"(resident {resident}, per-step {per_step})")
        check(n["simulate_elastic_ring"] == resident == 9 and per_step == 0,
              "the elastic surface's ring forwards not 9 resident")
        # (the direct evaluation's ring forward is not on the path)
        _center22(el, surf, "marmousi_elastic")

        base = {k: w.detach().clone() for k, w in el.net.state_dict().items()}
        for i, tag in enumerate(TRAJ_TAGS):
            el.net.load_state_dict({k: w * (1.0 + 0.02 * i) + 0.001 * i
                                    for k, w in base.items()})
            el.save_networks(tag)
        el.net.load_state_dict(base)
        reset_launches(*counters.values())
        res, secs, _, arrays = _surface22(
            el, tmp, "trajectory", "--trajectory", str(tmp / cfg.name))
        resident = ring.resident_launches
        n = take("simulate_elastic_ring")
        launches.update(n)
        coords, epochs = arrays["traj_coords"], arrays["traj_epochs"]
        print(f"phase 22 marmousi_elastic trajectory: {res} in {secs:.2f} s; "
              f"coordinates {coords.tolist()}, epochs {epochs.tolist()}; "
              f"ring forward {n}")
        check(coords.shape == (4, 2) and list(epochs) == list(TRAJ_TAGS)
              and bool(np.abs(coords[-1]).max() <= 1e-3),
              "the trajectory's last coordinate or epochs")
        check(n["simulate_elastic_ring"] == resident == 9,
              "the trajectory's ring forwards not 9 resident")

        # the Hessians (plain PyTorch through the differentiable loops)
        reset_launches(*counters.values())
        t0 = time.perf_counter()
        _hessian22(dev, ac, HESS_NT_AC, 2, "marmousi_acoustic",
                   nt2=HESS_NT2_AC)
        print(f"phase 22 marmousi_acoustic Hessian: "
              f"{time.perf_counter() - t0:.1f} s")
        take()
        # the raw L2 misfit for the central difference: the registered
        # tnl1's kinks (|r|, the trace max) put jumps in the gradient
        el_l2 = ElasticDIPEngine(cfg.replace(misfit="l2"),
                                 workload=el.wl, device=dev)
        launches.update(take("simulate_elastic_ring"))
        t0 = time.perf_counter()
        _hessian22(dev, el_l2, HESS_NT_EL, 2, "marmousi_elastic",
                   model_space=True)
        print(f"phase 22 marmousi_elastic Hessian: "
              f"{time.perf_counter() - t0:.1f} s")
        take()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 22: {time.perf_counter() - t_phase:.1f} s; kernel launches "
          f"{dict(launches)}")
    return launches


# phase 23: parallel/ on torch.distributed (see the module docstring)
MESH_EPOCHS = 3
MESH_EL_LSTART = 2     # marmousi_elastic's 30 warmup epochs, cut
MESH_FIRST_RTOL = 1e-5  # run B's first step against run A's
MESH_DRIFT_RTOL = 1e-5  # run B's later epochs against run A's
MESH_KERNELS = ("forward2", "fwi_l1_loss_grad", "fused_elastic_loss_grad",
                "simulate_elastic_ring")


def _mesh_take(what: str) -> dict:
    """B1's, B2's, B3's and the ring forward's (launches, resident,
    per-step) since the last take (every other kernel's must be 0), then
    every count set to 0."""
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import reset_launches
    ks = _all_kernels()
    got = {k: [f.launches, f.resident_launches, f.per_step_launches]
           for k, f in ks.items()}
    check(all(v[0] == 0 for k, v in got.items() if k not in MESH_KERNELS),
          f"phase 23 {what}: a kernel off the path ran: {got}")
    reset_launches(*ks.values())
    return {k: got[k] for k in MESH_KERNELS if got[k][0]}


def _mesh_decode(engine):
    """The acoustic engine's velocity model at its current weights (the
    generator only, no kernel)."""
    import torch
    from physicsbasedfwi2_tpu_torch.models import (
        apply_generator, apply_velocity_output)
    with torch.no_grad():
        out = apply_generator(engine.net, engine.shots_in)
        vp = apply_velocity_output(out.field, engine.true_b,
                                   water_vel=engine.cfg.water_vel)
    return vp[0, :, :, 0]


def _mesh_weights(net):
    import torch
    return torch.cat([p.detach().flatten() for p in net.parameters()])


def _mesh_write(out: str, run: str, rank: int, rec: dict, **arrays) -> None:
    import numpy as np
    with open(Path(out) / f"{run}{rank}.json", "w") as f:
        json.dump(rec, f)
    if arrays:
        np.savez(Path(out) / f"{run}{rank}.npz", **arrays)


def _mesh_a(out: str) -> None:
    """Run A on its one rank (NCCL, ``cuda:0``): ``train()`` of
    ``marmousi_acoustic`` with a mesh against the same without one, then
    ``marmousi_elastic`` with a mesh."""
    import torch
    import torch.distributed as dist
    from physicsbasedfwi2_tpu_torch.device import default_device
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.engines import (
        AcousticDIPEngine, ElasticDIPEngine)
    from physicsbasedfwi2_tpu_torch.engine.train import train
    from physicsbasedfwi2_tpu_torch.parallel import make_mesh
    t_run = time.perf_counter()
    mesh = make_mesh()
    dev = mesh.device
    check(dev == torch.device("cuda", 0) and default_device() == dev
          and dist.get_backend() == "nccl", f"run A: {mesh}")
    cfg = get_workload("marmousi_acoustic", save_dir=f"{out}/a_plain")
    plain_engine, plain = train(cfg, epochs=MESH_EPOCHS, quiet=True,
                                device=dev)
    _mesh_take("run A's engine without a mesh")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg = cfg.replace(save_dir=f"{out}/a_mesh")
    engine = AcousticDIPEngine(cfg, mesh=mesh)
    vp0 = _mesh_decode(engine)
    engine, hist = train(cfg, engine=engine, epochs=MESH_EPOCHS, quiet=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ac = _mesh_take("run A acoustic")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check(engine.physics_path == "fused+mesh",
          f"run A: physics path {engine.physics_path}")
    check(ac.get("fwi_l1_loss_grad") == [MESH_EPOCHS] * 2 + [0],
          f"run A: B2 not resident once an epoch: {ac}")
    check(ac.get("forward2") == [2, 2, 0],
          f"run A: B1 not resident for obs and direct wave: {ac}")
    losses = [r["loss_D"] for r in hist]
    check(losses == [r["loss_D"] for r in plain],
          f"run A: losses {losses} differ from the engine without a mesh "
          f"{[r['loss_D'] for r in plain]}")
    check(torch.equal(_mesh_weights(engine.net),
                      _mesh_weights(plain_engine.net)),
          "run A: the final weights differ from the engine without a mesh's")
    del plain_engine
    # the first step's pair, for run B (outside the counted window)
    l0, g0 = engine.physics_value_and_grad(vp0)
    _mesh_take("run A's first-step pair")
    # the elastic engine, its warmup cut to MESH_EL_LSTART epochs
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg_el = get_workload("marmousi_elastic", lstart=MESH_EL_LSTART,
                          save_dir=f"{out}/a_el")
    el = ElasticDIPEngine(cfg_el, mesh=mesh)
    el, el_hist = train(cfg_el, engine=el, epochs=MESH_EL_LSTART + 3,
                        quiet=True)
    torch.cuda.synchronize()
    el_secs = time.perf_counter() - t0
    el_counts = _mesh_take("run A elastic")
    el_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check(el.physics_path == "fused+mesh",
          f"run A elastic: physics path {el.physics_path}")
    check(el_counts.get("fused_elastic_loss_grad") == [3, 3, 0],
          f"run A: B3 not resident once a physics epoch: {el_counts}")
    ring = el_counts.get("simulate_elastic_ring", [0, 0, 0])
    check(ring[0] >= 1 and ring[2] == 0,
          f"run A: the setup's ring forward not resident: {el_counts}")
    el_losses = [r["loss_D_MSE"] for r in el_hist[MESH_EL_LSTART:]]
    check(all(math.isfinite(x) for x in el_losses)
          and len(set(el_losses)) > 1, f"run A elastic losses {el_losses}")
    _mesh_write(out, "a", 0, {
        "losses": losses, "secs": secs, "peak_gib": peak, "acoustic": ac,
        "elastic": el_counts, "el_losses": el_losses, "el_secs": el_secs,
        "el_peak_gib": el_peak, "epoch_s": [r["epoch_time"] for r in hist],
        "run_s": time.perf_counter() - t_run},
        l0=l0.cpu().numpy(), g0=g0.cpu().numpy())


HALO_TOL = 1e-4  # of max: float32 sums in another order (JAX's own 1.3e-5)


def _mesh_halo(mesh) -> dict:
    """``simulate_acoustic_dd``'s value and gradient on the ranks of
    ``mesh`` at the halo tests' size (32 x 88, PML 16, nt 160, 2 shots;
    the padded width 120 in 60-column slabs): the loss ``sum(rec * w)``
    (w from numpy seed 4), its backward timed, every rank's dJ/dvp and
    dJ/dwavelet equal to the bit, and all three held to one rank's
    ``simulate_acoustic`` under autograd on the card."""
    import numpy as np
    import torch
    from physicsbasedfwi2_tpu_torch.geo import Grid2D, ricker
    from physicsbasedfwi2_tpu_torch.ops import (
        AcousticConfig, simulate_acoustic)
    from physicsbasedfwi2_tpu_torch.parallel import (
        all_gather, simulate_acoustic_dd)
    dev = mesh.device
    cfg = AcousticConfig(grid=Grid2D(nz=32, nx=88, dx=10.0, nt=160,
                                     dt=0.002, pml_width=16),
                         chunk=20, vmax_pml=2500.0)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    geom = (i32([4, 4]), i32([20, 60]), i32(np.full((2, 10), 3)),
            i32(np.tile(np.arange(10) * 8 + 4, (2, 1))))
    vp0 = torch.full((32, 88), 1800.0, device=dev)
    vp0[16:] = 2200.0
    wav0 = ricker(10.0, 160, 0.002, device=dev)
    w = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (2, 160, 10)).astype(np.float32), device=dev)

    def grads(fn):
        vp, wav = (a.clone().requires_grad_() for a in (vp0, wav0))
        rec = fn(vp, wav)
        (rec * w).sum().backward()
        return rec.detach(), vp.grad, wav.grad

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = grads(lambda v, a: simulate_acoustic_dd(v, a, *geom, cfg, mesh))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for g in got[1:]:
        every = all_gather(g[None], mesh)
        check(all(torch.equal(every[0], e) for e in every[1:]),
              "run B halo: the ranks' gradients differ")
    ref = grads(lambda v, a: simulate_acoustic(v, a, *geom, cfg))
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(got, ref)]
    check(max(errs) <= HALO_TOL, f"run B halo: value and gradient against "
          f"one rank's simulate_acoustic {errs}")
    return {"secs": secs, "rel_errs": errs}


def _mesh_b(out: str) -> None:
    """Run B on each of two ranks sharing the card (gloo): the acoustic
    engine at full width with 9 shots a rank, every rank's weights equal
    after each step; the dry run's four layouts; the elastic surface,
    sharded."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.engines import (
        AcousticDIPEngine, ElasticDIPEngine)
    from physicsbasedfwi2_tpu_torch.landscape import (
        loss_surface_2d, loss_surface_2d_sharded, output_axes)
    from physicsbasedfwi2_tpu_torch.landscape.cli import physics_loss
    from physicsbasedfwi2_tpu_torch.parallel import (
        all_gather, dryrun, make_mesh)
    t_run = time.perf_counter()
    mesh = make_mesh()
    dev, rank = mesh.device, mesh.rank
    check(dev == torch.device("cuda", 0) and dist.get_backend() == "gloo",
          f"run B: {mesh}")
    rec = {}
    _mesh_take("run B start")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg = get_workload("marmousi_acoustic", save_dir=f"{out}/b{rank}")
    engine = AcousticDIPEngine(cfg, mesh=mesh)
    vp0 = _mesh_decode(engine)
    losses, epoch_s = [], []
    for epoch in range(1, MESH_EPOCHS + 1):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses.append(engine.optimize_parameters(epoch)["loss_D"])
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t1)
        w = all_gather(_mesh_weights(engine.net)[None], mesh)
        check(torch.equal(w[0], w[1]),
              f"run B: the ranks' weights differ after epoch {epoch}")
    torch.cuda.synchronize()
    rec.update(secs=time.perf_counter() - t0, losses=losses, epoch_s=epoch_s,
               acoustic=_mesh_take("run B acoustic"),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    check(engine.physics_path == "fused+mesh",
          f"run B: physics path {engine.physics_path}")
    check(rec["acoustic"].get("fwi_l1_loss_grad") == [MESH_EPOCHS] * 2
          + [0], f"run B: B2 not resident once an epoch: {rec}")
    l0, g0 = engine.physics_value_and_grad(vp0)
    _mesh_take("run B's first-step pair")
    # the dry run's four layouts at world 2
    t0 = time.perf_counter()
    rec["dryrun"] = [dryrun.run(2), dryrun.run_mesh2d(2),
                     dryrun.run_domain_decomp(2),
                     dryrun.run_elastic_engine(2, save_dir=f"{out}/b_dry")]
    torch.cuda.synchronize()
    rec.update(dryrun_s=time.perf_counter() - t0,
               dryrun_counts=_mesh_take("run B dry run"))
    rec.update(halo=_mesh_halo(mesh), halo_counts=_mesh_take("run B halo"))
    # the elastic landscape engine's surface, 3 x 3 points over 2 ranks
    t0 = time.perf_counter()
    el = ElasticDIPEngine(get_workload("marmousi_elastic",
                                       save_dir=f"{out}/b_el"), device=dev)
    setup = _mesh_take("run B elastic setup")
    decode, misfit, data = physics_loss(el)

    def loss_fn(p, d):
        return misfit(decode(p, d), d)

    params = {k: w.detach() for k, w in el.net.named_parameters()}
    xs = np.linspace(-0.3, 0.3, 3)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    surf, d1, d2 = loss_surface_2d_sharded(
        loss_fn, params, mesh, xs=xs, ys=xs, data=data,
        out_axes=output_axes(el.net))
    torch.cuda.synchronize()
    rec.update(surface_s=time.perf_counter() - t1,
               el_setup_s=t1 - t0, el_setup=setup,
               surface=_mesh_take("run B surface"), surf=surf.tolist())
    ring = rec["surface"].get("simulate_elastic_ring", [0, 0, 0])
    check(ring == [5, 5, 0],
          f"run B: the ring forwards of 5 points not resident: {ring}")
    if rank == 0:
        one, _, _ = loss_surface_2d(loss_fn, params, d1=d1, d2=d2, xs=xs,
                                    ys=xs, data=data)
        _mesh_take("run B one-rank surface")
        rec["surf_rel_err"] = float(np.abs(surf - one).max()
                                    / np.abs(one).max())
        check(bool(np.isfinite(surf).all())
              and rec["surf_rel_err"] <= 1e-6,
              f"run B: sharded surface against one rank's "
              f"{rec['surf_rel_err']:.3e}")
    rec["run_s"] = time.perf_counter() - t_run
    rec["run_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    _mesh_write(out, "b", rank, rec, l0=l0.cpu().numpy(),
                g0=g0.cpu().numpy())


def phase_mesh(dev):
    """``parallel/`` on the card (see the module docstring, phase 23):
    run A on one NCCL rank, run B on two gloo ranks sharing the card,
    each a child process of its own.  Returns the launches of B1, B2, B3
    and the ring forward on the runs' paths."""
    import collections
    import shutil
    import tempfile
    import numpy as np
    import torch
    from physicsbasedfwi2_tpu_torch.parallel.dryrun import spawn
    card = card_line()
    print(f"phase 23 on {card}")
    t_phase = time.perf_counter()
    launches = collections.Counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    try:
        t0 = time.perf_counter()
        spawn(_mesh_a, 1, str(tmp), device="cuda", backend="nccl",
              store_dir=str(tmp))
        secs_a = time.perf_counter() - t0
        a = json.loads((tmp / "a0.json").read_text())
        pa = np.load(tmp / "a0.npz")
        print(f"phase 23 run A (1 rank, NCCL, cuda:0; {card}): "
              f"{secs_a:.1f} s with the process; marmousi_acoustic "
              f"fused+mesh {MESH_EPOCHS} epochs in {a['secs']:.2f} s "
              f"(setup included; epochs "
              f"{', '.join(f'{x:.4f}' for x in a['epoch_s'])} s), loss_D "
              f"{a['losses']} (the engine without a mesh's, to the bit, "
              f"and its final weights), launches (all, resident, per-step) "
              f"{a['acoustic']}, peak memory {a['peak_gib']:.2f} GiB; "
              f"marmousi_elastic fused+mesh lstart {MESH_EL_LSTART} + 3 "
              f"epochs in {a['el_secs']:.2f} s, loss_D_MSE "
              f"{a['el_losses']}, launches {a['elastic']}, peak memory "
              f"{a['el_peak_gib']:.2f} GiB")
        for k, v in (*a["acoustic"].items(), *a["elastic"].items()):
            launches[k] += v[0]
        t0 = time.perf_counter()
        spawn(_mesh_b, 2, str(tmp), device="cuda", backend="gloo",
              store_dir=str(tmp))
        secs_b = time.perf_counter() - t0
        bs = [json.loads((tmp / f"b{r}.json").read_text()) for r in (0, 1)]
        pb = np.load(tmp / "b0.npz")
        for r, b in enumerate(bs):
            print(f"phase 23 run B rank {r} (2 ranks, gloo, cuda:0; "
                  f"{card}): marmousi_acoustic fused+mesh, 9 shots a rank, "
                  f"{MESH_EPOCHS} epochs in {b['secs']:.2f} s (setup "
                  f"included; steps "
                  f"{', '.join(f'{x:.4f}' for x in b['epoch_s'])} s), "
                  f"loss_D {b['losses']}, launches "
                  f"{b['acoustic']}, peak memory {b['peak_gib']:.2f} GiB; "
                  f"dry run (loss, 2-D loss, energy, elastic loss) "
                  f"{b['dryrun']} in {b['dryrun_s']:.2f} s, launches "
                  f"{b['dryrun_counts']}; the halo decomposition's value "
                  f"and gradient (32 x 88, nt 160, 2 shots) "
                  f"{b['halo']['secs']:.2f} s, rec, dJ/dvp, dJ/dwavelet "
                  f"against one rank's simulate_acoustic "
                  f"{', '.join(f'{e:.3e}' for e in b['halo']['rel_errs'])} "
                  f"of max (tol {HALO_TOL:g}), launches "
                  f"{b['halo_counts']}; elastic setup "
                  f"{b['el_setup_s']:.2f} s ({b['el_setup']}), sharded "
                  f"surface {b['surface_s']:.2f} s ({b['surface']}); "
                  f"{b['run_s']:.1f} s in the rank, peak memory "
                  f"{b['run_peak_gib']:.2f} GiB")
            for part in ("acoustic", "dryrun_counts", "el_setup", "surface"):
                for k, v in b[part].items():
                    launches[k] += v[0]
        b0 = bs[0]
        check(bs[1]["losses"] == b0["losses"] and bs[1]["surf"] == b0["surf"],
              "run B: the ranks' losses or surfaces differ")
        first = abs(b0["losses"][0] - a["losses"][0]) / abs(a["losses"][0])
        g_err = float(np.linalg.norm(pb["g0"] - pa["g0"])
                      / np.linalg.norm(pa["g0"]))
        l_err = float(abs(pb["l0"] - pa["l0"]) / abs(pa["l0"]))
        drift = [abs(x - y) / abs(y) for x, y in zip(b0["losses"][1:],
                                                      a["losses"][1:])]
        print(f"phase 23 run B against run A: first step loss_D rel err "
              f"{first:.3e}, its loss and dJ/dvp at the initial model rel "
              f"err {l_err:.3e} and rel L2 {g_err:.3e} (tol "
              f"{MESH_FIRST_RTOL:g}: the shots' sums in another order); "
              f"epochs 2-{MESH_EPOCHS} rel err {drift} (tol "
              f"{MESH_DRIFT_RTOL:g}: the shots' sums in another order, "
              f"carried through the Adam steps); sharded surface "
              f"{b0['surf']} against one rank's, max rel err "
              f"{b0['surf_rel_err']:.3e}; {secs_b:.1f} s with the "
              f"processes")
        check(max(first, l_err, g_err) <= MESH_FIRST_RTOL,
              "run B's first step against run A's")
        check(max(drift) <= MESH_DRIFT_RTOL,
              "run B's later epochs against run A's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 23: {time.perf_counter() - t_phase:.1f} s; kernel launches "
          f"{dict(launches)}")
    return launches


# phase 24: kernel B9 at benchmarks/bench_kernel_breakdown.py's
# measure_once case
B9_KC = 32
B9_REPS = 8  # the harness's --reps
B9_TOL = 1e-4  # of max, as B1's: FMA contraction and sum order differ


def phase_b9(dev):
    """Kernel B9 (``ops/kernel_breakdown.py::build_variant``) at its
    flagship shape: each cumulative variant (stencil, +src, +rcv, +ckpt)
    once through ``build_variant`` with every count 0 before (the path:
    4 resident launches, no other kernel); then each against its plain
    version (chk, final fields, history, checkpoints; ``B9_TOL`` of max),
    its kernel time (the ported harness's ``measure_once``: a first call,
    then ``B9_REPS`` chained ones; it times B2 (``fwi_l1_loss_grad``) on
    the same vp and wavelet as the ``full`` row, and raises where a
    result, B2's loss or any element of its gradient, is not finite;
    every call there resident) beside the plain version's (one call) and the
    bound, the delta to the previous variant, and the B9 instances'
    registers and spills (phase 1's ptxas report).  Returns (launches,
    the kernels line's fields)."""
    import argparse
    import torch
    from physicsbasedfwi2_tpu_torch.experiments.bench_kernel_breakdown \
        import case, measure_once
    from physicsbasedfwi2_tpu_torch.experiments.timing import (
        launch_counts, launches_since)
    from physicsbasedfwi2_tpu_torch.ops.kernel_breakdown import (
        VARIANTS, build_variant, build_variant_plain)
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import reset_launches
    card = card_line()
    t_phase = time.perf_counter()
    cfg, wav, vp, geom = case(NT, dev)
    g = cfg.grid
    ns = len(geom[0])

    def run(kw, fn=build_variant):
        return fn(vp, wav, *geom[:3], cfg, KC=B9_KC, **kw)

    ks = _all_kernels()
    reset_launches(*ks.values())
    path = {name: run(kw) for name, kw in VARIANTS}
    torch.cuda.synchronize()
    counts = {k: f.launches for k, f in ks.items()}
    print(f"phase 24 path: the four variants through build_variant, "
          f"launches {counts}")
    check(counts["build_variant"] == len(VARIANTS)
          and build_variant.resident_launches == len(VARIANTS)
          and sum(counts.values()) == len(VARIANTS),
          f"phase 24: B9 not resident once a variant, or another kernel "
          f"ran: {counts}")
    n_ck = -(-g.nt // B9_KC)
    steps = n_ck * B9_KC
    cells = ns * (g.nz + g.top_pad + g.pml_width) * (g.nx + 2 * g.pml_width)
    flops = FLOPS_B1 * cells * steps
    # the kernel times: the ported harness's pass (time_fn's chained
    # calls, B2 as the full row), its rows printed as it prints them;
    # every call on the resident route
    before = launch_counts()
    secs = measure_once(argparse.Namespace(kc=B9_KC, reps=B9_REPS,
                                           device=dev, card=card), g.nt)
    torch.cuda.synchronize()
    timed = launches_since(before)
    print(f"phase 24 measure_once: launches (all, resident, per-step) "
          f"{timed}")
    check(set(timed) == {"build_variant", "fwi_l1_loss_grad"}
          and all(c[0] == c[1] > 0 for c in timed.values()),
          f"phase 24: measure_once's B9 and B2 calls not all resident, or "
          f"another kernel ran: {timed}")
    rows, prev = {}, None
    for name, kw in VARIANTS:
        got = path[name]
        ref, ms_p = _plain_ms(lambda: run(kw, build_variant_plain))
        ref64 = run(dict(kw, dtype=torch.float64), build_variant_plain)
        ms_k = secs[name] * 1e3
        # the histories (rows, checkpoints) against the plain version at
        # B9_TOL of their max, as B1's rows; the final fields and chk
        # against the float64 run: they decay from the early wavefield
        # (the seed, the source's unit amplitude), so their error against
        # their own final max grows with the steps, in the plain float32
        # version too (~1e-3 of max at stencil): no farther off float64
        # than B9_TOL of its max or twice the plain float32 version
        errs, acc = {}, []
        for f in ("u0", "um1", "chk", "hist", "ckpt"):
            a, b, c = getattr(got, f), getattr(ref, f), getattr(ref64, f)
            if a is None:
                continue
            check(bool(torch.isfinite(a).all()), f"B9 {name}: {f} not finite")
            errs[f] = float((a - b).abs().max())
            if f in ("hist", "ckpt"):
                check(errs[f] <= B9_TOL * float(b.abs().max()),
                      f"B9 {name}: {f} disagrees with the plain version "
                      f"({errs[f]:.3e} of max {float(b.abs().max()):.3e})")
                continue
            top = float(c.abs().max()) if f != "chk" else float(
                ref64.u0[:, :8, :128].abs().sum())
            e_k = float((a.double() - c).abs().max()) / top
            e_p = float((b.double() - c).abs().max()) / top
            acc.append(f"{f} {e_k:.3e} (plain {e_p:.3e})")
            check(e_k <= max(2.0 * e_p, B9_TOL),
                  f"B9 {name}: {f} off the float64 run by {e_k:.3e} of "
                  f"max, the plain float32 version by {e_p:.3e}")
        # K, d+, d- ([192, 256] each), the wavelet and geometry in; the
        # final fields, chk and the variant's rows and checkpoints out
        io = (3 * nbytes(got.u0) // ns + nbytes(wav, *geom[:3])
              + nbytes(got.u0, got.um1, got.chk)
              + (nbytes(got.hist) if got.hist is not None else 0)
              + (nbytes(got.ckpt) if got.ckpt is not None else 0))
        b = bound(flops, io)
        rows[name] = {"ms": ms_k, "plain_ms": ms_p,
                      "max_abs_err": max(errs.values()),
                      "delta_ms": None if prev is None else ms_k - prev, **b}
        prev = ms_k
        print(f"B9 {name} [{ns} shots, {steps} steps, KC {B9_KC}; {card}]: "
              f"kernel {ms_k:.3f} ms ({ms_k / steps * 1e3:.3f} us a step), "
              f"plain {ms_p:.2f} ms, delta to the previous variant "
              + ("-" if rows[name]["delta_ms"] is None
                 else f"{rows[name]['delta_ms']:+.3f} ms")
              + f"; bound {b['bound_ms']:.3f} ms ({b['bound_by']}: "
              f"{flops:.3e} flop, {io / 1e9:.3f} GB); max|err| "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" against the plain version (rows, checkpoints: tol "
              f"{B9_TOL:g} of max); off the float64 run (of max; chk of its "
              f"terms' magnitudes): {', '.join(acc)} (tol the larger of "
              f"{B9_TOL:g} and twice the plain version's); chk "
              f"{float(got.chk[0, 0]):.6g}")
    log = BUILD_LOG[0] if BUILD_LOG else ""
    lines = ptxas_summary(log, ("b9_resident",))
    for line in lines or ["not in this run's build (the library existed)"]:
        print(f"  ptxas, B9: {line}")
    check(not log or len(lines) == 8, "phase 24: not every B9 instance in "
          "the ptxas report")
    ms_full = secs["full_fused"] * 1e3
    sweep = rows["stencil"]["ms"]
    print(f"B9 full (resident B2, {ns} shots, KC {B9_KC}; {card}): "
          f"{ms_full:.3f} ms; three stencil sweeps' projection "
          f"{sweep * (2 + 29 / 25):.3f} ms (JAX's: stencil x (1 + 1 + "
          f"29/25)); phase 24 {time.perf_counter() - t_phase:.1f} s")
    top = rows["+ckpt"]
    return len(VARIANTS), {
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": None, "ms_variant": "+ckpt", "variants": rows,
        "full_b2_ms": ms_full}


# phase 25: the experiment tools of benchmarks/ on the port
AVL_BUDGET = 70  # adam_vs_lbfgs's shot-gradients an arm (the tool's 7000)


def lbfgs_probe(engine):
    """Instrument an elastic L-BFGS engine (the "fast" path): each
    ``optimize_parameters`` step's value-and-gradient evaluations and its
    line search's outcome, and the seconds of every value and gradient
    (autograd through the sponge propagator).  Returns (evaluations by
    epoch, (loss_D, accepted value, step size, decrease error, curvature
    error) by epoch, the seconds), filled as the engine trains."""
    import torch
    evals, steps, vg_s = {}, {}, []
    step_fn = engine.optimize_parameters
    value_and_grad = engine._autograd_value_and_grad

    def timed_value_and_grad(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = value_and_grad(*args, **kw)
        torch.cuda.synchronize()
        vg_s.append(time.perf_counter() - t0)
        return out

    def logged(epoch, **kw):
        out = step_fn(epoch, **kw)
        st = engine.opt.state
        evals[epoch] = engine.opt.evaluations
        steps[epoch] = (out["loss_D_MSE"], float(st.value),
                        float(st.learning_rate),
                        float(st.info.decrease_error),
                        float(st.info.curvature_error))
        return out

    engine._autograd_value_and_grad = timed_value_and_grad
    engine.optimize_parameters = logged
    return evals, steps, vg_s


def phase_experiments(dev):
    """The experiment tools at full width (see the module docstring,
    phase 25).  Returns the launches by kernel."""
    import collections
    import shutil
    import tempfile
    import numpy as np
    import torch
    from physicsbasedfwi2_tpu_torch.data import marmousi, prep
    from physicsbasedfwi2_tpu_torch.engine.config import get_workload
    from physicsbasedfwi2_tpu_torch.engine.train import train
    from physicsbasedfwi2_tpu_torch.engine.engines import create_engine
    from physicsbasedfwi2_tpu_torch.experiments import (
        adam_vs_lbfgs, make_realdata_su, misfit_linescan)
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import reset_launches
    counters = _all_kernels()
    launches = collections.Counter()

    def path(what, fn):
        """Run ``fn()`` with every count set to 0 just before it, add its
        launches to the phase's, and return (its result, (all, resident,
        per-step) launches by kernel)."""
        reset_launches(*counters.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {k: (f.launches, f.resident_launches, f.per_step_launches)
                  for k, f in counters.items()}
        launches.update({k: c[0] for k, c in counts.items()})
        ran = {k: c for k, c in counts.items() if c[0]}
        print(f"phase 25 {what}: {secs:.2f} s; launches (all, resident, "
              f"per-step) {ran}")
        return out, collections.defaultdict(lambda: (0, 0, 0), ran)

    def finite(what, recs):
        for rec in recs:
            for k, v in rec.items():
                if isinstance(v, float):
                    check(math.isfinite(v), f"{what}: {k}={v} in {rec}")

    print(f"phase 25 on {card_line()}")
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_experiments_"))
    out_dir = ROOT / "build" / "chip_smoke"
    try:
        # make_realdata_su at real_data's shape, then a physics epoch on it
        rcfg = get_workload("real_data", save_dir=str(out_dir),
                            name="experiments_real_data")
        rd = tmp / "real_marine"
        rec, n = path(
            f"make_realdata_su ({rcfg.num_shots} shots x "
            f"{rcfg.num_receivers} receivers, {rcfg.nz} x {rcfg.nx}, nt "
            f"{rcfg.nt}: the split-PML scheme, plain PyTorch)",
            lambda: make_realdata_su.make_realdata_su(rcfg, str(rd),
                                                      device=dev))
        check(not n, f"make_realdata_su launched a kernel: {dict(n)}")
        shot1 = Path(rec["su_dir"]) / "seis_x.su.shot1"
        raw = np.frombuffer(shot1.read_bytes(), np.uint8)
        ntr = rcfg.num_receivers
        ns_hdr = int(raw[114:116].view("<u2")[0])
        dt_hdr = int(raw[116:118].view("<u2")[0])
        gathers = np.load(rd / "trainA" / "0.npy")
        print(f"phase 25 make_realdata_su: ingested {rec['shape']} at dt "
              f"{rec['dt']} s; SU headers ns {ns_hdr}, dt {dt_hdr} us, "
              f"{raw.size} bytes a shot file; |vx| max "
              f"{np.abs(gathers).max():.3e}")
        check(rec["shape"] == [rcfg.num_shots, rcfg.nt, ntr]
              and ns_hdr == rcfg.nt and dt_hdr == round(rcfg.dt * 1e6)
              and raw.size == ntr * (240 + 4 * rcfg.nt),
              "make_realdata_su's SU files")
        check(bool(np.isfinite(gathers).all()) and np.abs(gathers).max() > 0,
              "make_realdata_su's gathers")
        rcfg = rcfg.replace(dataroot=str(rd))
        (engine, hist), n = path(
            f"real_data from make_realdata_su's tree, lstart {rcfg.lstart} "
            f"+ 1 epochs", lambda: train(rcfg, epochs=rcfg.lstart + 1,
                                         quiet=True, device=dev))
        print("epoch", json.dumps(hist[-1]))
        check(engine.physics_path == "fused-cuda" and engine.wl.from_disk,
              f"real_data: path {engine.physics_path}")
        check(n["fused_elastic_loss_grad"] == (1, 1, 0),
              f"real_data: B3 {n['fused_elastic_loss_grad']} (want one "
              f"resident launch)")
        finite("real_data", hist)

        # misfit_linescan on the known-density Marmousi tree
        segy = tmp / "marm751x2301.segy"
        marmousi.main(["--out", str(segy)])
        kd = tmp / "marm_elastic_kd"
        _, n = path("prep --physics elastic --rho-start true (100 x 300, "
                    "35 shots, nt 3334)",
                    lambda: prep.main(["--grid", str(segy), "--physics",
                                       "elastic", "--rho-start", "true",
                                       "--nz", "100", "--nx", "300", "--out",
                                       str(kd)]))
        check(n["simulate_elastic_ring"] == (1, 1, 0),
              f"kd prep: ring forward {n['simulate_elastic_ring']}")
        runs = tmp / "runs"
        dcfg = get_workload("marmousi_elastic", dataroot=str(kd), lstart=1,
                            name="drift", save_dir=str(runs))
        _, n = path("marmousi_elastic from the kd tree, 2 epochs (lstart "
                    "1; path D's checkpoint)",
                    lambda: train(dcfg, epochs=2, quiet=True, device=dev))
        check(n["fused_elastic_loss_grad"] == (1, 1, 0),
              f"drift run: B3 {n['fused_elastic_loss_grad']}")
        lcfg = get_workload("marmousi_elastic", dataroot=str(kd))
        recs, n = path(
            f"misfit_linescan (35 shots, paths T and D, "
            f"{len(misfit_linescan.ALPHAS)} alphas each)",
            lambda: misfit_linescan.linescan(lcfg, drift_run=str(runs /
                                                                 "drift"),
                                             device=dev))
        for r in recs:
            print("phase 25 linescan", json.dumps(r))
        n_pts = 2 * len(misfit_linescan.ALPHAS)
        check(dict(n) == {"simulate_elastic_ring": (n_pts, n_pts, 0)},
              f"linescan: launches {dict(n)} (want {n_pts} resident ring "
              f"forwards and nothing else)")
        finite("linescan", recs)
        t_path = [r for r in recs if r.get("path") == "T(truth)"]
        # the truth ranks below the start (tnl2: the records are rounded
        # to 8 decimals, and the raw l2 of these gathers can round to 0;
        # not 0 at the truth: the tool band-limits the observed gathers
        # and the wavelet apart, which differs at the traces' ends)
        check(t_path[-1]["tnl2"] < t_path[0]["tnl2"],
              f"linescan: tnl2 {t_path[0]['tnl2']} at the start, "
              f"{t_path[-1]['tnl2']} at the truth")

        # adam_vs_lbfgs's elastic arms on the tool's synthetic workload
        # (no --dataroot) at the registered nt; the L-BFGS arm's physics
        # step is marmousi_elastic_lbfgs's first physics epoch

        def arm(workload, cfg):
            eng = create_engine(cfg, device=dev)
            probe = lbfgs_probe(eng) if cfg.optimizer == "lbfgs" else None
            return eng, probe, adam_vs_lbfgs.run_arm(workload, cfg,
                                                     AVL_BUDGET, engine=eng)

        results = []
        for workload, cfg in adam_vs_lbfgs.arm_configs(save_dir=str(out_dir)):
            torch.cuda.reset_peak_memory_stats(dev)
            (eng, probe, r), n = path(
                f"adam_vs_lbfgs {cfg.name} ({cfg.nz} x {cfg.nx}, nt {cfg.nt}, "
                f"{cfg.num_shots} shots; budget {AVL_BUDGET} shot-gradients; "
                f"the engine's setup included)",
                lambda: arm(workload, cfg))
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            print(json.dumps(r))
            print(f"phase 25 adam_vs_lbfgs {cfg.name}: physics path "
                  f"{eng.physics_path}; peak memory {peak:.2f} GiB")
            finite(cfg.name, [r])
            if cfg.optimizer == "adam":
                n_steps = -(-AVL_BUDGET // cfg.shots_per_iter)
                check((r["iterations"], r["budget_spent"])
                      == (n_steps, n_steps * cfg.shots_per_iter)
                      and n["fused_elastic_loss_grad"] == (n_steps,
                                                           n_steps, 0),
                      f"Adam arm: {r['iterations']} steps, "
                      f"{r['budget_spent']} spent, launches {dict(n)}")
            else:
                evals, steps, vg_s = probe
                probes = [evals[e] - 1 for e in sorted(evals)
                          if e > cfg.lstart]
                print(f"phase 25 adam_vs_lbfgs elastic_lbfgs: warmup "
                      f"evaluations "
                      f"{[evals[e] for e in sorted(evals) if e <= cfg.lstart]}"
                      f"; {len(vg_s)} 35-shot values and gradients "
                      f"{', '.join(f'{x:.3f}' for x in vg_s)} s (median "
                      f"{_median(vg_s):.3f}); line-search probes a step "
                      f"{probes}")
                check(eng.physics_path == "fast" and not n,
                      f"L-BFGS arm: path {eng.physics_path}, launched "
                      f"{dict(n)} (the fast path has no kernel)")
                check(r["budget_spent"] == eng.n_shots * sum(probes)
                      and len(probes) == r["iterations"],
                      "L-BFGS arm: the budget is not the shots times "
                      "the probes")
                check(len(vg_s) == sum(evals[e] for e in evals
                                       if e > cfg.lstart),
                      "not one autograd value and gradient an evaluation")
                for e in sorted(steps):
                    if e <= cfg.lstart:
                        continue
                    d0, d1, lr, dec, curv = steps[e]
                    print(f"phase 25 L-BFGS epoch {e}: loss_D {d0:.9g} -> "
                          f"accepted {d1:.9g} (step size {lr:.6g}; decrease "
                          f"error {dec:.3g}, curvature error {curv:.3g})")
                    # Armijo or the approximate (Hager-Zhang) test, which
                    # admits at most 1e-6 of the value
                    check(d1 <= d0 + 1e-6 * abs(d0) and lr > 0,
                          f"epoch {e}: the accepted step does not "
                          f"decrease the loss")
                d0, d1 = steps[max(steps)][:2]
                check(d1 < d0, f"L-BFGS: the loss does not fall: {d0} -> "
                      f"{d1}")
            results.append(r)
        print(json.dumps(adam_vs_lbfgs.summary(results, AVL_BUDGET)))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 25: {time.perf_counter() - t_phase:.1f} s; kernel launches "
          f"{dict(launches)}")
    return launches


# phase 26: the timing harnesses on the card at cut counts
HARNESS_EL_NT = 67  # bench_elastic's nt (its 3334 cut)


def _numbers(value):
    """Every number in a (nested) JSON value."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _numbers(v)
    elif isinstance(value, list):
        for v in value:
            yield from _numbers(v)


def host_syncs(fn) -> list[str]:
    """The host syncs one call of ``fn`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them (the first
    line of each warning; the mode's own notice that it is a prototype,
    which does not see every sync, left out)."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [m for m in (str(w.message).splitlines()[0] for w in caught)
            if not m.startswith("Synchronization debug mode is a prototype")]


def phase_harnesses(dev):
    """The timing harnesses through their ``main`` (see the module
    docstring, phase 26).  Returns the launches by kernel."""
    import collections
    import contextlib
    import io
    import torch
    from physicsbasedfwi2_tpu_torch.experiments import (
        bench, bench_configs, bench_elastic, bench_kernel_breakdown)
    from physicsbasedfwi2_tpu_torch.experiments.timing import (
        launch_counts, launches_since)
    from physicsbasedfwi2_tpu_torch.ops.scalar2 import reset_launches
    counters = _all_kernels()
    launches = collections.Counter()
    card = card_line()
    print(f"phase 26 on {card}")
    t_phase = time.perf_counter()

    def harness(what, main, argv, want):
        """Run ``main(argv)`` with every count 0 just before it; check its
        lines and that the kernels in ``want`` (and no other) launched,
        all resident.  Returns its JSON lines."""
        reset_launches(*counters.values())
        before = launch_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(out.getvalue(), end="")
        lines = [json.loads(s) for s in out.getvalue().splitlines()
                 if s.startswith("{")]
        ran = launches_since(before)
        launches.update({k: c[0] for k, c in ran.items()})
        print(f"phase 26 {what} {' '.join(argv)}: {secs:.1f} s, exit {rc}; "
              f"launches (all, resident, per-step) {ran}")
        check(rc == 0 and lines, f"{what}: exit {rc}, {len(lines)} lines")
        for ln in lines:
            check("error" not in ln, f"{what}: an error row: {ln}")
            check(ln.get("device") == card,
                  f"{what}: device {ln.get('device')!r}, not {card!r}")
            check(all(math.isfinite(v) for v in _numbers(ln)),
                  f"{what}: a number not finite: {ln}")
        check(set(ran) == set(want)
              and all(c[0] == c[1] for c in ran.values()),
              f"{what}: launches {ran}, want {sorted(want)} all resident")
        return lines

    lines = harness("bench", bench.main,
                    ["--iters", "1", "--engine-iters", "1"],
                    {"forward2", "fwi_l1_loss_grad", "simulate_elastic_ring",
                     "fused_elastic_loss_grad"})
    check([ln["path"] for ln in lines] == ["fused-resident"] * 4
          and all(ln["launches"] for ln in lines),
          f"bench: paths {[ln['path'] for ln in lines]}")
    for workload, want in (("marmousi_acoustic",
                            {"forward2", "fwi_l1_loss_grad"}),
                           ("mcdip_uq", {"simulate_elastic_ring",
                                         "fused_elastic_loss_grad"})):
        lines = harness("bench_configs", bench_configs.main,
                        ["--only", workload, "--iters", "1"], want)
        check(lines[0]["path"] == "fused-cuda",
              f"bench_configs {workload}: path {lines[0]['path']}")
    lines = harness("bench_elastic", bench_elastic.main,
                    ["--nt", str(HARNESS_EL_NT)], set())
    check(lines[0]["path"] == "pml", "bench_elastic: path")
    lines = harness("bench_kernel_breakdown", bench_kernel_breakdown.main,
                    [], {"build_variant", "fwi_l1_loss_grad"})
    check([ln.get("variant") for ln in lines[1:]] == [
        "stencil", "+src", "+rcv", "+ckpt", "full_fused"],
        "bench_kernel_breakdown: rows")

    # the host syncs inside one value and gradient of each kernel path
    # (a sync in the chain makes the host wait between iterations)
    ac = bench.build(device=dev)
    el = bench.build_elastic(device=dev)
    for what, vg, params in (
            ("pallas (B2)", bench.acoustic_value_and_grad("pallas", ac),
             (ac[4],)),
            ("fused (B3)", bench.elastic_value_and_grad("fused", el),
             (el[3], el[4]))):
        vg(*params)
        syncs = host_syncs(lambda: vg(*params))
        print(f"phase 26 host syncs in one {what} value and gradient "
              f"(as the sync debug mode sees them): {len(syncs)}"
              + "".join(f"\n  {m}" for m in syncs[:8]))
    print(f"phase 26: {time.perf_counter() - t_phase:.1f} s; kernel launches "
          f"{dict(launches)}")
    return launches


def main(argv: list[str]) -> int:
    import torch
    only = set()
    if argv[:1] == ["--only"] and len(argv) == 2:
        only = {int(k) for k in argv[1].split(",")}
    elif argv:
        print("usage: chip_smoke.py [--only N,N,...]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this smoke test runs "
              "only on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import physicsbasedfwi2_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    phase_card()
    if only:
        # a partial run (while developing): the phases asked for, no
        # kernels line and no result line
        phases = {2: [phase_b1], 3: [phase_b2], 4: [phase_b3],
                  5: [phase_slice], 6: [phase_slice2], 7: [phase_b4],
                  8: [phase_b56], 9: [phase_slice3], 10: [phase_xla_engine],
                  11: [phase_b7, phase_slice4_pairs], 12: [phase_b8],
                  13: [phase_b2_wavelet], 14: [phase_engine_paths],
                  15: [phase_robust], 16: [phase_lbfgs],
                  17: [phase_config5], 18: [phase_config2],
                  19: [phase_other_engines], 20: [phase_dataroot],
                  21: [phase_supervised], 22: [phase_landscape],
                  23: [phase_mesh], 24: [phase_b9],
                  25: [phase_experiments], 26: [phase_harnesses]}
        for k in sorted(only):
            for phase in phases[k]:
                phase(dev)
        print(f"chip_smoke: partial run of phases {sorted(only)} passed")
        return 0
    import collections
    t_lap = [time.perf_counter()]

    def lap(phase: str) -> None:
        """Print the seconds a phase took (the whole run's breakdown)."""
        now = time.perf_counter()
        print(f"chip_smoke: phase {phase} took {now - t_lap[0]:.1f} s")
        t_lap[0] = now

    b1 = phase_b1(dev)
    lap("2")
    b2 = phase_b2(dev)
    lap("3")
    b3, ring = phase_b3(dev)
    lap("4")
    # each path's launches, summed where two paths run a kernel
    launches = collections.Counter(phase_slice(dev))
    lap("5")
    launches.update(phase_slice2(dev))
    lap("6")
    b4a, b4b = phase_b4(dev)
    lap("7")
    b5, b6 = phase_b56(dev)
    lap("8")
    launches.update(phase_slice3(dev))
    lap("9")
    phase_xla_engine(dev)
    lap("10")
    b7a, b7b = phase_b7(dev)
    launches.update(phase_slice4_pairs(dev))
    lap("11")
    n_b8, b8 = phase_b8(dev)
    launches["elastic_forward_pallas"] += n_b8
    lap("12")
    b2["gwav_max_abs_err"] = phase_b2_wavelet(dev)
    lap("13")
    phase_engine_paths(dev)
    lap("14")
    launches.update(phase_robust(dev))
    lap("15")
    launches.update(phase_lbfgs(dev))
    lap("16")
    seam_launches, b3_seam, ring_seam = phase_config5(dev)
    launches.update(seam_launches)
    b3.update(b3_seam)
    ring.update(ring_seam)
    lap("17")
    launches.update(phase_config2(dev))
    lap("18")
    phase_other_engines(dev)
    lap("19")
    dataroot_launches, dataroot_routes, b3_real, ring_real = phase_dataroot(
        dev)
    launches.update(dataroot_launches)
    b3.update(b3_real)
    ring.update(ring_real)
    lap("20")
    launches.update(phase_supervised(dev))
    lap("21")
    launches.update(phase_landscape(dev))
    lap("22")
    launches.update(phase_mesh(dev))
    lap("23")
    n_b9, b9 = phase_b9(dev)
    launches["build_variant"] += n_b9
    lap("24")
    launches.update(phase_experiments(dev))
    lap("25")
    launches.update(phase_harnesses(dev))
    lap("26")
    # phase 20's launches of each kernel it ran, by route
    for name, fields in (("forward2", b1), ("fwi_l1_loss_grad", b2),
                         ("fused_elastic_loss_grad", b3),
                         ("simulate_elastic_ring", ring)):
        fields["dataroot_launches"] = dataroot_routes.get(name, {})
    kernels = [
        {"name": "forward2", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "physicsbasedfwi2_tpu/ops/pallas_scalar2.py:91",
         "launches": launches["forward2"], **b1},
        {"name": "fwi_l1_loss_grad", "route": "cuda",
         "source": KERNEL_SOURCE,
         "replaces": "physicsbasedfwi2_tpu/ops/pallas_fwi_fused.py:50",
         "launches": launches["fwi_l1_loss_grad"], **b2},
        {"name": "fused_elastic_loss_grad", "route": "cuda",
         "source": EL_SOURCE,
         "replaces": "physicsbasedfwi2_tpu/ops/pallas_elastic_fused.py:152",
         "launches": launches["fused_elastic_loss_grad"], **b3},
        # B3's forward sweep alone (the JAX package's _ring_scan)
        {"name": "simulate_elastic_ring", "route": "cuda",
         "source": EL_SOURCE,
         "replaces": "physicsbasedfwi2_tpu/ops/pallas_elastic_fused.py:595",
         "launches": launches["simulate_elastic_ring"], **ring},
        {"name": "forward2_ckpt", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "physicsbasedfwi2_tpu/ops/pallas_scalar2.py:119",
         "launches": launches["forward2_ckpt"], **b4a},
        {"name": "backward2", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "physicsbasedfwi2_tpu/ops/pallas_scalar2.py:158",
         "launches": launches["backward2"], **b4b},
        {"name": "acoustic_forward_pallas", "route": "cuda",
         "source": AC_SOURCE,
         "replaces": "physicsbasedfwi2_tpu/ops/pallas_kernels.py:69",
         "launches": launches["acoustic_forward_pallas"], **b5},
        {"name": "acoustic_pallas_backward", "route": "cuda",
         "source": AC_SOURCE,
         "replaces": "physicsbasedfwi2_tpu/ops/pallas_adjoint.py:51",
         "launches": launches["acoustic_pallas_backward"], **b6},
        {"name": "forward2b", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "physicsbasedfwi2_tpu/ops/pallas_scalar2b.py:35",
         "launches": launches["forward2b"], **b7a},
        {"name": "backward2b", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "physicsbasedfwi2_tpu/ops/pallas_scalar2b.py:105",
         "launches": launches["backward2b"], **b7b},
        # the ring forward's kernels with no free-surface row
        {"name": "elastic_forward_pallas", "route": "cuda",
         "source": EL_SOURCE,
         "replaces": "physicsbasedfwi2_tpu/ops/pallas_elastic.py:77",
         "launches": launches["elastic_forward_pallas"], **b8},
        # B2's forward sweep, its mechanisms switched on at compile time
        {"name": "build_variant", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "benchmarks/bench_kernel_breakdown.py:53",
         "launches": launches["build_variant"], **b9},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
