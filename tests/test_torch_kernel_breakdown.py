"""Kernel B9 (``ops/kernel_breakdown.py``): the plain version of each
variant of B2's forward sweep against the JAX package's
``benchmarks/bench_kernel_breakdown.py::build_variant`` (its Pallas kernel
in interpret mode) on the CPU.

JAX's ``build_variant`` returns ``chk[0, 0]`` only, which sees neither the
receiver rows nor the checkpoints, so a JAX-side loop built from
``physicsbasedfwi2_tpu.ops.pallas_scalar2``'s ``_prepare2`` and ``_lap``
with ``_variant_kernel``'s expressions (:func:`_jax_loop`) is first held
to ``build_variant``'s ``chk`` and then gives the history, the
checkpoints and the final fields the port is held to.  Inputs come from
numpy seeds.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu.geo import Grid2D as JGrid
from physicsbasedfwi2_tpu.ops import AcousticConfig as JAcoustic
from physicsbasedfwi2_tpu_torch.ops import cuda_build
from physicsbasedfwi2_tpu_torch.ops import kernel_breakdown as kb

from torch_parity import rel_max, torch_acoustic

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GRID = dict(nz=12, nx=40, dx=10.0, nt=40, dt=0.001, pml_width=4)
CFG = dict(chunk=8, vmax_pml=3500.0)
KC = 8
VARIANTS = [name for name, _ in kb.VARIANTS]


@pytest.fixture(scope="module")
def jbench():
    """``benchmarks/bench_kernel_breakdown.py``, imported from its file;
    the import points ``jax_compilation_cache_dir`` at the repository's
    ``.cache/jax`` for the whole process, so the previous setting is put
    back."""
    prev = jax.config.jax_compilation_cache_dir
    try:
        spec = importlib.util.spec_from_file_location(
            "bench_kernel_breakdown",
            ROOT / "benchmarks" / "bench_kernel_breakdown.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
    return mod


def _case(nt=GRID["nt"], seed=0):
    """vp = 1500 + 2000 U(0, 1) (numpy seed), a Ricker-like wavelet, 2
    shots on row 1 with their receivers on row 1."""
    rng = np.random.default_rng(seed)
    vp = (1500.0 + 2000.0 * rng.random((GRID["nz"], GRID["nx"]))).astype(
        np.float32)
    tt = (np.arange(nt) * GRID["dt"] - 0.02) * 60.0
    wav = ((1.0 - 2.0 * (np.pi * tt) ** 2)
           * np.exp(-(np.pi * tt) ** 2)).astype(np.float32)
    src_z = np.array([1, 1], np.int32)
    src_x = np.array([5, 30], np.int32)
    rcv_z = np.ones((2, 40), np.int32)
    return vp, wav, src_z, src_x, rcv_z


def _grid(nt):
    return dict(GRID, nt=nt)


def _jax_loop(vp, wav, src_z, src_x, rcv_z, grid, KC, with_src, with_rcv,
              with_ckpt):
    """``_variant_kernel``'s sweep in plain JAX (jitted: ``_lap``'s rolls
    have no eager rule): per shot the final (u0, u_-1), the history
    [nt, nx128], the checkpoints [n_ck, 2, nz8, nx128] and
    sum(u0[:8, :128]); ``chk`` the sums added in shot order."""
    from physicsbasedfwi2_tpu.ops.pallas_scalar2 import _lap, _prepare2
    jcfg = JAcoustic(grid=JGrid(**grid), **CFG)
    g = jcfg.grid
    K, dp, dm = _prepare2(jnp.asarray(vp), jcfg)[:3]
    nt = g.nt
    n_ck = -(-nt // KC)
    pml = g.pml_width
    top = 0 if g.free_surface else pml
    ns = len(src_z)
    wav_sm = jnp.pad(jnp.broadcast_to(jnp.asarray(wav)[None], (ns, nt)),
                     ((0, 0), (0, n_ck * KC - nt)))

    @jax.jit
    def one(wrow, sz, sx, rrow):
        col = jnp.arange(K.shape[1])
        onehot = (col == sx).astype(jnp.float32)
        u0, um1 = K * 1e-3, jnp.zeros_like(K)
        hist, ck = [], []
        for c in range(n_ck):
            ck.append(jnp.stack([u0, um1]))
            for kk in range(KC):
                t = c * KC + kk
                u1 = dp * (2.0 * u0 - dm * um1 + K * _lap(u0))
                um1, u0 = u0, u1
                if with_src:
                    u0 = u0.at[sz].set(u0[sz] + wrow[t] * onehot)
                if with_rcv and t < nt:
                    hist.append(u0[rrow])
        return (u0, um1, jnp.stack(hist) if hist else None, jnp.stack(ck),
                jnp.sum(u0[:8, :128]))

    outs = [one(wav_sm[s], src_z[s] + top, src_x[s] + pml, rcv_z[s, 0] + top)
            for s in range(ns)]
    chk = jnp.float32(0.0)
    for o in outs:
        chk = chk + o[4]
    stack = (lambda i: np.stack([np.asarray(o[i]) for o in outs])
             if outs[0][i] is not None else None)
    u0 = stack(0)
    return dict(u0=u0, um1=stack(1), hist=stack(2), ckpt=stack(3),
                chk=float(chk), chk_scale=float(np.abs(u0[:, :8, :128]).sum()))


def _port(case, grid, **kw):
    vp, wav, src_z, src_x, rcv_z = case
    return kb.build_variant(torch.as_tensor(vp), torch.as_tensor(wav),
                            torch.as_tensor(src_z), torch.as_tensor(src_x),
                            torch.as_tensor(rcv_z),
                            torch_acoustic(grid, CFG), KC=KC, **kw)


@pytest.mark.parametrize("nt", [40, 37])
@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_matches_jax(jbench, variant, nt):
    """Each variant at 12 x 40 (PML 4; 24 x 128 padded), 2 shots, KC 8;
    at nt 37 the sweep runs 40 padded steps.  ``chk``: JAX's
    ``build_variant`` (interpret mode) against the JAX loop and against
    the port's plain version, each to 1e-6 of the sum of the 2 x 1024
    terms' magnitudes (float32 sums in another order; the terms cancel,
    so a tolerance relative to ``chk`` itself would measure the
    cancellation: 1.2e-6 and 2.8e-6 of ``chk`` at +src); the port's final fields, history and checkpoints against the
    JAX loop's to 1e-5 of max (FMA contraction and sum order differ
    between XLA and PyTorch on the CPU, over 40 steps)."""
    kw = dict(kb.VARIANTS)[variant]
    grid = _grid(nt)
    case = _case(nt)
    vp, wav, src_z, src_x, rcv_z = case
    jcfg = JAcoustic(grid=JGrid(**grid), **CFG)
    run = jbench.build_variant(jnp.asarray(vp), jnp.asarray(wav),
                               jnp.asarray(src_z), jnp.asarray(src_x),
                               jnp.asarray(rcv_z), jcfg, KC=KC,
                               interpret=True, **kw)
    chk_j = float(run(jnp.float32(1.0)))
    ref = _jax_loop(*case, grid, KC, kw.get("with_src", False),
                    kw.get("with_rcv", False), kw.get("with_ckpt", False))
    tol = 1e-6 * ref["chk_scale"]
    assert abs(ref["chk"] - chk_j) <= tol
    got = _port(case, grid, **kw)
    assert got.chk.shape == (8, 128)
    assert float(got.chk.abs().sum()) == abs(float(got.chk[0, 0]))
    assert abs(float(got.chk[0, 0]) - chk_j) <= tol
    assert rel_max(got.u0, ref["u0"]) <= 1e-5
    assert rel_max(got.um1, ref["um1"]) <= 1e-5
    if kw.get("with_rcv"):
        assert got.hist.shape == (2, nt, 128)
        assert rel_max(got.hist, ref["hist"]) <= 1e-5
    else:
        assert got.hist is None
    if kw.get("with_ckpt"):
        assert got.ckpt.shape == (2, 5, 2, 24, 128)
        assert rel_max(got.ckpt, ref["ckpt"]) <= 1e-5
    else:
        assert got.ckpt is None


def test_padded_steps_equal_a_zero_padded_wavelet():
    """At nt 37 and KC 8 the sweep runs 40 steps: the final fields equal
    those of nt 40 with the wavelet zero past 37, and the history keeps 37
    rows, equal to that run's first 37."""
    case = _case(37)
    kw = dict(with_src=True, with_rcv=True, with_ckpt=True)
    short = _port(case, _grid(37), **kw)
    wav40 = np.concatenate([case[1], np.zeros(3, np.float32)])
    full = _port((case[0], wav40, *case[2:]), _grid(40), **kw)
    for a, b in ((short.u0, full.u0), (short.um1, full.um1),
                 (short.ckpt, full.ckpt), (short.chk, full.chk)):
        assert torch.equal(a, b)
    assert short.hist.shape[1] == 37
    assert torch.equal(short.hist, full.hist[:, :37])


def test_source_adds_the_raw_amplitude():
    """One step (nt 1, KC 1): +src differs from stencil only at each
    shot's source cell, by the wavelet's first sample itself (no K
    factor, no d+)."""
    case = _case(1)
    grid = _grid(1)
    vp, wav, src_z, src_x, rcv_z = case
    wav = np.array([0.75], np.float32)
    args = (torch.as_tensor(vp), torch.as_tensor(wav), torch.as_tensor(src_z),
            torch.as_tensor(src_x), torch.as_tensor(rcv_z),
            torch_acoustic(grid, CFG))
    base = kb.build_variant(*args, KC=1)
    src = kb.build_variant(*args, KC=1, with_src=True)
    d = src.u0 - base.u0
    top = pml = GRID["pml_width"]
    for s in range(2):
        cell = (s, int(src_z[s]) + top, int(src_x[s]) + pml)
        assert float(d[cell]) == pytest.approx(0.75, rel=1e-6)
        d[cell] = 0.0
    assert float(d.abs().max()) == 0.0
    assert torch.equal(src.um1, base.um1)


def test_cpu_call_never_reaches_the_entry_point(monkeypatch):
    """On CPU tensors (and on numpy inputs with ``device="cpu"``) the plain
    version runs: the library is neither built nor called, and no launch
    is counted.  Without a device and a card, numpy inputs raise."""
    def refuse(*a, **k):
        raise AssertionError("the C entry point was reached")

    monkeypatch.setattr(cuda_build, "call", refuse)
    monkeypatch.setattr(cuda_build, "load_library", refuse)
    before = kb.build_variant.launches
    vp, wav, src_z, src_x, rcv_z = _case(16)
    cfg = torch_acoustic(_grid(16), CFG)
    a = kb.build_variant(torch.as_tensor(vp), torch.as_tensor(wav),
                         torch.as_tensor(src_z), torch.as_tensor(src_x),
                         torch.as_tensor(rcv_z), cfg, KC=KC, with_src=True)
    b = kb.build_variant(vp, wav, src_z, src_x, rcv_z, cfg, KC=KC,
                         with_src=True, device="cpu")
    assert torch.equal(a.chk, b.chk) and a.u0.device.type == "cpu"
    assert kb.build_variant.launches == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            kb.build_variant(vp, wav, src_z, src_x, rcv_z, cfg, KC=KC)
