"""Kernels B7a and B7b (``ops/scalar2b.py``) on their two routes: which
route and entry point each grid takes (through a stand-in library that
records the C calls, so no card is needed), that CPU tensors reach no
route, the shot-pair checkpoint address the resident kernels use, and
the pair-order gradient sum."""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from physicsbasedfwi2_tpu_torch.geo import ricker
from physicsbasedfwi2_tpu_torch.ops import cuda_build, scalar2, scalar2b
from physicsbasedfwi2_tpu_torch.ops.scalar2 import resident_plan

from torch_parity import acoustic_case, t, torch_acoustic

torch.set_num_threads(1)

FNS = (scalar2b.forward2b, scalar2b.backward2b)


@pytest.fixture
def counts():
    """The B7 launch counts, set to 0 for the test and restored after."""
    saved = [(f.launches, f.resident_launches, f.per_step_launches)
             for f in FNS]
    scalar2.reset_launches(*FNS)
    yield lambda: [(f.launches, f.resident_launches, f.per_step_launches)
                   for f in FNS]
    for f, (a, b, c) in zip(FNS, saved):
        f.launches, f.resident_launches, f.per_step_launches = a, b, c


class _Recorder:
    """Stands in for the kernels' library: each entry point records its
    name and arguments and returns cudaSuccess."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def recorder(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(cuda_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=0))
    # each entry point runs with its tensors' card current; these
    # operands are on the CPU
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    return lib


def _operands(nz8, nx128, ns=2, kc=16):
    """Kernel-layout operands of one pair of shots over one chunk."""
    K, dp, dm = (torch.zeros((nz8, nx128)) for _ in range(3))
    wav = torch.zeros((ns, kc))
    geo = [torch.full((ns,), 4, dtype=torch.int32) for _ in range(3)]
    ybar = torch.zeros((ns, kc, nx128))
    ckpt = torch.zeros((ns // 2, 1, 2, 2, nz8, nx128))
    return (K, dp, dm, wav, *geo), ybar, ckpt


# the flagship grid, a wide one (72 x 1024: 8-row bands would need 9
# CTAs) and a tall one (4096 x 256)
ROUTE_CASES = [(192, 256, "resident"), (72, 1024, "per_step"),
               (4096, 256, "per_step")]


@pytest.mark.parametrize("nz8,nx128,default", ROUTE_CASES)
@pytest.mark.parametrize("route", [None, "resident", "per_step"])
def test_b7_routes_by_grid(recorder, counts, nz8, nx128, default, route):
    ops, ybar, ckpt = _operands(nz8, nx128)
    plan = resident_plan(nz8, nx128)
    assert (plan is not None) == (default == "resident")
    if route == "resident" and plan is None:
        with pytest.raises(ValueError, match="no resident plan"):
            scalar2b._fwd_cuda(*ops, 16, 16, route=route)
        with pytest.raises(ValueError, match="no resident plan"):
            scalar2b._bwd_cuda(*ops, ybar, ckpt, route=route)
        assert recorder.calls == [] and counts() == [(0, 0, 0)] * 2
        return
    hist, ck = scalar2b._fwd_cuda(*ops, 16, 16, route=route)
    gk = scalar2b._bwd_cuda(*ops, ybar, ckpt, route=route)
    assert hist.shape == (2, 16, nx128) and gk.shape == (nz8, nx128)
    assert ck.shape == (1, 1, 2, 2, nz8, nx128)
    taken = route or default
    suffix = "_resident" if taken == "resident" else ""
    names = [name for name, _ in recorder.calls]
    assert names == ["b7a_forward2b" + suffix, "b7b_backward2b" + suffix]
    for name, args in recorder.calls:
        # the arguments the C signature declares, the plan before the
        # stream on the resident route
        assert len(args) == len(cuda_build._SIGNATURES[name])
        if taken == "resident":
            assert args[-6:-1] == plan.args()
    per_route = (1, 0) if taken == "resident" else (0, 1)
    assert counts() == [(1, *per_route)] * 2


@pytest.mark.parametrize("fn", ["_fwd_cuda", "_bwd_cuda"])
def test_b7_rejects_a_bad_route_name(recorder, counts, fn):
    ops, ybar, ckpt = _operands(192, 256)
    args = (16, 16) if fn == "_fwd_cuda" else (ybar, ckpt)
    for bad in ("cuda", resident_plan(192, 256)):
        with pytest.raises(ValueError, match="route must be"):
            getattr(scalar2b, fn)(*ops, *args, route=bad)
    assert recorder.calls == [] and counts() == [(0, 0, 0)] * 2


def test_flagship_plan_is_b4s():
    # B7 runs B4's resident sweeps under B4's plan
    assert scalar2.pick_route("forward2b", 192, 256,
                              plan_fn=resident_plan) == (
        "resident", scalar2.ResidentPlan(5, 40, 512, 215_808))


@pytest.mark.parametrize("route", [None, "resident", "per_step"])
def test_cpu_tensors_reach_no_b7_route(counts, route):
    grid, cfg, wargs, vp, geom = acoustic_case()
    grid = dict(grid, nt=40)
    cfg = torch_acoustic(grid, cfg)
    wav = ricker(wargs[0], 40, wargs[2])
    vp, geom = t(vp), tuple(map(t, geom))
    recs, ckpt = scalar2b.forward2b(vp, wav, *geom, cfg, route=route)
    rows = scalar2.scatter_rows(recs, geom[3], nt=40, nx=44, pml_width=12,
                                KC=scalar2b.KC)
    g = scalar2b.backward2b(vp, wav, *geom, cfg, rows, ckpt, route=route)
    v = vp.clone().requires_grad_(True)
    scalar2b.acoustic_pallas2b(v, wav, *geom, cfg).square().sum().backward()
    assert bool(torch.isfinite(g).all()) and bool(torch.isfinite(v.grad).all())
    assert counts() == [(0, 0, 0)] * 2


@pytest.mark.parametrize("ns", [2, 4, 6])
def test_ckpt_offset_addresses_the_pair_layout(ns):
    n_ck, nz8, nx128 = 3, 2, 4
    F = nz8 * nx128
    # every element distinct (exact in float64)
    shots = torch.arange(ns * n_ck * 2 * F, dtype=torch.float64).reshape(
        ns, n_ck, 2, nz8, nx128)
    pairs = scalar2b._to_pairs(shots).reshape(-1)
    flat = shots.reshape(-1)
    for s in range(ns):
        for c in range(n_ck):
            for f in range(2):
                off = (((s // 2) * n_ck + c) * 2 * 2 + f * 2 + s % 2) * F
                assert scalar2b.ckpt_offset(s, c, n_ck, F) + f * 2 * F == off
                assert torch.equal(pairs[off:off + F],
                                   shots[s, c, f].reshape(-1))
                # P = 1 is the shot layout of B2 and B4
                off1 = scalar2b.ckpt_offset(s, c, n_ck, F, P=1) + f * F
                assert torch.equal(flat[off1:off1 + F],
                                   shots[s, c, f].reshape(-1))
    assert torch.equal(scalar2b._from_pairs(scalar2b._to_pairs(shots)),
                       shots)


@pytest.mark.parametrize("ns", [2, 4, 6])
def test_sum_pairs_is_the_pair_ordered_sum(ns):
    g = torch.as_tensor(np.random.default_rng(ns).standard_normal(
        (ns, 5, 7)).astype(np.float32))
    want = {2: lambda: g[0] + g[1],
            4: lambda: (g[0] + g[1]) + (g[2] + g[3]),
            6: lambda: ((g[0] + g[1]) + (g[2] + g[3])) + (g[4] + g[5]),
            }[ns]()
    assert torch.equal(scalar2b._sum_pairs(g), want)


def test_sum_pairs_rounds_unlike_the_shot_ordered_sum():
    # 1 + 2^-24 rounds back to 1 (a tie, to even), 2^-24 + 2^-24 does not
    tiny = 2.0 ** -24
    g = torch.tensor([1.0, 0.0, tiny, tiny], dtype=torch.float32)
    assert float(scalar2b._sum_pairs(g)) == 1.0 + 2 * tiny
    assert float(scalar2._sum_shots(g)) == 1.0
