"""The comparison that decides ``correct``, on the CPU at a tiny shape:
the port's plain path against the plain reference passes; the reference
in TF32 in the program's place fails; runs of the harness with the
timed path broken underneath (a step that leaves the weights as they
were; half the shots left out, the mean over the rest; the physics
gradient doubled; the observed data one time step late) come out not
correct.  A CUDA-marked test runs one short cell on the card."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from fwibench import control, run  # noqa: E402
from fwibench.reference import steps  # noqa: E402
from physicsbasedfwi2_tpu_torch.engine import engines  # noqa: E402

SIZE = {"nz": 48, "nx": 64, "nt": 300, "num_shots": 4, "num_receivers": 32,
        "water_rows": 6}
CELLS = ("acoustic.adam", "elastic.adam", "elastic.robust")
SEED = 2_147_483_659


def shrink(cell: str) -> dict:
    """A tiny grid, few shots and steps; the generator at its published
    widths (the control's rounding shows at them)."""
    ec = {"chunk": 25}
    if cell.startswith("elastic"):
        ec["lstart"] = 2
    return {"size": SIZE, "engine_config": ec, "setup_epochs": 4}


def _run(cell, hook=None):
    seconds = 8.0 if cell.startswith("elastic") else 3.0
    return run.run(cell, SEED, seconds, False, device="cpu",
                   shrink=shrink(cell), hook=hook)


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_matches_the_reference(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["checks"]["obs"]["value"] < 1e-6
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "info", "checks"]
    assert set(r["metrics"]) == {"setup_s", "epoch_s", "epoch_p95_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_tf32_in_the_programs_place_fails(cell):
    case, n = control.case_for(cell, SEED, torch.device("cpu"), shrink(cell))
    anchor = steps.anchor(case)
    ref = steps.run(case, n, anchor=anchor)
    tf32 = control.readings(case, n, ref, anchor, "tf32")
    limits = run.load_json(run.BENCH / "limits" / f"{cell}.json")["limits"]
    assert any(tf32[k] > lim for k, lim in limits.items()), tf32


def _frozen_step(engine):
    """Adam runs, then every weight is put back: the step returns the
    state it was given."""
    step = engine.opt.step

    def frozen(*a, **kw):
        old = [p.detach().clone() for p in engine.net.parameters()]
        out = step(*a, **kw)
        with torch.no_grad():
            for p, o in zip(engine.net.parameters(), old):
                p.copy_(o)
        return out

    engine.opt.step = frozen


@pytest.mark.parametrize("cell", CELLS[:2])
def test_a_step_that_keeps_its_state_fails(cell):
    r = _run(cell, hook=_frozen_step)
    assert not r["correct"]
    assert r["checks"]["change"]["value"] > 0.99


def test_half_the_shots_fails_acoustic(monkeypatch):
    fn = engines.fwi_l1_loss_grad

    def half(vp, wav, sz, sx, rz, rx, cfg, obs_rows, dir_rows, **kw):
        if wav.ndim == 2:
            wav = wav[::2]
        return fn(vp, wav, sz[::2], sx[::2], rz[::2], rx[::2], cfg,
                  obs_rows[::2], dir_rows[::2], **kw)

    monkeypatch.setattr(engines, "fwi_l1_loss_grad", half)
    r = _run("acoustic.adam")
    assert not r["correct"]


def test_half_the_shots_fails_elastic(monkeypatch):
    fn = engines.fused_elastic_loss_grad

    def half(vp, vs, rho, wav, sz, sx, rz, rx, cfg, orx, orz, **kw):
        if wav.ndim == 2:
            wav = wav[::2]
        return fn(vp, vs, rho, wav, sz[::2], sx[::2], rz[::2], rx[::2], cfg,
                  orx[::2], orz[::2], **kw)

    monkeypatch.setattr(engines, "fused_elastic_loss_grad", half)
    r = _run("elastic.adam")
    assert not r["correct"]


def test_a_doubled_gradient_fails_acoustic(monkeypatch):
    fn = engines.fwi_l1_loss_grad

    def doubled(*a, **kw):
        loss, grad = fn(*a, **kw)
        return loss, 2.0 * grad

    monkeypatch.setattr(engines, "fwi_l1_loss_grad", doubled)
    r = _run("acoustic.adam")
    assert not r["correct"]
    assert r["checks"]["grad"]["value"] > r["checks"]["grad"]["limit"]


def _late(fn):
    def late(*a, **kw):
        out = fn(*a, **kw)
        if isinstance(out, tuple):
            return tuple(steps.shift_one(o) for o in out)
        return steps.shift_one(out)
    return late


@pytest.mark.parametrize("cell,name", [("acoustic.adam", "forward2"),
                                       ("elastic.adam",
                                        "simulate_elastic_ring")])
def test_late_observed_data_fails(monkeypatch, cell, name):
    monkeypatch.setattr(engines, name, _late(getattr(engines, name)))
    r = _run(cell)
    assert not r["correct"]
    assert r["checks"]["obs"]["value"] > r["checks"]["obs"]["limit"]


def test_no_jax_after_a_run():
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from fwibench import run\n"
        "r = run.run('acoustic.adam', 5, 2.0, False, device='cpu', "
        "shrink=%r)\n"
        "print(json.dumps(run.forbidden_modules()))\n"
        % (str(ROOT), shrink("acoustic.adam")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_without_a_card_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, str(ROOT / "fwibench" / "run.py"), "--workload",
         "acoustic.adam", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, str(ROOT / "fwibench" / "run.py"), "--workload",
         "acoustic.adam", "--seed", "3", "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
