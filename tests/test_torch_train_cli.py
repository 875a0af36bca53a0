"""The port's training CLI end to end on the CPU (plain kernel versions)
at the ``--small`` size."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_train_cli_small_runs_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "physicsbasedfwi2_tpu_torch.engine.train",
         "--small", "--epochs", "2", "--device", "cpu",
         "--save-dir", str(tmp_path), "--set", "lr=0.02"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert "acoustic physics path: fused-plain" in proc.stdout
    last = json.loads(lines[-1])
    assert last["epoch"] == 2
    assert {"loss_D", "loss_M_MSE", "lr", "loss_V_MSE"} <= last.keys()
    assert last["lr"] == 0.02
    run_dir = tmp_path / "marmousi_acoustic"
    assert (run_dir / "latest_net_G.npz").exists()
    with open(run_dir / "metrics.jsonl") as f:
        assert len(f.readlines()) == 2
