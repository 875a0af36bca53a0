"""Run-to-run repeatability of seeded training off the kernel paths, on a
CUDA card (ROADMAP Queue C).

The plain propagators inject sources and take receivers with scatters
and gathers on the flat grid (``index_put(accumulate=True)`` in
``ops/kernels.py``; ``scatter_add`` in ``ops/acoustic.py``,
``ops/elastic.py``, ``ops/encoding.py``, ``ops/scalar2.py`` and
``ops/elastic_fused.py``), whose CUDA versions add with atomics.  Each
workload here trains twice from one seed at its registered (full)
width, each run from a fresh engine, and every epoch's record and every
trained weight must be equal to the bit: ``classic_fwi_acoustic``
(autograd through ``simulate_acoustic``), ``marmousi_elastic_lbfgs`` (the
sponge propagator under L-BFGS: a physics epoch is the line search's
value-and-gradient evaluations; the 30 warmup epochs cut to 1) and
``marmousi_acoustic_encoded`` (super-shots).

These need the card and skip elsewhere; on a machine without JAX run
them with ``--noconftest``.
"""

import pytest
import torch

from physicsbasedfwi2_tpu_torch.engine.config import get_workload
from physicsbasedfwi2_tpu_torch.engine.train import train

from torch_parity import deadline

pytestmark = [pytest.mark.cuda, pytest.mark.slow]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.parametrize("workload, epochs, overrides, limit_s", [
    ("classic_fwi_acoustic", 2, {}, 600),
    ("marmousi_elastic_lbfgs", 2, {"lstart": 1}, 900),
    ("marmousi_acoustic_encoded", 3, {}, 600),
])
def test_seeded_runs_repeat_to_the_bit(dev, tmp_path, workload, epochs,
                                       overrides, limit_s):
    runs = []
    with deadline(limit_s):
        for run in range(2):
            cfg = get_workload(workload, name=f"repeat{run}",
                               save_dir=str(tmp_path), **overrides)
            engine, history = train(cfg, epochs=epochs, quiet=True,
                                    device=dev)
            torch.cuda.synchronize()
            records = [{k: v for k, v in r.items() if k != "epoch_time"}
                       for r in history]
            weights = {k: v.detach().cpu()
                       for k, v in engine.weights.state_dict().items()}
            print(f"{workload} run {run}: path {engine.physics_path}; "
                  f"{records}")
            runs.append((records, weights))
    (rec_a, w_a), (rec_b, w_b) = runs
    assert rec_a == rec_b
    assert w_a.keys() == w_b.keys()
    for name in w_a:
        assert torch.equal(w_a[name], w_b[name]), (workload, name)
