"""The benchmark's arithmetic: the kernels' operation and byte counts
against the bounds the port's kernel table gives, the percentile, the
window and the union of device activity on synthetic records."""

from __future__ import annotations

import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from fwibench import counts, devtrace  # noqa: E402

ACOUSTIC = {"physics": "acoustic", "nz": 151, "nx": 200, "pml_width": 20,
            "nt": 4001}
ELASTIC = {"physics": "elastic", "nz": 100, "nx": 300, "pml_width": 20,
           "nt": 3334}


def test_b2_counts():
    flop, byts = counts.b2(ACOUSTIC, 18)
    assert flop == 825_120 * 4001 * 37
    assert math.isclose(flop, 1.22e11, rel_tol=5e-3)
    assert math.isclose(byts, 150e6, rel_tol=1e-2)
    assert math.isclose(counts.bound_s(flop, byts) * 1e3, 1.823, rel_tol=1e-3)


def test_b3_counts():
    flop, byts = counts.b3(ELASTIC, 5)
    assert flop == 5 * 122 * 340 * 3334 * 167
    assert math.isclose(flop, 1.15e11, rel_tol=5e-3)
    assert math.isclose(byts, 53.5e6, rel_tol=1e-2)
    assert math.isclose(counts.bound_s(flop, byts) * 1e3, 1.724, rel_tol=1e-3)
    assert counts.physics_flop(ELASTIC, 35) == 7 * flop


def test_quantile_is_linear_between_order_statistics():
    xs = list(range(1, 101))
    assert devtrace.quantile(xs, 0.95) == 95.05
    assert devtrace.quantile([3.0], 0.95) == 3.0
    assert devtrace.quantile([1.0, 2.0], 0.5) == 1.5


def test_union_busy_and_gaps():
    recs = [("a", 0.0, 1.0), ("b", 0.5, 2.0), ("c", 3.0, 4.0),
            ("d", 3.5, 3.6)]
    assert devtrace.union((a, b) for _, a, b in recs) == [(0.0, 2.0),
                                                           (3.0, 4.0)]
    assert devtrace.busy(recs, 0.0, 5.0) == 3.0
    assert devtrace.busy(recs, 1.0, 3.5) == 1.5
    assert devtrace.gaps(recs, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert devtrace.gaps(recs, -1.0, 1.0) == [(-1.0, 0.0)]


def test_host_state_names_the_innermost_span():
    spans = devtrace.Spans()
    spans.add("optimize", 0.0, 10.0)
    spans.add("holdout", 6.0, 8.0)
    spans.add("test", 11.0, 12.0)
    names = ("test", "optimize", "holdout")
    assert devtrace.host_state(spans, 7.0, names) == "holdout"
    assert devtrace.host_state(spans, 2.0, names) == "optimize"
    assert devtrace.host_state(spans, 10.5, names) == "loop"
    assert spans.of("test", 10.0, 13.0) == [(11.0, 12.0)]
    assert spans.of("test", 11.5, 13.0) == []


def test_kernel_names_from_the_sources(tmp_path):
    (tmp_path / "a.cu").write_text(
        "__global__ void fwd_step(float* x) {}\n"
        "__global__ void __launch_bounds__(256, 1)\nrev_resident(A a) {}\n"
        "template <int R> __global__ void __launch_bounds__(K * R)\n"
        "  el_fwd_resident(E a) {}\n")
    names = devtrace.kernel_names(tmp_path)
    (tmp_path / "b.cu").write_text("__global__ void fwd_step(float* x) {}")
    names = devtrace.kernel_names(tmp_path)
    assert names == {"fwd_step": ("a", "b"), "rev_resident": ("a",),
                     "el_fwd_resident": ("a",)}
    assert devtrace.base_name("void el_fwd_resident<8, true, false>(ElArgs)"
                              ) == "el_fwd_resident"
    assert devtrace.base_name(
        "(anonymous namespace)::rev_resident<1>((anonymous namespace)::"
        "RevArgs)") == "rev_resident"
    assert devtrace.base_name("at::native::elementwise_kernel<128, 2>(int)"
                              ) == "elementwise_kernel"
    assert devtrace.base_name("ampere_sgemm_128x64_nn") == \
        "ampere_sgemm_128x64_nn"
    real = devtrace.kernel_names(ROOT / "physicsbasedfwi2_tpu_torch" / "csrc")
    assert real["fwd_resident"] == ("scalar2",)
    assert real["el_rev_resident"] == ("elastic",)
    assert set(real["sum_loss"]) == {"scalar2", "elastic"}


def test_readers_on_synthetic_records():
    from fwibench import run
    size = dict(ACOUSTIC, num_shots=18)
    recs = [("(anonymous namespace)::fwd_resident<1>((anonymous namespace)"
             "::FwdArgs)", 0.000, 0.010),
            ("(anonymous namespace)::rev_resident<1>((anonymous namespace)"
             "::RevArgs)", 0.010, 0.046),
            ("sm80_xmma_gemm_f32f32_f32f32_f32_nt_n", 0.046, 0.050)]
    spans = devtrace.Spans()
    spans.add("optimize", 0.0, 0.052)
    spans.add("test", 0.055, 0.058)
    ctx = run.Context(
        cell={"name": "acoustic.adam"}, size=size, cfg=None, spans=spans,
        calls=[0.0, 0.06], ep_times=[0.06], records=recs, lo=0.0, hi=0.06,
        launches={"fwi_l1_loss_grad": [1, 1, 0]},
        kernels=devtrace.kernel_names(ROOT / "physicsbasedfwi2_tpu_torch"
                                      / "csrc"), gen_flop=0.0)
    assert math.isclose(run.reader("roofline.b2")(ctx), 100 * 1.8227 / 46,
                        rel_tol=1e-3)
    assert math.isclose(run.reader("torch_ops_ms")(ctx), 4.0)
    assert math.isclose(run.reader("idle_share")(ctx), 100 * 1 / 6)
    assert math.isclose(run.reader("loop_ms")(ctx), 5.0)
    assert math.isclose(run.reader("test_ms")(ctx), 3.0)
    assert run.reader("holdout_ms")(ctx) is None
    assert run.reader("roofline.b3")(ctx) is None
    mfu = run.reader("step_mfu")(ctx)
    assert math.isclose(mfu, 100 * 1.2215e11 / (0.06 * 67e12), rel_tol=1e-3)
    out = run.breakdown(ctx)
    assert out["device_ops"][0][0].startswith("rev_resident<1>")
    assert out["idle_gaps"] == [["test", 0.010000000000000002]] or \
        out["idle_gaps"][0][0] == "test"
