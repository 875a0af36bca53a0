"""Adam against L-BFGS at an equal propagator-call budget (port of
``benchmarks/adam_vs_lbfgs.py``).

The reference's L-BFGS workload was a deliberate optimizer choice
(AutoElMar22LBFGS_model.py:128-137, with the vendored functions/LBFGS.py
Powell-damped Wolfe implementation); this tool asks whether that choice
pays off where every line-search probe is one call of the engine's
physics path instead of a DENISE subprocess.

Budget accounting: the unit is one shot-gradient (forward and adjoint of
one shot).  Adam spends ``shots_per_iter`` a step; L-BFGS spends
``num_shots x num_linesearch_steps`` a step.  The zoom line search
reports its probe count in its state (``optim/lbfgs.py``,
``ZoomLinesearchInfo.num_linesearch_steps``), and the accepted probe's
value and gradient are reused as the next iteration's, so probes are the
only propagator cost.  A probe evaluates value and gradient, so a probe
and an Adam gradient cost the same.

Usage:
    python -m physicsbasedfwi2_tpu_torch.experiments.adam_vs_lbfgs \\
        --budget 7000 --dataroot dataroots/marm_elastic_kd \\
        [--acoustic] [--png out.png] [--device cpu]

Prints one JSON line per arm with its (budget, misfit, model-MSE) curve,
then a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from physicsbasedfwi2_tpu_torch.engine import create_engine, get_workload


def arm_configs(*, dataroot: str | None = None, acoustic: bool = False,
                lbfgs_memory: int = 10, only: str | None = None,
                save_dir: str | None = None) -> list[tuple[str, object]]:
    """The arms as (workload, config), each config named ``avl_<label>``:
    the elastic pair (``marmousi_elastic`` under Adam, its ``tnl1``
    misfit; ``marmousi_elastic_lbfgs``) on ``dataroot``, and with
    ``acoustic`` the acoustic pair (``marmousi_acoustic`` on the ``l2``
    misfit under both: L-BFGS needs a smooth objective); ``only`` keeps
    the labels that contain it.  Nothing is saved: ``save_dir`` defaults
    to a directory under the system's temporary one."""
    save_dir = save_dir or os.path.join(tempfile.gettempdir(), "avl_ck")
    arms = [("marmousi_elastic", {}, "elastic_adam"),
            ("marmousi_elastic_lbfgs",
             {"extras": {"lbfgs_memory": lbfgs_memory}}, "elastic_lbfgs")]
    if acoustic:
        arms += [("marmousi_acoustic", {"misfit": "l2"}, "acoustic_adam"),
                 ("marmousi_acoustic", {"misfit": "l2", "optimizer": "lbfgs"},
                  "acoustic_lbfgs")]
    if only:
        arms = [a for a in arms if only in a[2]]
    out = []
    for workload, overrides, label in arms:
        cfg = get_workload(workload, name=f"avl_{label}", save_dir=save_dir,
                           **overrides)
        if dataroot and label.startswith("elastic"):
            cfg = cfg.replace(dataroot=dataroot)
        out.append((workload, cfg))
    return out


def run_arm(workload: str, cfg, budget: int, *, device=None,
            engine=None) -> dict:
    """Train an engine of ``cfg`` (of ``workload``, named ``avl_<label>``)
    on ``device`` (default the card), or the pre-built ``engine`` of
    ``cfg``, until it has spent ``budget`` shot-gradients; returns the
    arm's record."""
    eng = engine if engine is not None else create_engine(cfg,
                                                          device=device)
    shots_full = getattr(eng, "n_shots", cfg.num_shots)
    per_iter = cfg.shots_per_iter or shots_full
    is_lbfgs = cfg.optimizer == "lbfgs"
    spent = 0
    epoch = cfg.lstart  # the anchor warmup epochs are free (no physics)
    curve = []
    for e in range(1, cfg.lstart + 1):
        eng.optimize_parameters(epoch=e)
    while spent < budget:
        epoch += 1
        out = eng.optimize_parameters(epoch=epoch)
        # L-BFGS: the probes of the step's line search
        spent += (shots_full * eng.opt.state.info.num_linesearch_steps
                  if is_lbfgs else per_iter)
        # the elastic engines report "loss_D_MSE"; the acoustic DIP engine
        # "loss_D" (or "loss_M" for anchor-only epochs)
        misfit = next(out[k] for k in ("loss_D_MSE", "loss_D", "loss_M")
                      if k in out)
        curve.append((spent, misfit, out["loss_M_MSE"]))
    val, _ = eng.test()
    return {"arm": cfg.name.removeprefix("avl_"), "workload": workload,
            "optimizer": cfg.optimizer, "misfit": cfg.misfit,
            "budget_spent": spent, "iterations": len(curve),
            "final_misfit": curve[-1][1], "final_model_mse": curve[-1][2],
            "best_model_mse": min(c[2] for c in curve),
            "val_model_mse": val.get("loss_V_MSE"),
            "curve": [(s, round(d, 6), round(m, 1))
                      for s, d, m in curve[:: max(1, len(curve) // 60)]]}


def summary(results: list[dict], budget: int) -> dict:
    """The summary line of the arms' records."""
    return {"summary": {r["arm"]: {"final_model_mse": r["final_model_mse"],
                                   "best_model_mse": r["best_model_mse"],
                                   "iterations": r["iterations"]}
                        for r in results},
            "budget": budget}


def plot(results: list[dict], path: str) -> None:
    """Misfit and model MSE against the shot-gradients spent, one curve
    an arm, as a PNG."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    for r in results:
        s = [c[0] for c in r["curve"]]
        axes[0].plot(s, [c[1] for c in r["curve"]], label=r["arm"])
        axes[1].plot(s, [c[2] for c in r["curve"]], label=r["arm"])
    axes[0].set_ylabel("data misfit")
    axes[1].set_ylabel("model MSE")
    for ax in axes:
        ax.set_xlabel("shot-gradients spent")
        ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Adam vs L-BFGS at an equal shot-gradient budget "
                    "(PyTorch port)")
    p.add_argument("--budget", type=int, default=7000,
                   help="shot-gradient budget per arm")
    p.add_argument("--dataroot", default=None)
    p.add_argument("--acoustic", action="store_true",
                   help="also run the acoustic pair (l2 misfit both "
                        "arms: L-BFGS needs a smooth objective)")
    p.add_argument("--lbfgs-memory", type=int, default=10)
    p.add_argument("--png", default=None)
    p.add_argument("--only", default=None,
                   help="substring filter on arm labels (e.g. "
                        "'acoustic' re-runs just the acoustic pair)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; fails when "
                        "none is visible -- pass cpu to run the kernels' "
                        "plain versions on the CPU)")
    args = p.parse_args(argv)

    results = []
    for workload, cfg in arm_configs(
            dataroot=args.dataroot, acoustic=args.acoustic,
            lbfgs_memory=args.lbfgs_memory, only=args.only):
        r = run_arm(workload, cfg, args.budget, device=args.device)
        results.append(r)
        print(json.dumps(r), flush=True)
    print(json.dumps(summary(results, args.budget)), flush=True)
    if args.png:
        plot(results, args.png)
        print(f"wrote {args.png}")


if __name__ == "__main__":
    main()
