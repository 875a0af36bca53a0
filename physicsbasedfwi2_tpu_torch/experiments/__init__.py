"""The tools of the JAX package's ``bench.py`` and ``benchmarks/`` on the
PyTorch port: its experiment tools and its timing harnesses.

Each module has a ``main(argv)`` with the JAX script's flags plus
``--device`` (the card unless the caller names another device); run one
as ``python -m physicsbasedfwi2_tpu_torch.experiments.<tool>``.

The experiment tools, each a function that takes a config and returns
its records:

- ``make_realdata_su``: a field-marine SU dataset for ``real_data``;
- ``misfit_linescan``: each candidate misfit along the path to the truth
  and, from a checkpoint, along the path to its decoded model;
- ``adam_vs_lbfgs``: Adam against L-BFGS at an equal shot-gradient
  budget;
- ``run_latent_flagship``: BASELINE config 4's VAE pretraining, then the
  latent inversion.

The timing harnesses, each printing one JSON line a measurement with the
device it ran on (``timing``: the card's name and power limit, the host's
wait for the card, the kernels' launch counts and route):

- ``bench``: the root ``bench.py``, FWI iteration wall-clock on the
  acoustic and elastic workloads through the kernels or the plain
  autograd paths, and two end-to-end engine iterations;
- ``bench_configs``: end-to-end engine iteration per BASELINE config;
- ``bench_elastic``: the split-PML elastic value and gradient;
- ``bench_kernel_breakdown``: kernel B9's forward-sweep variants and B2.

No harness falls back to another path: a failure raises (a failed config
of ``bench_configs`` prints its error row, and the sweep exits 1).
"""
