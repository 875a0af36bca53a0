"""The experiment tools of the JAX package's ``benchmarks/`` that are not
timing harnesses, on the PyTorch port.

Each module has a function that takes a config and returns its records,
and a ``main(argv)`` with the JAX script's flags plus ``--device``; run
one as ``python -m physicsbasedfwi2_tpu_torch.experiments.<tool>``:

- ``make_realdata_su``: a field-marine SU dataset for ``real_data``;
- ``misfit_linescan``: each candidate misfit along the path to the truth
  and, from a checkpoint, along the path to its decoded model;
- ``adam_vs_lbfgs``: Adam against L-BFGS at an equal shot-gradient
  budget;
- ``run_latent_flagship``: BASELINE config 4's VAE pretraining, then the
  latent inversion.

The package is deliberately not named ``benchmarks``: none of these
tools times anything.
"""
