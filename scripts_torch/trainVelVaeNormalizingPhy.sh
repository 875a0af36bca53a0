#!/usr/bin/env bash
# Reference-compatible launcher: same role as the reference's script
# of the same name, mapped onto the PyTorch port (on the CUDA card; add
# --device cpu to run on the CPU).
set -e
cd "$(dirname "$0")/.."
python -m physicsbasedfwi2_tpu_torch.engine.train --workload marmousi_acoustic_vaeflow "$@"
