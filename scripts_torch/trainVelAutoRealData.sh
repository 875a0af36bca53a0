#!/usr/bin/env bash
# Reference-compatible launcher: real-data elastic inversion — point
# --dataroot at a prepped tree (e.g. from --su-obs DENISE data); the
# PyTorch port, on the CUDA card (add --device cpu for the CPU).
set -e
cd "$(dirname "$0")/.."
python -m physicsbasedfwi2_tpu_torch.engine.train --workload marmousi_elastic --netG AutoRealData "$@"
