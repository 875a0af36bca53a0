"""PyTorch + CUDA port of ``physicsbasedfwi2_tpu``.

The JAX package beside this one is the reference; each module here
keeps the file name and public names of its counterpart.  The Pallas
kernels on the ``marmousi_acoustic`` and ``marmousi_elastic`` paths are
hand-written CUDA C++ for Hopper (``csrc/scalar2.cu``,
``csrc/elastic.cu``), built with ``nvcc`` at first use; on CPU tensors
their plain PyTorch versions run instead.  The entry points run on the
first CUDA card unless the caller asks for the CPU.

This package imports neither JAX nor the JAX package.

Importing it turns TF32 off for matmuls and cuDNN convolutions, so the
generator runs in full float32 as the reference does, and makes cuDNN
pick deterministic algorithms (no autotuning), so that a fixed seed
repeats a run on the card.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False

__version__ = "0.1.0"
