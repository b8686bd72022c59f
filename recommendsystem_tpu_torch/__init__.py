"""recommendsystem_tpu_torch — the PyTorch and CUDA port of recommendsystem_tpu.

The JAX package beside it stays the reference; this package mirrors its
module paths so each counterpart is easy to find, and imports neither JAX nor
any module of the JAX package.  What it covers so far is the autoint scoring
path:

- ``core/``       configuration schema and device set-up;
- ``embedding/``  feature columns, the local embedding engine and the fused
  gather-and-fold lookup (CUDA kernels ``fold_mean`` / ``fold_rows``);
- ``kernels/``    the field-attention kernel and the build of ``csrc/``;
- ``nn/``         dense layers and the InteractingLayer;
- ``models/``     the model bundle and autoint;
- ``train/``      the predict step;
- ``data/``       id padding and synthetic batches;
- ``serving/``    the bucketed scoring service;
- ``bridge.py``   weights carried across from the JAX package as numpy.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU,
where every kernel runs as its plain PyTorch version.
"""

__version__ = "0.1.0"
