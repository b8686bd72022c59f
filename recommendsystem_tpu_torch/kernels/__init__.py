"""Hand-written CUDA kernels of the port and their build.

- K1 ``fold_mean`` and K2 ``fold_rows`` (gather and fold, ``csrc/fold.cu``),
  K3 ``unfold_mean`` and K4 ``unfold_rows`` (unfold fused with the
  scatter-add, ``csrc/unfold_scatter.cu``), K8 the lazy Adam pass
  (``csrc/sparse_adam.cu``) and K9 the lazy AdaGrad pass
  (``csrc/sparse_adagrad.cu``) live beside their callers in
  ``embedding/packed.py``;
- K5f and K5b, the field attention's forward and backward, in
  ``field_attention.py`` (``csrc/field_attention.cu``);
- K7, the DIN pool, facts given and gathering them, in ``din.py``
  (``csrc/din_pool.cu``);
- K6, the fused InteractingLayer iteration, in ``interacting.py``
  (``csrc/interacting.cu``).

K1, K2, K7, K8 and K9 read and write float32 or bf16 rows; K5f, K5b, K6
and K7 take the bf16 compute policy's inputs.  The forward kernels a
predict call reaches (K1, K2, K5f, K6, K7) are PyTorch custom ops
(``_ops.py``), so that ``train/export.py``'s exported program keeps them.
``_build.py`` compiles ``csrc/`` at first use and counts launches.
``din_pool`` and ``interacting_attention`` are exported here as the JAX
``kernels`` package exports its Pallas kernels.
"""

from ._build import (  # noqa: F401
    build_all,
    launch_counts,
    reset_launch_counts,
)
from .din import din_pool  # noqa: F401
from .interacting import interacting_attention  # noqa: F401
