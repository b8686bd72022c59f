"""recommendsystem_tpu_torch — the PyTorch and CUDA port of recommendsystem_tpu.

The JAX package beside it stays the reference; this package mirrors its
module paths so each counterpart is easy to find, and imports neither JAX nor
any module of the JAX package.  What it covers so far is the scoring path,
the packed train step (with the L1L2 kernel penalties) and the eval path of
autoint, ctr, multi_head, finish, rough_rank and staytime, and the offline
fusion search:

- ``core/``       configuration schema and device set-up;
- ``embedding/``  feature columns, the local embedding engine (lazy Adam and
  AdaGrad table state), the fused gather-and-fold lookup and the packed
  update (CUDA kernels ``fold_mean`` / ``fold_rows``, ``unfold_mean`` /
  ``unfold_rows``, ``sparse_adam_update``);
- ``kernels/``    the field-attention and DIN-pool kernels and the build of
  ``csrc/``;
- ``nn/``         dense layers and their L1L2 penalty, the InteractingLayer,
  DINPool, SENet, PPNet, the FM blocks (DeepFM among them) and the
  DeepCross layer;
- ``models/``     the model bundle (with its eval metrics), autoint, ctr,
  multi_head, finish, rough_rank and staytime;
- ``train/``      the packed train step, the eval and predict steps, dense
  Adam, the losses, the streaming metrics and GAUCs, and the eval harness
  (``evaluate``, ``predict``, ``dump_predict``, ``evaluate_gauc``,
  ``evaluate_gauc_streaming``);
- ``search/``     the offline fusion search (PSO, GP, the GAUC engine; numpy,
  ``python -m recommendsystem_tpu_torch.search.cli``);
- ``data/``       id padding, staytime labels and synthetic batches;
- ``serving/``    the bucketed scoring service;
- ``bridge.py``   weights and optimizer state carried across from the JAX
  package as numpy.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU,
where every kernel runs as its plain PyTorch version.
"""

__version__ = "0.1.0"
