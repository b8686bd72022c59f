"""recommendsystem_tpu_torch — the PyTorch and CUDA port of recommendsystem_tpu.

The JAX package beside it stays the reference; this package mirrors its
module paths so each counterpart is easy to find, and imports neither JAX nor
any module of the JAX package.  It covers the scoring, train (packed,
scatter and dense sparse updates, with the L1L2 kernel penalties) and eval
paths of autoint, ctr, multi_head, finish, rough_rank and staytime, on
float32 or bf16 tables and under float32 or the bf16 compute policy, the
daily training path, the serving export, the offline fusion search, and
the sharded mode (data parallelism over row-sharded tables, on
``torch.distributed``; tensor and expert parallelism are still to come):

- ``core/``       configuration schema, device set-up and the process mesh;
- ``parallel/``   the distribution namespace (mesh, placements, exchange);
- ``embedding/``  feature columns (``Feature``, ``FeatureSlot``), the
  embedding engine (lazy Adam and AdaGrad table state, eviction; the
  sharded pull and push, all-to-all over the ranks), the fused
  gather-and-fold lookup and the packed update (CUDA kernels K1
  ``fold_mean``, K2 ``fold_rows``, K3 ``unfold_mean``, K4 ``unfold_rows``,
  K8 ``sparse_adam_update``, K9 ``sparse_adagrad_update``);
- ``kernels/``    the field-attention (K5f, K5b), DIN-pool (K7) and fused
  InteractingLayer (K6) kernels, the custom ops that carry the forward
  kernels into an exported program, and the build of ``csrc/``;
- ``nn/``         dense layers and their L1L2 penalty, the InteractingLayer,
  DINPool, SENet, PPNet, the FM blocks (DeepFM among them), DeepCross,
  MMoE, PLE and the stacked experts;
- ``ops/``        the compute-op namespace: ``nn/`` with ``din_pool`` and
  ``interacting_attention`` (no backend switch);
- ``models/``     the model bundle (with its eval metrics and compute
  dtype), autoint, ctr, multi_head, finish, rough_rank and staytime;
- ``train/``      the train, eval and predict steps, ``total_loss_fn``,
  dense Adam, the losses, the streaming metrics and GAUCs, the harness
  (``fit``, ``evaluate``, ``predict``, ``dump_predict``, the GAUC
  evaluations), the checkpoint, the daily trainer (``python -m
  recommendsystem_tpu_torch.train.daily``) and the serving export
  (``export_serving``, ``load_serving``);
- ``search/``     the offline fusion search (PSO, GP, the GAUC engine; numpy,
  ``python -m recommendsystem_tpu_torch.search.cli``);
- ``data/``       the data plane: TFRecord framing and example codec, the
  record parsers, the prefetching loader and the C++ one, Criteo, id
  padding, staytime labels and synthetic batches;
- ``serving/``    the bucketed scoring service and its HTTP server;
- ``utils/``      day arithmetic of the daily trainer;
- ``bridge.py``   weights and optimizer state carried across from the JAX
  package as numpy.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU,
where every kernel runs as its plain PyTorch version.
"""

__version__ = "0.1.0"
