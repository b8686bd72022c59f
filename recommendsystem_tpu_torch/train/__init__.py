"""Train state and steps of the port: the packed train step (local and
sharded, with ``state_shardings``, ``shard_state`` and ``gather_state``),
its multi-step driver, the eval and predict steps, the streaming metrics and
GAUCs, the harness (``fit``, ``evaluate``, ``predict``, ``dump_predict``,
``evaluate_gauc``, ``evaluate_gauc_streaming``), the checkpoint and the
daily trainer (``python -m recommendsystem_tpu_torch.train.daily``)."""

from . import losses  # noqa: F401
from . import metrics  # noqa: F401
from .state import (  # noqa: F401
    TrainState,
    create_train_state,
    gather_state,
    shard_state,
    state_shardings,
)
from .step import (  # noqa: F401
    apply_model,
    make_eval_step,
    make_predict_step,
    make_scan_train_step,
    make_train_step,
    total_loss_fn,
)
from .harness import dump_predict, evaluate, fit, predict  # noqa: F401
from .streaming_gauc import StreamingGauc, StreamingSpearmanGauc  # noqa: F401
from .gauc_eval import (  # noqa: F401
    evaluate_gauc,
    evaluate_gauc_streaming,
    make_gauc_eval_step,
)
from .checkpoint import restore_checkpoint, save_checkpoint  # noqa: F401
