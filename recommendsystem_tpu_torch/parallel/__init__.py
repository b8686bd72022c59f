"""parallel: the distribution namespace, the process mesh, the placements,
the all-to-all embedding exchange and the model axis (a facade over
``core.mesh``, ``core.model_axis``, the sharded lookup of
``embedding.engine``, ``train.state`` and ``nn.moe_stacked``), with the
names of ``recommendsystem_tpu/parallel/__init__.py`` and the model-axis
functions of tensor and expert parallelism (``copy_to_model``,
``gather_from_model``, ``gather_leaf``, ``sum_over_model``)."""

from ..core.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    column_sharding,
    create_mesh,
    data_sharding,
    distributed_init,
    expert_sharding,
    local_mesh,
    process_count,
    process_index,
    replicated,
    row_sharding,
)
from ..core.model_axis import (  # noqa: F401
    copy_to_model,
    gather_from_model,
    gather_leaf,
    sum_over_model,
    sync_replicas,
)
from ..embedding.engine import all_to_all_lookup  # noqa: F401
from ..nn.moe_stacked import expert_shardings  # noqa: F401
from ..train.state import merge_shardings, state_shardings  # noqa: F401
