"""parallel: the distribution namespace, the process mesh, the placements
and the all-to-all embedding exchange (a facade over ``core.mesh``, the
sharded lookup of ``embedding.engine`` and ``train.state``), with the names
of ``recommendsystem_tpu/parallel/__init__.py``."""

from ..core.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    create_mesh,
    data_sharding,
    distributed_init,
    local_mesh,
    process_count,
    process_index,
    replicated,
    row_sharding,
)
from ..embedding.engine import all_to_all_lookup  # noqa: F401
from ..train.state import state_shardings  # noqa: F401
