"""Offline post-ranking score-fusion search (reference ``pso/`` and
``gaussain/``): PSO, GP refinement, GAUC engine, offline AUC metrics.

The port's own copy of ``recommendsystem_tpu/search/``: numpy only (the
GP phase also takes scikit-learn and scipy, the ``gp`` command pandas, each
imported where it is used), so the port imports nothing of the JAX
package.  ``python -m recommendsystem_tpu_torch.search.cli`` runs it."""

from .metrics import Metrics, binary_label_auc, float_label_auc  # noqa: F401
from .reader import Reader  # noqa: F401
from .pso import BASE_PARAMS, PSO, calc_fusion_scores  # noqa: F401
from .gauc import (GaucEngine, cal_mixed_score, default_bound_x,  # noqa: F401
                   filter_user_group_sizes, group_auc)
from .gp import GPSearch  # noqa: F401
