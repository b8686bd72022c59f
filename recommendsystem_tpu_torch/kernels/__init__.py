"""Hand-written CUDA kernels of the port and their build.

The fold, unfold-scatter and lazy-Adam kernels live beside their callers
in ``embedding/packed.py``; the field-attention kernel is in
``field_attention.py``, the DIN-pool kernel in ``din.py`` and the fused
InteractingLayer iteration in ``interacting.py``.  Sources are
in ``csrc/``; ``_build.py`` compiles them at first use.
"""

from ._build import (  # noqa: F401
    build_all,
    launch_counts,
    reset_launch_counts,
)
