"""ops: the compute-op namespace, the layer library with the kernels
behind it (a facade over ``nn/`` and ``kernels/``), as
``recommendsystem_tpu/ops`` is.

It has no ``set_backend``, ``use_pallas`` or ``interpret_mode``: the port
has no backend switch.  Each layer picks its kernel from the device of
its tensors and the widths it sees (``nn/interacting.py``): the CUDA
kernel on a card, its plain PyTorch version on the CPU.
"""

from ..nn import *  # noqa: F401,F403
from ..kernels import din_pool, interacting_attention  # noqa: F401
