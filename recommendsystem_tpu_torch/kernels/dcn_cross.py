"""The low-rank cross layer's elementwise backward: K10.

A DCN-V2 cross layer (``nn/dcn.py::LowRankCrossNet``) maps x_l to
``x_{l+1} = x_0 * u + x_l`` with ``u = W (V x_l) + b``.  Given ``g``, the
gradient of x_{l+1}, its backward needs ``du = g * x_0`` (into the two
GEMMs), the layer's share ``g * u`` of x_0's gradient and ``db``, the sum
of du over the rows.  ``dcn_cross_bwd`` gives all three in one pass over
the rows: it returns du and the per-tile partial sums of db (``TILE_ROWS``
rows a tile; the caller sums them) and accumulates x_0's gradient into
``dx0`` in place.  On a CUDA tensor it launches the hand-written kernel of
``csrc/dcn_cross.cu``; on a CPU tensor it runs ``dcn_cross_bwd_plain``,
the same arithmetic in PyTorch ops.  Both go through the custom op
``recommendsystem_tpu_torch::dcn_cross_bwd`` (``kernels/_ops.py``), which
mutates ``dx0``, so that a CUDA graph's capture of the train step keeps
the launch in order.

All tensors are float32, (B, F), contiguous and on one device.  du and
dx0 are exact: each product and sum rounds once, in the plain version's
order (``dx0 + g * u``, then ``+ g`` where ``residual``); the partial
sums run over a tile's rows in order.
"""

from __future__ import annotations

import torch

from . import _ops
from ._build import check, count_launch, library, require, stream_handle

TILE_ROWS = 32      # csrc/dcn_cross.cu: kTileRows
MAX_TILES = 65535   # the grid's y extent


def tiles_of(rows: int) -> int:
    """Rows of the partial sums of db for ``rows`` rows."""
    return -(-rows // TILE_ROWS)


def dcn_cross_bwd_plain(g, x0, u, dx0, accumulate: bool, residual: bool):
    """(du, partial) and ``dx0`` in place: ``du = g * x0``; ``dx0 = (dx0
    if accumulate else 0) + g * u``, plus ``g`` where ``residual``;
    ``partial[t]`` the sum of du over rows ``[t TILE_ROWS, (t + 1)
    TILE_ROWS)``."""
    du = g * x0
    dx = g * u
    if accumulate:
        dx = dx0 + dx
    if residual:
        dx = dx + g
    dx0.copy_(dx)
    rows, f = du.shape
    pad = tiles_of(rows) * TILE_ROWS - rows
    padded = torch.cat([du, du.new_zeros((pad, f))]) if pad else du
    return du, padded.reshape(-1, TILE_ROWS, f).sum(dim=1)


def _check(g, x0, u, dx0) -> None:
    require(g, "g", torch.float32)
    if g.ndim != 2:
        raise ValueError(f"dcn_cross_bwd: g must be (B, F), got {tuple(g.shape)}")
    for name, t in (("x0", x0), ("u", u), ("dx0", dx0)):
        require(t, name, torch.float32, g.shape, g.device)
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dcn_cross_bwd: no kernel for device {g.device}")
    if g.shape[0] < 1 or g.shape[1] < 1 or tiles_of(g.shape[0]) > MAX_TILES:
        raise ValueError(f"dcn_cross_bwd: {tuple(g.shape)} rows: needs 1 to "
                         f"{MAX_TILES * TILE_ROWS} rows and F >= 1")


def dcn_cross_bwd(g: torch.Tensor, x0: torch.Tensor, u: torch.Tensor, dx0: torch.Tensor,
                  accumulate: bool, residual: bool):
    """K10: (du (B, F), partial sums of db (``tiles_of(B)``, F)), and x_0's
    gradient accumulated into ``dx0`` in place (module docstring)."""
    _check(g, x0, u, dx0)
    return _ops.op("dcn_cross_bwd")(g, x0, u, dx0, bool(accumulate), bool(residual))


def dcn_cross_bwd_launch(g, x0, u, dx0, accumulate: bool, residual: bool):
    """K10's launcher, the CUDA implementation of the op
    ``recommendsystem_tpu_torch::dcn_cross_bwd``: inputs checked by
    ``dcn_cross_bwd``."""
    rows, f = g.shape
    du = torch.empty_like(g)
    partial = torch.empty((tiles_of(rows), f), dtype=torch.float32, device=g.device)
    lib = library("dcn_cross")
    with torch.cuda.device(g.device):
        code = lib.dcn_cross_bwd(g.data_ptr(), x0.data_ptr(), u.data_ptr(), du.data_ptr(),
                                 dx0.data_ptr(), partial.data_ptr(), rows, f,
                                 int(accumulate), int(residual), stream_handle(g.device))
    check(lib, code, "dcn_cross_bwd")
    count_launch("dcn_cross")
    return du, partial
