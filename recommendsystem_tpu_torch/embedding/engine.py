"""EmbeddingFeatures: the sparse-embedding engine, local mode.

Counterpart of ``recommendsystem_tpu/embedding/engine.py``.  Tables are
grouped into storages exactly as the JAX engine groups them (same storage
keys, member offsets and padded row counts), so weights carry across one to
one (``bridge.py``).  Each storage's state keeps the classic per-row layout
of the JAX engine's ``classic_state``: ``{"w": (rows, D), "opt": ...,
"show": (rows, 1)}``, where ``opt`` is the sparse optimizer's state:
``{"m": (rows, D), "v": (rows, D), "t": (rows, 1)}`` for ``SparseAdam``,
``{"g2sum": (rows, 1)}`` for ``SparseAdaGrad``.  On Hopper an 8-float row
is one 32-byte sector, so the JAX package's 128-lane packed-state layout
buys nothing here.

Storage precision, as in the JAX engine: ``table_dtype`` (float32,
bfloat16, or ``"auto"``: bf16 for rows of D >= 32) is the type w is stored
in, ``SparseAdam.state_dtype`` that of m and v; t, show and g2sum are
float32.  Lookups return float32 and every update computes in float32,
rounding only what it stores.

The classic ``lookup`` (gather, then combine) and the classic update paths
(``row_counts``, ``flatten_raw_grads``, ``apply_gradients_scatter``, and
``apply_gradients`` over gradients of the whole tables) are the train
step's ``"scatter"`` and ``"dense"`` variants, the packed step's path for
the storages that cannot pack, and the port's oracles for the fused lookup
and the packed update in ``packed.py``.  ``packed=False`` leaves member
offsets unaligned, as the JAX engine does, so that no storage packs.
``evict`` and ``maybe_evict`` are the admission hook of the parameter
server (rows seen too rarely start afresh).

The sharded mode (``mode="sharded"``, with a ``core.mesh.Mesh``) is the
JAX package's stand-in for the parameter server, on ``torch.distributed``:
an engine built with ``num_shards=n`` pads every storage as the JAX engine
does for n shards, and rank r holds rows ``[r R/n, (r+1) R/n)`` of each
storage (w, its optimizer state and show) and its rows of the batch.  A
lookup pulls each id's row from its owner (``all_to_all_lookup``: the
requests and the rows go through two fixed-capacity all-to-alls, the
owner's gather between them), and an update pushes each entry's gradient
to its owner (``route_grads_to_owners``), which applies the lazy update to
its own rows.  The capacity of a destination is ``exchange_capacity``:
exact (E) for small exchanges, ``factor * E / n`` for large ones, where
entries past it are dropped (zero rows, no gradient) and counted
(``a2a_drop_report``), in the JAX package's order (``_owner_slots``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..core.mesh import Mesh, row_sharding
from . import packed as packed_mod
from .feature_column import EmbeddingColumn
from .optimizers import SparseAdaGrad, SparseAdam


@dataclasses.dataclass
class IdBatch:
    """Padded, host-hashed ids of one feature: ``rows`` (B, L) int32 in
    [0, bucket); ``mask`` (B, L) float32 {0, 1}.

    CONTRACT: ``rows`` must already be hashed into [0, bucket_size): the
    fold kernels read ``table[id]`` unchecked.  Every in-package constructor
    hashes with splitmix64 mod bucket; run ``validate_batch`` on batches
    built by hand."""

    rows: torch.Tensor
    mask: torch.Tensor

    @property
    def shape(self):
        return self.rows.shape

    def to(self, device) -> "IdBatch":
        return IdBatch(rows=self.rows.to(device), mask=self.mask.to(device))


def pad_bucket(bucket_size: int, n_shards: int) -> int:
    return ((bucket_size + n_shards - 1) // n_shards) * n_shards


def validate_batch(engine: "EmbeddingFeatures",
                   batch: Dict[str, IdBatch]) -> None:
    """Host-side bounds check of the IdBatch contract: every id must lie in
    [0, bucket).  Reads each column's min and max (a device sync for CUDA
    tensors: run it before moving a batch to the card)."""
    for key, ib in batch.items():
        col = engine.columns.get(key)
        if col is None:
            continue
        bucket = col.categorical_column.bucket_size
        if ib.rows.numel() == 0:
            continue
        lo, hi = int(ib.rows.min()), int(ib.rows.max())
        if lo < 0 or hi >= bucket:
            raise ValueError(
                f"IdBatch[{key}]: ids must be hashed into [0, {bucket}); "
                f"got range [{lo}, {hi}]. Hash raw feasigns with the "
                f"column's category_column (splitmix64 mod bucket) first — "
                f"the lookup reads table rows unchecked.")


# ---------------------------------------------------------------------------
# the sharded exchange
# ---------------------------------------------------------------------------

def exchange_capacity(e: int, n: int, factor) -> int:
    """Per-destination capacity of one all-to-all exchange of ``e`` entries
    over ``n`` ranks (``recommendsystem_tpu/embedding/engine.py:88-108``):
    ``None`` exact (E: no destination can overflow); a float bounds it at
    ``ceil(factor E / n)``, which hashed-uniform ids overflow with
    probability ~exp(-E/n); ``"auto"`` (the engine's default) bounds it at
    2.0 where ``E >= 256 n`` and keeps it exact below."""
    if factor == "auto":
        factor = 2.0 if e >= 256 * n else None
    if factor is None:
        return e
    return max(1, min(e, -(-int(e * factor) // n)))


def _owner_slots(flat_rows: torch.Tensor, rows_per_shard: int, n: int,
                 capacity: int, mask: Optional[torch.Tensor] = None):
    """The routing plan of a fixed-capacity exchange, as the JAX
    ``_owner_slots`` makes it: for each of the E entries its owner (row //
    rows_per_shard), its row on the owner, its slot ``owner * capacity +
    rank`` (rank: its place among the entries for the same owner, in entry
    order) and whether it fits (None where capacity >= E and no mask: all
    do).  With ``mask`` (E,), entries of mask 0 take no capacity and never
    fit.  An entry that does not fit gets slot ``n * capacity``."""
    owner = torch.div(flat_rows, rows_per_shard, rounding_mode="floor")
    local_row = flat_rows - owner * rows_per_shard
    counted = owner if mask is None else torch.where(mask > 0, owner, n)
    rank = torch.zeros_like(owner)
    for o in range(n):
        hit = counted == o
        rank = torch.where(hit, torch.cumsum(hit, 0) - 1, rank)
    if capacity >= flat_rows.shape[0] and mask is None:
        return owner, local_row, owner * capacity + rank, None
    in_cap = rank < capacity
    if mask is not None:
        in_cap = in_cap & (mask > 0)
    slot = torch.where(in_cap, owner * capacity + rank, n * capacity)
    return owner, local_row, slot, in_cap


def _a2a(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """One all-to-all over the data axis: x's leading dim is n equal
    chunks, chunk j going to rank j; returns the chunks received, rank j's
    in chunk j."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=mesh.group)
    return out


def a2a_many(bufs: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """``_a2a`` of every buffer of ``bufs`` (one dtype; each a leading dim
    of n equal chunks) in one all-to-all: chunk j of each goes to rank j
    side by side.  Returns the received buffers, in their shapes."""
    n = mesh.size
    flat = [b.reshape(n, -1) for b in bufs]
    out = _a2a(flat[0] if len(flat) == 1 else torch.cat(flat, dim=1), mesh)
    return [part.reshape(b.shape) for part, b in
            zip(out.split([f.shape[1] for f in flat], dim=1), bufs)]


@dataclasses.dataclass
class ExchangePlan:
    """One exchange of a stream of E entries: ``cap`` slots per
    destination, each entry's ``slot`` in the (n cap,) send buffer (n cap
    where it does not fit), ``keep`` (E,) bool (None: all fit), and
    ``recv_rows`` (n cap,) int32, the rows of this rank's shard that the
    other ranks asked for (0 in an unfilled slot)."""

    cap: int
    slot: torch.Tensor
    keep: Optional[torch.Tensor]
    recv_rows: torch.Tensor

    def positions(self) -> torch.Tensor:
        """Each entry's slot as int32 ids into the received (n cap, D)
        buffer, 0 for the entries that do not fit (their mask is
        ``live``'s 0)."""
        n_cap = self.recv_rows.shape[0]
        return torch.where(self.slot < n_cap, self.slot, 0).to(torch.int32)

    def live(self, mask: torch.Tensor) -> torch.Tensor:
        """``mask`` with the entries that do not fit zeroed."""
        return mask if self.keep is None else mask * self.keep.to(mask.dtype)


def exchange_plans(streams, mesh: Mesh, capacity_factor=None) -> List[ExchangePlan]:
    """Routes each stream of ``streams`` ((flat_rows (E,), rows_per_shard,
    mask or None) each: one fixed-capacity exchange a stream) to the
    owners of its rows, and exchanges every stream's requests in one
    all-to-all of int32 rows.  A mask is used only where the capacity is
    bounded (padding then takes none), as the JAX exchanges use it."""
    n, routes = mesh.size, []
    for flat_rows, rows_per_shard, mask in streams:
        e = flat_rows.shape[0]
        cap = exchange_capacity(e, n, capacity_factor)
        _, local_row, slot, keep = _owner_slots(flat_rows.long(), rows_per_shard, n, cap,
                                                mask if cap < e else None)
        send = torch.zeros(n * cap + 1, dtype=torch.int32, device=flat_rows.device)
        send.index_copy_(0, slot, local_row.int())     # slot n cap: the dropped entries' bin
        routes.append((cap, slot, keep, send[:-1]))
    if not routes:
        return []
    recv = a2a_many([r[3] for r in routes], mesh)
    return [ExchangePlan(cap, slot, keep, rows) for (cap, slot, keep, _), rows in
            zip(routes, recv)]


def exchange_plan(flat_rows: torch.Tensor, rows_per_shard: int, mesh: Mesh,
                  capacity_factor=None, mask: Optional[torch.Tensor] = None) -> ExchangePlan:
    """``exchange_plans`` of one stream."""
    return exchange_plans([(flat_rows, rows_per_shard, mask)], mesh, capacity_factor)[0]


class _ExchangeLookup(torch.autograd.Function):
    """The pull, differentiable in the local rows: each owner gathers the
    rows asked of it (``index_select``, the JAX ``jnp.take``) and sends
    them back; the backward sends each entry's cotangent back to the owner
    of its row, which adds it there (the transpose of the JAX exchange
    that ``jax.grad`` takes)."""

    @staticmethod
    def forward(ctx, w_local, plan, mesh):
        ctx.plan, ctx.mesh, ctx.rows = plan, mesh, w_local.shape[0]
        back = _a2a(w_local.index_select(0, plan.recv_rows), mesh)
        out = back.index_select(0, plan.slot.clamp(max=back.shape[0] - 1))
        if plan.keep is not None:
            out = out * plan.keep[:, None].to(out.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        plan, mesh = ctx.plan, ctx.mesh
        n_cap = plan.recv_rows.shape[0]
        send = g.new_zeros((n_cap + 1, g.shape[1]))
        send.index_add_(0, plan.slot, g)
        recv = _a2a(send[:-1], mesh)
        grad = g.new_zeros((ctx.rows, g.shape[1]))
        grad.index_add_(0, plan.recv_rows, recv)
        return grad, None, None


def all_to_all_lookup(w_local: torch.Tensor, flat_rows: torch.Tensor, mesh: Mesh,
                      capacity_factor=None, mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The sharded gather (``recommendsystem_tpu/embedding/engine.py:
    144-183``): ``w_local`` (rows_per_shard, D) this rank's rows,
    ``flat_rows`` (E,) the global rows this rank needs.  Returns (E, D) in
    w's type, zeros for the entries a bounded capacity drops;
    differentiable in ``w_local``."""
    plan = exchange_plan(flat_rows, w_local.shape[0], mesh, capacity_factor, mask)
    return _ExchangeLookup.apply(w_local, plan, mesh)


def route_grads_to_owners(flat_rows: torch.Tensor, grads: torch.Tensor,
                          mask: torch.Tensor, rows_per_shard: int, mesh: Mesh,
                          capacity_factor=None):
    """The push (``recommendsystem_tpu/embedding/engine.py:185-218``): each
    (row, grad, mask) triple of this rank goes to the owner of its row.
    Returns the (n cap,) int32 local rows, (n cap, D) grads and (n cap,)
    float32 mask this rank received; unfilled slots carry row 0, grad 0
    and mask 0, and a dropped entry never arrives."""
    plan = exchange_plan(flat_rows, rows_per_shard, mesh, capacity_factor, mask)
    live = plan.live(mask.float())
    n_cap = plan.recv_rows.shape[0]
    send_mask = live.new_zeros(n_cap + 1).index_copy_(0, plan.slot, live)
    send_grads = grads.new_zeros((n_cap + 1, grads.shape[1])).index_copy_(
        0, plan.slot, grads * live[:, None].to(grads.dtype))
    return plan.recv_rows, _a2a(send_grads[:-1], mesh), _a2a(send_mask[:-1], mesh)


def check_mode(mode: str, mesh: Optional[Mesh] = None) -> None:
    """Raises ``ValueError`` for a mode other than ``"local"`` and
    ``"sharded"``, and for ``"sharded"`` without a mesh."""
    if mode not in ("local", "sharded"):
        raise ValueError(f"mode {mode!r}: expected 'local' or 'sharded'")
    if mode == "sharded" and mesh is None:
        raise ValueError("mode 'sharded' needs a mesh (core.mesh.create_mesh)")


def _combine(emb: torch.Tensor, mask: torch.Tensor, combiner: str) -> torch.Tensor:
    """(B, L, D) + (B, L) -> (B, D).  'mean' divides by the live count and
    returns zeros for empty rows (TF embedding_column semantics)."""
    m = mask.to(emb.dtype)
    summed = torch.einsum("bld,bl->bd", emb, m)
    if combiner == "sum":
        return summed
    count = m.sum(dim=1, keepdim=True)
    if combiner == "sqrtn":
        return summed / torch.sqrt(torch.clamp(count, min=1.0))
    return summed / torch.clamp(count, min=1.0)


class EmbeddingFeatures:
    """A collection of embedding columns backed by per-slot tables, grouped
    into storages: ``storage`` maps storage_key -> (total_rows, dim);
    ``table_map`` maps table_key -> (storage_key, row_offset, rows).
    ``table_dtype`` is the type w is stored in (``storage_dtype``: float32,
    bfloat16, or by width for ``"auto"``); ``packed=False`` leaves member
    offsets unaligned, so that no storage takes the fold path; the sparse
    optimizer's ``state_dtype`` (Adam) stores its moments.  ``num_shards``
    pads every storage so that its rows split evenly over that many ranks
    (and, packed, each rank's rows stay aligned to the lane packings), and
    ``a2a_capacity_factor`` is the sharded exchanges' capacity
    (``exchange_capacity``).  Storages and offsets equal the JAX engine's
    for the same arguments."""

    def __init__(self, embedding_columns: List[EmbeddingColumn],
                 sparse_opt: Optional[Union[SparseAdam, SparseAdaGrad]] = None,
                 name: str = "sparse_emb_input", num_shards: int = 1,
                 group_tables: bool = False,
                 table_dtype: Union[torch.dtype, str] = torch.float32,
                 a2a_capacity_factor="auto", packed: bool = True,
                 max_group_bytes: int = 40 << 20):
        self.name = name
        self.num_shards = num_shards
        # the sharded exchanges' capacity: None exact, a float bounded,
        # "auto" bounded at 2.0 from E >= 256 n entries on (exchange_capacity)
        self.a2a_capacity_factor = a2a_capacity_factor
        self.sparse_opt = SparseAdam() if sparse_opt is None else sparse_opt
        if table_dtype not in (torch.float32, torch.bfloat16, "auto"):
            raise ValueError(f"table_dtype {table_dtype!r}: expected torch.float32, "
                             f"torch.bfloat16 or 'auto'")
        # w's storage type; "auto": bf16 for rows of D >= 32, float32 for
        # narrower ones, where a row's bytes fit one sector either way
        self.table_dtype = table_dtype
        # packed=True aligns member offsets to the JAX engine's lane packings
        # (``stride_of``), which the fold path needs; False leaves them as
        # they come, so that every storage takes the classic path
        self.packed = packed
        # the touched-rows crossover of the packed step: where the
        # ``packed.state_packable`` storages of a step hold this many rows,
        # they take ``packed.row_update_packed_storage`` instead of the
        # accumulator and the lazy pass; off, as in the JAX engine
        self.row_update_min_rows = 1 << 62
        # per (storage, device): the rows*(D+1) [grad sums | counts] accumulator
        # of the packed update, all zero between steps (the lazy-Adam pass
        # clears the rows it reads)
        self._accumulators: Dict[Tuple[str, torch.device], torch.Tensor] = {}
        self.group_tables = group_tables
        self.max_group_bytes = max_group_bytes
        self.columns: Dict[str, EmbeddingColumn] = {}
        self.tables: Dict[str, Tuple[int, int]] = {}   # table_key -> (rows, dim)
        for col in embedding_columns:
            key = col.key
            if key in self.columns:
                raise ValueError(f"duplicate embedding column {key}")
            self.columns[key] = col
            tkey = col.categorical_column.key
            rows = pad_bucket(col.categorical_column.bucket_size, num_shards)
            if tkey in self.tables:
                prev_rows, prev_dim = self.tables[tkey]
                if prev_dim != col.dimension:
                    raise ValueError(f"table {tkey}: inconsistent dims")
                self.tables[tkey] = (max(prev_rows, rows), col.dimension)
            else:
                self.tables[tkey] = (rows, col.dimension)

        self.table_map: Dict[str, Tuple[str, int, int]] = {}
        self.storage: Dict[str, Tuple[int, int]] = {}

        def stride_of(rows: int, dim: int) -> int:
            """Member stride: rows padded to ``num_shards`` times a
            multiple of both 128-lane packings of the JAX engine, so that
            storages and offsets here equal its own (the port itself keeps
            tables (rows, D)); with ``packed=False`` the rows as they come
            (a multiple of ``num_shards``: ``pad_bucket``)."""
            if not packed or not packed_mod.packable(dim):
                return rows
            a = max(1, num_shards) * math.lcm(packed_mod.gather_pack(dim),
                                              packed_mod.scatter_pack(dim))
            return -(-rows // a) * a

        if group_tables:
            by_shape: Dict[Tuple[int, int], List[str]] = {}
            for tkey in sorted(self.tables):
                by_shape.setdefault(self.tables[tkey], []).append(tkey)
            for (rows, dim), members in sorted(by_shape.items()):
                stride = stride_of(rows, dim)
                per_chunk = len(members)
                if max_group_bytes:
                    # 4 bytes a value whatever table_dtype, as the JAX
                    # engine reckons, so that both group alike
                    bytes_per = stride * dim * 4
                    per_chunk = max(1, min(per_chunk,
                                           max_group_bytes // max(1, bytes_per)))
                chunks = [members[i:i + per_chunk]
                          for i in range(0, len(members), per_chunk)]
                for ci, chunk in enumerate(chunks):
                    if len(chunk) == 1:
                        tkey = chunk[0]
                        self.storage[tkey] = (stride, dim)
                        self.table_map[tkey] = (tkey, 0, stride)
                    else:
                        skey = f"group_{stride}x{dim}" + (
                            f"_c{ci}" if len(chunks) > 1 else "")
                        self.storage[skey] = (stride * len(chunk), dim)
                        for i, tkey in enumerate(chunk):
                            self.table_map[tkey] = (skey, i * stride, stride)
        else:
            for tkey, (rows, dim) in self.tables.items():
                stride = stride_of(rows, dim)
                self.storage[tkey] = (stride, dim)
                self.table_map[tkey] = (tkey, 0, stride)

    # ---------------- state ----------------

    def storage_dtype(self, dim: int) -> torch.dtype:
        """The type w of a storage of rows of ``dim`` is stored in."""
        if self.table_dtype == "auto":
            return torch.bfloat16 if dim >= 32 else torch.float32
        return self.table_dtype

    def init(self, generator: torch.Generator) -> Dict[str, Dict[str, torch.Tensor]]:
        """State on the generator's device, tables drawn in sorted storage
        order by ``sparse_opt.table_init`` (Adam: truncated normal on
        [-2, 2] divided by sqrt(D), the TF ``embedding_column`` default;
        AdaGrad: uniform on +-initial_scale) in float32 and stored in
        ``storage_dtype``, ``sparse_opt.init_state`` and zero show
        counts."""
        state = {}
        for skey, (rows, dim) in sorted(self.storage.items()):
            state[skey] = {
                "w": self.sparse_opt.table_init(generator, (rows, dim),
                                                dtype=self.storage_dtype(dim)),
                "opt": self.sparse_opt.init_state((rows, dim),
                                                  generator.device),
                "show": torch.zeros((rows, 1), dtype=torch.float32,
                                    device=generator.device)}
        return state

    def evict(self, state, min_show: float,
              generator: Optional[torch.Generator] = None):
        """Rows seen fewer than ``min_show`` times start afresh: a new
        ``sparse_opt.table_init`` draw from ``generator`` (one whole-table
        draw a storage, in sorted storage order, as ``init`` draws, in w's
        type), the optimizer's ``init_state`` (in each field's type) and a
        zero show count, so that a row
        touched again is one created on first touch.  The other rows stay
        bit-identical.  ``min_show < 0`` does nothing.  Updates ``state``'s
        tensors in place, as the train step does, and returns ``state``;
        ``generator`` (default: a CPU generator seeded 0) must be on the
        state's device."""
        if min_show < 0:
            return state
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for skey in sorted(state):
            tstate = state[skey]
            w = tstate["w"]
            keep = tstate["show"] >= min_show                        # (rows, 1)
            fresh = self.sparse_opt.table_init(generator, tuple(w.shape), dtype=w.dtype)
            w.copy_(torch.where(keep, w, fresh))
            init = self.sparse_opt.init_state(tuple(w.shape), w.device)
            for name, cur in tstate["opt"].items():
                cur.copy_(torch.where(keep, cur, init[name].to(cur.dtype)))
            tstate["show"].masked_fill_(~keep, 0.0)
        return state

    def maybe_evict(self, state, generator: Optional[torch.Generator] = None):
        """The in-training admission hook: ``evict`` at the optimizer's own
        ``feature_drop_show``; nothing for an optimizer without one or at
        -1."""
        return self.evict(state, getattr(self.sparse_opt, "feature_drop_show", -1.0),
                          generator)

    def weights(self, state) -> Dict[str, torch.Tensor]:
        """(rows, D) weights per storage, in their storage type."""
        return {skey: t["w"] for skey, t in state.items()}

    def raw_weights(self, state) -> Dict[str, torch.Tensor]:
        """The weights as stored: ``weights``, since the port keeps every
        storage in the classic (rows, D) layout."""
        return self.weights(state)

    def classic_state(self, state):
        """The classic per-row view of the state, which is the layout the
        port keeps: the identity, so that tests read the state of both
        packages through one name."""
        return state

    def accumulator(self, skey: str, device, rows: Optional[int] = None) -> torch.Tensor:
        """The zeroed float32 accumulator of one storage on ``device``:
        rows*(D+1) floats, a (rows, D) block of gradient sums followed by a
        (rows,) block of counts (``packed.accumulator_views``), allocated on
        first use and reused: the unfold-scatter kernels fill it and the
        lazy-Adam pass clears it.  ``rows``: the storage's (None) or a
        rank's shard of it."""
        rows = self.storage[skey][0] if rows is None else rows
        key = (skey, torch.device(device), rows)
        acc = self._accumulators.get(key)
        if acc is None:
            acc = torch.zeros(rows * (self.storage[skey][1] + 1), dtype=torch.float32,
                              device=device)
            self._accumulators[key] = acc
        return acc

    def shardings(self, mesh: Mesh):
        """The placement of every leaf of the table state: rows over the
        data axis (``core.mesh.row_sharding``), w, the optimizer's state and
        show alike."""
        row = row_sharding(mesh)
        return {skey: {"w": row, "opt": {name: row for name in
                                         self.sparse_opt.init_state((1, 1), "cpu")},
                       "show": row}
                for skey in self.storage}

    def rows_per_shard(self, skey: str, mesh: Mesh) -> int:
        """The rows of storage ``skey`` that each rank holds."""
        rows = self.storage[skey][0]
        if rows % mesh.size:
            raise ValueError(f"storage {skey}: {rows} rows do not split over {mesh.size} "
                             f"ranks; build the engine with num_shards={mesh.size}")
        return rows // mesh.size

    # ---------------- classic lookup (the port's oracle) ----------------

    def lookup(self, weights: Dict[str, torch.Tensor], batch: Dict[str, IdBatch],
               mode: str = "local", mesh: Optional[Mesh] = None):
        """``weights``: {storage_key: (rows, D)}; ``batch``: {column_key:
        IdBatch}.  Mean columns -> (B, D); sequence columns -> ((B, T, D),
        (B, T) bool mask).  ``mode="sharded"`` takes this rank's rows of
        each storage and of the batch and pulls each row from its owner
        over ``mesh`` (one exchange per storage); differentiable in the
        weights in both modes."""
        return self.combine_raw(self.gather_raw(weights, batch, mode, mesh), batch)

    def lookup_sharded(self, weights: Dict[str, torch.Tensor],
                       batch: Dict[str, IdBatch], mesh: Mesh):
        """``lookup`` in sharded mode: this rank's row shards, its rows of
        the batch, its rows of the outputs."""
        return self.lookup(weights, batch, "sharded", mesh)

    def _per_storage_columns(self, batch) -> Dict[str, List[str]]:
        per_storage: Dict[str, List[str]] = {}
        for key, col in self.columns.items():
            if key in batch:
                skey, _, _ = self.table_map[col.categorical_column.key]
                per_storage.setdefault(skey, []).append(key)
        return per_storage

    def _storage_flat_rows(self, skey: str, keys: List[str], batch):
        """Offset-applied flat row ids of every member column of one
        storage, in member order."""
        flat_ids = []
        for key in keys:
            _, offset, _ = self.table_map[
                self.columns[key].categorical_column.key]
            rows = batch[key].rows
            flat_ids.append((rows + offset if offset else rows).reshape(-1))
        return flat_ids

    def _storage_members(self, skey: str):
        """Member tables of one storage, ordered by row offset."""
        return sorted((off, tkey, rows)
                      for tkey, (sk, off, rows) in self.table_map.items()
                      if sk == skey)

    def gather_raw(self, weights: Dict[str, torch.Tensor],
                   batch: Dict[str, IdBatch], mode: str = "local",
                   mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
        """One gather per storage: concat every member column's flat ids,
        index once (sharded: ``all_to_all_lookup`` from this rank's row
        shard, the padding entries taking no bounded capacity), split back
        to (B, L, D) float32."""
        check_mode(mode, mesh)
        raw = {}
        for skey, keys in self._per_storage_columns(batch).items():
            flat_ids = self._storage_flat_rows(skey, keys, batch)
            if mode == "sharded":
                gathered = all_to_all_lookup(
                    weights[skey], torch.cat(flat_ids), mesh, self.a2a_capacity_factor,
                    mask=torch.cat([batch[k].mask.reshape(-1) for k in keys])).float()
            else:
                gathered = weights[skey][torch.cat(flat_ids).long()].float()
            start = 0
            for key, ids in zip(keys, flat_ids):
                n = ids.shape[0]
                b, l = batch[key].rows.shape
                raw[key] = gathered[start:start + n].reshape(b, l, -1)
                start += n
        return raw

    def gather_raw_sharded(self, weights: Dict[str, torch.Tensor],
                           batch: Dict[str, IdBatch], mesh: Mesh) -> Dict[str, torch.Tensor]:
        """``gather_raw`` in sharded mode."""
        return self.gather_raw(weights, batch, "sharded", mesh)

    def a2a_drop_report(self, batch: Dict[str, IdBatch], mesh: Mesh) -> Dict[str, Dict[str, int]]:
        """The real (mask > 0) entries that this step's bounded exchanges
        drop, summed over the ranks: {storage: {"rows": count}}, for this
        rank's rows of the batch, in the classic exchange's order (every
        member column's ids in turn), as the JAX report counts its "rows".
        0 where the capacity is exact.  (The JAX report also counts its
        128-lane physical-row exchanges, "phys_gather" and "phys_push",
        which the port does not carry.)  A collective: every rank calls it;
        one host sync."""
        keys_of = self._per_storage_columns(batch)
        counts = []
        device = next(iter(batch.values())).rows.device
        for skey, keys in keys_of.items():
            ids = torch.cat(self._storage_flat_rows(skey, keys, batch)).long()
            mask = torch.cat([batch[k].mask.reshape(-1) for k in keys])
            cap = exchange_capacity(ids.shape[0], mesh.size, self.a2a_capacity_factor)
            _, _, _, in_cap = _owner_slots(ids, self.rows_per_shard(skey, mesh), mesh.size,
                                           cap, mask)
            counts.append(((mask > 0) & ~in_cap).sum())
        total = (torch.stack(counts) if counts
                 else torch.zeros(0, dtype=torch.int64, device=device))
        dist.all_reduce(total, group=mesh.group)
        return {skey: {"rows": int(c)} for skey, c in zip(keys_of, total.tolist())}

    def combine_raw(self, raw: Dict[str, torch.Tensor],
                    batch: Dict[str, IdBatch]):
        out = {}
        for key, col in self.columns.items():
            if key not in raw:
                continue
            ids = batch[key]
            if col.is_sequence:
                emb = raw[key] * ids.mask.to(raw[key].dtype)[..., None]
                out[key] = (emb, ids.mask.bool())
            else:
                out[key] = _combine(raw[key], ids.mask, col.combiner)
        return out

    # ---------------- classic update (the port's oracle) ----------------

    def flatten_raw_grads(self, raw_grads: Dict[str, torch.Tensor],
                          batch: Dict[str, IdBatch]):
        """Group per-column (B, L, D) grads by table -> (table-local rows,
        grads, mask) flat tensors."""
        per_table: Dict[str, list] = {}
        for key, g in raw_grads.items():
            ids = batch[key]
            tkey = self.columns[key].categorical_column.key
            per_table.setdefault(tkey, []).append(
                (ids.rows.reshape(-1), g.reshape(-1, g.shape[-1]),
                 ids.mask.reshape(-1).float()))
        return {tkey: tuple(torch.cat([p[i] for p in parts]) for i in range(3))
                for tkey, parts in per_table.items()}

    @staticmethod
    def _dense_grad_and_count(rows, grads, mask, num_rows: int):
        """One scatter-add builds the dense [G | count] accumulator of one
        table: padding slots carry zero grads and a zero count."""
        payload = torch.cat([grads.float(), mask[:, None]], dim=1)
        acc = torch.zeros((num_rows, payload.shape[1]), dtype=torch.float32,
                          device=payload.device)
        acc.index_add_(0, rows.long(), payload)
        return acc[:, :-1], acc[:, -1:]

    def apply_gradients_scatter(self, state, flat):
        """Classic sparse update: per-table scatter-adds build a dense
        [grad | count] accumulator, then ``sparse_opt.update`` runs lazily
        over each touched storage, in float32 from the stored w, which comes
        back in its own type.  Returns a new state; ``state`` is not
        modified (the untouched storages' entries are its own)."""
        new_state = {}
        for skey, tstate in state.items():
            members = self._storage_members(skey)
            if not any(tkey in flat for _, tkey, _ in members):
                new_state[skey] = tstate
                continue
            dim = tstate["w"].shape[1]
            g_parts, c_parts = [], []
            for _, tkey, rows_t in members:
                if tkey in flat:
                    g_t, c_t = self._dense_grad_and_count(*flat[tkey], rows_t)
                else:
                    g_t = tstate["w"].new_zeros((rows_t, dim), dtype=torch.float32)
                    c_t = tstate["w"].new_zeros((rows_t, 1), dtype=torch.float32)
                g_parts.append(g_t)
                c_parts.append(c_t)
            grad, cnt = torch.cat(g_parts), torch.cat(c_parts)
            w, opt = self.sparse_opt.update(tstate["w"].float(), grad, tstate["opt"],
                                            (cnt > 0).float())
            new_state[skey] = {"w": w.to(tstate["w"].dtype), "opt": opt,
                               "show": tstate["show"] + cnt}
        return new_state

    def apply_gradients_scatter_sharded(self, state, raw_grads: Dict[str, torch.Tensor],
                                        batch: Dict[str, IdBatch], mesh: Mesh):
        """The push on the mesh (``recommendsystem_tpu/embedding/engine.py:
        672-718``): this rank's (B, L, D) activation gradients, flattened per
        storage, go to the owners of their rows (``route_grads_to_owners``,
        one exchange per storage), and each rank's ``sparse_opt.update``
        runs lazily over its own rows.  ``state``: this rank's shards.
        Returns (a new state, {storage: the local rows the update wrote,
        those a real entry reached (int64, sorted)}); ``state`` is not
        modified.  The columns are taken in sorted order, as the JAX
        package's gradient dict holds them, so that a bounded exchange
        drops the same entries."""
        flat = self.flatten_raw_grads({k: raw_grads[k] for k in sorted(raw_grads)}, batch)
        new_state, written = {}, {}
        for skey, tstate in state.items():
            parts = [(flat[tkey][0] + off if off else flat[tkey][0], flat[tkey][1],
                      flat[tkey][2])
                     for off, tkey, _ in self._storage_members(skey) if tkey in flat]
            if not parts:
                new_state[skey] = tstate
                continue
            local = tstate["w"].shape[0]
            rows, grads, mask = route_grads_to_owners(
                torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]),
                torch.cat([p[2] for p in parts]), local, mesh, self.a2a_capacity_factor)
            grad, cnt = self._dense_grad_and_count(rows, grads, mask, local)
            written[skey] = (cnt.view(-1) > 0).nonzero().view(-1)
            w, opt = self.sparse_opt.update(tstate["w"].float(), grad, tstate["opt"],
                                            (cnt > 0).float())
            new_state[skey] = {"w": w.to(tstate["w"].dtype), "opt": opt,
                               "show": tstate["show"] + cnt}
        return new_state, written

    def row_counts_sharded(self, batch: Dict[str, IdBatch], mesh: Mesh):
        """``row_counts`` of the whole batch, this rank's rows of each
        storage: every rank counts its rows of the batch over the whole
        storage, and the counts are summed over the ranks (one all-reduce
        a storage: the dense update's O(table) traffic)."""
        counts = self.row_counts(batch)
        out = {}
        for skey, c in counts.items():
            dist.all_reduce(c, group=mesh.group)
            out[skey] = c[mesh.rows(c.shape[0])]
        return out

    def row_counts(self, batch: Dict[str, IdBatch]) -> Dict[str, torch.Tensor]:
        """Per-storage appearance counts (rows, 1): the 'show' statistic
        that drives lazy updates."""
        device = next(iter(batch.values())).rows.device
        counts = {skey: torch.zeros((rows,), dtype=torch.float32, device=device)
                  for skey, (rows, _) in self.storage.items()}
        for key, col in self.columns.items():
            if key not in batch:
                continue
            skey, offset, _ = self.table_map[col.categorical_column.key]
            ids = batch[key]
            rows = ids.rows + offset if offset else ids.rows
            counts[skey].index_add_(0, rows.reshape(-1).long(),
                                    ids.mask.reshape(-1).float())
        return {k: v[:, None] for k, v in counts.items()}

    def apply_gradients(self, state, grads: Dict[str, torch.Tensor],
                        counts: Dict[str, torch.Tensor]):
        """The dense update path: ``grads`` {storage: (rows, D)} are the
        gradients of the loss with respect to the stored weights (in w's
        type: a bf16 table's gradient arrives in bf16, as the JAX package's
        does through its cast), ``counts`` ``row_counts(batch)``.  Each
        storage with a gradient takes ``sparse_opt.update`` over the whole
        table, rows with a count > 0 stepping, in float32 from the stored w,
        which comes back in its own type; show adds the counts.  Returns a
        new state; ``state`` is not modified."""
        new_state = {}
        for skey, tstate in state.items():
            g = grads.get(skey)
            if g is None:
                new_state[skey] = tstate
                continue
            w, opt = self.sparse_opt.update(tstate["w"].float(), g, tstate["opt"],
                                            (counts[skey] > 0).float())
            new_state[skey] = {"w": w.to(tstate["w"].dtype), "opt": opt,
                               "show": tstate["show"] + counts[skey]}
        return new_state
